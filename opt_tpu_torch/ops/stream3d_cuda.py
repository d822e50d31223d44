"""The "stream3d" engine: volumetric ARAP's inner PCG solve in the
Jacobi-scaled ("hat") space on hand-written CUDA kernels (port of
opt_tpu/ops/stream3d.py StreamSolver3D).

The JAX package runs a volume of 64^3 voxels or more through two streamed
Pallas kernels behind solver/core's pcg_backend seam, with the outer step
(here K8, ops/vol_cuda.py) around them.  The hat space is the 2-D
streamed engine's, A_hat = S (J^T J [+ CtC]) S with S = diag(sq)
(stream3d.py:51-54), and so are the two PCG loops, which this engine takes
from ops/stream_cuda.py:

  classic    (row 7, StreamSolver3D._build_classic_kernel) per iteration
             K6 vol_hat_apply   p = r + beta p_prev, A_hat p, <p, A_hat p>
             K2 pcg_update      hat mode (ops/pcg_update.py)
             and in LM one more K6 on delta every residual_reset_period
             iterations for the exact reset, and the Q/zeta exit;
  pipelined  (row 6, StreamSolver3D._build_pipelined_kernel) one K6 for
             w_0, then one
             K7 vol_pipelined_sweep  n = A_hat w, the five recurrences,
                                     <r, r>, <w, r> and LM's q
             per iteration; in LM the zeta exit and, every
             residual_reset_period iterations, r = b_hat - A_hat delta and
             w = A_hat r, one K6 each.

Both run GN and LM.  stream_cuda.pick_variant gives volumes, like grids,
the classic loop, unless variant= names pipelined.  The JAX package's
StreamSolver3D takes pipelined wherever its state fits
(stream3d.py:95-103), a TPU choice: one barrier an iteration.  On an H100
at 128^3, 8 x 100, classic took 282-287 ms a GN solve against
pipelined's 398-411, 375-393 ms against 498-504 in LM, and 605-653
against 857-877 in GN over a mesh of 4 slabs, and ended nearer the
float64 classic reference in x (GN 1.1e-4 against 2.9e-3, LM 1.6e-4
against 2.6e-4; PERF.md).  An iteration's K6 and K2 move 612 MB in about
273 us, where K7 moves 713 MB in 421.  Not ported: the TPU's (8, 128)
padding and its real-domain mask, the VMEM and HBM budget models and the
tile search, the strip-mined outer (ops/stream_outer.py).  The kernels
work on the unpadded extents: K6 on csrc/vol_tile.cuh's shared-memory
tile core, K7 reading its one-voxel halo in place.  The kernel wrappers
run their plain torch versions (vol_hat_apply_plain,
vol_pipelined_sweep_plain) for CPU tensors, so on a CPU plan
engine="stream3d" runs both backends on the plain versions.
"""

from __future__ import annotations

import math

import torch

from ..runtime.trace import LAUNCHES, kernel
from . import build
from .stream_cuda import (check_two_buffers, hat_pcg, pick_variant,
                          sweep_partials, sweep_sums, sweep_update_plain)
from .vol_cuda import VolOperator, shapes, vol_jtj_apply_plain

# engine="auto" routes volumetric ARAP here from this many voxels: the JAX
# package's crossover (opt_tpu/ops/stream3d.py:95-103), measured on a TPU
# v5e against fused XLA.  It stays until this card's own sweep places it
# (ROADMAP.md).
AUTO_STREAM3D_MIN_VOXELS = 64 ** 3


def prefers_stream3d(plan):
    """True when engine="auto" sends this volume to "stream3d"."""
    return math.prod(plan.dims) >= AUTO_STREAM3D_MIN_VOXELS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def vol_hat_apply_plain(x, ur, cons, params, sq, scs, r, p_prev=None,
                        beta=None):
    """(p, A_hat p, <p, A_hat p>) for p = r + beta p_prev (p = r when
    p_prev is None), A_hat p = sq J^T J (sq p) + scs p."""
    p = r if p_prev is None else r + beta * p_prev
    jtj, _ = vol_jtj_apply_plain(x, sq * p, ur, cons, params)
    ap = sq * jtj
    if scs is not None:
        ap = ap + scs * p
    return p, ap, torch.dot(p, ap)


def vol_pipelined_sweep_plain(x, ur, cons, params, sq, scs, w_in, w_out, z,
                              s, p, delta, r, alpha, beta, b_hat=None):
    """One pipelined PCG sweep, in place: n = A_hat w_in, then the
    recurrences of stream_cuda.sweep_update_plain.  Returns (<r, r>,
    <w_out, r>, q), q = 0.5 <delta, r + b_hat> given b_hat (LM)."""
    _, n, _ = vol_hat_apply_plain(x, ur, cons, params, sq, scs, w_in)
    return sweep_update_plain(n, w_in, w_out, z, s, p, delta, r, alpha, beta,
                              b_hat)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@kernel("K6.vol_hat_apply")
def vol_hat_apply(x, ur, cons, params, sq, scs, r, p_prev=None, beta=None):
    """K6: (p, A_hat p, <p, A_hat p>) -- kernel on CUDA, plain on CPU.
    beta is a 0-d device tensor, given with p_prev; p is a new buffer
    (r itself when p_prev is None)."""
    if build.all_on_cpu(x, ur, cons, params, sq, scs, r, p_prev, beta):
        return vol_hat_apply_plain(x, ur, cons, params, sq, scs, r, p_prev,
                                   beta)
    if (p_prev is None) != (beta is None):
        raise ValueError("vol_hat_apply: p_prev and beta come together")
    D, H, W = ur.shape[:3]
    n = 6 * D * H * W
    build.check_tensors(
        "vol_hat_apply",
        {**shapes(D, H, W), "sq": (n,), "scs": (n,), "r": (n,),
         "p_prev": (n,), "beta": ()},
        **build.present(x=x, ur=ur, cons=cons, params=params, sq=sq,
                        scs=scs, r=r, p_prev=p_prev, beta=beta))
    lib = build.library()
    p = torch.empty_like(r) if p_prev is not None else r
    ap = torch.empty_like(r)
    parts = torch.empty(lib.opt_vol_hat_blocks(D, H, W), dtype=r.dtype,
                        device=r.device)
    rc = lib.opt_vol_hat_apply(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(params),
        build.ptr(sq), build.ptr(scs), build.ptr(r), build.ptr(p_prev),
        build.ptr(beta), build.ptr(p) if p_prev is not None else None,
        build.ptr(ap), build.ptr(parts), D, H, W, build.stream())
    build.check(rc, "vol_hat_apply")
    LAUNCHES["K6.vol_hat_apply"] += 1
    return p, ap, torch.sum(parts)


@kernel("K7.vol_pipelined_sweep")
def vol_pipelined_sweep(x, ur, cons, params, sq, scs, w_in, w_out, z, s, p,
                        delta, r, alpha, beta, b_hat=None):
    """K7: one pipelined PCG sweep, updating z, s, p, delta, r in place
    and writing w_out -- kernel on CUDA, plain on CPU.  alpha and beta are
    0-d device tensors; b_hat (LM) adds q = 0.5 <delta, r + b_hat>.
    Returns (<r, r>, <w_out, r>, q) of the new values, q None for GN."""
    if build.all_on_cpu(x, ur, cons, params, sq, scs, w_in, w_out, z, s, p,
                        delta, r, alpha, beta, b_hat):
        return vol_pipelined_sweep_plain(x, ur, cons, params, sq, scs, w_in,
                                         w_out, z, s, p, delta, r, alpha,
                                         beta, b_hat)
    D, H, W = ur.shape[:3]
    n = 6 * D * H * W
    vecs = dict(sq=sq, scs=scs, b_hat=b_hat, w_in=w_in, w_out=w_out, z=z,
                s=s, p=p, delta=delta, r=r)
    build.check_tensors(
        "vol_pipelined_sweep",
        {**shapes(D, H, W), **{k: (n,) for k in vecs}, "alpha": (),
         "beta": ()},
        **build.present(x=x, ur=ur, cons=cons, params=params,
                        alpha=alpha, beta=beta, **vecs))
    check_two_buffers("vol_pipelined_sweep", w_in, w_out)
    lib = build.library()
    g_parts, d_parts, q_parts = sweep_partials(lib.opt_vol_blocks(D, H, W),
                                               r, b_hat)
    rc = lib.opt_vol_pipelined_sweep(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(params),
        build.ptr(sq), build.ptr(scs), build.ptr(b_hat), build.ptr(w_in),
        build.ptr(w_out), build.ptr(z), build.ptr(s), build.ptr(p),
        build.ptr(delta), build.ptr(r), build.ptr(alpha), build.ptr(beta),
        build.ptr(g_parts), build.ptr(d_parts), build.ptr(q_parts), D, H, W,
        build.stream())
    build.check(rc, "vol_pipelined_sweep")
    LAUNCHES["K7.vol_pipelined_sweep"] += 1
    return sweep_sums(g_parts, d_parts, q_parts)




# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class Stream3DOperator(VolOperator):
    """VolOperator (cost, outer, model_cost on K8) whose inner PCG solve is
    one of the two hat-space backends, given to the solver as
    pcg_backend."""

    def __init__(self, data, uses_lambda, variant=None):
        super().__init__(data)
        self.uses_lambda = uses_lambda
        self.variant = pick_variant(variant)

    def pcg_backend(self, sq, scs, b_hat, sp):
        lm = self.uses_lambda
        consts = (self._x, self.ur, self.cons, self.params, sq, scs)

        def hat_apply(r, p_prev=None, beta=None):
            return vol_hat_apply(*consts, r, p_prev, beta)

        def sweep(*state):
            return vol_pipelined_sweep(*consts, *state,
                                       b_hat=b_hat if lm else None)

        return hat_pcg(self.variant, hat_apply, sweep, b_hat, sp, lm)
