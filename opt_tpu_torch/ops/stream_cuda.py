"""The streamed engine for large image_warping grids: the inner PCG solve
in the Jacobi-scaled ("hat") space on hand-written CUDA kernels (port of
opt_tpu/ops/stream_solver.py StreamSolverHBM).

Past the sizes where the whole grid's solve stays on chip, the JAX package
runs the inner PCG of each outer step as one of two streamed Pallas
kernels behind solver/core's pcg_backend seam; the outer step (J^T F,
diag, cost, LM's trust region) stays in the solver.  The two hat-space
loops are solver/hat_pcg.py's, here on these kernels:

  classic    (row 4, StreamSolverHBM._build_backend_kernel) per iteration
             K4 warp_hat_apply  p = r + beta p_prev, A_hat p, <p, A_hat p>
             K2 pcg_update      hat mode: delta += alpha p, r -= alpha Ap,
                                <r, r>, LM's q = 0.5 <delta, r + b_hat>
             and, in LM, every residual_reset_period iterations one more
             K4 on delta for the exact reset r = b_hat - A_hat delta;
  pipelined  (row 5, StreamSolverHBM._build_pipelined_kernel) one K4 for
             w_0 = A_hat r_0, then per iteration one
             K5 warp_pipelined_sweep  n = A_hat w and the recurrences,
             with the next <r, r> and <w, r> (and LM's q); in LM, every
             residual_reset_period iterations, r = b_hat - A_hat delta and
             w = A_hat r, one K4 each.

The resident-state solver (row 3, StreamSolver._build_kernel) is the
third hat-space backend: one launch per outer step of

  K13 resident_pcg  lIterations of p = r + beta p_prev, A_hat p, the dots
                    and the updates across two grid syncs an iteration, for
                    image_warping and poisson_image_editing.  Two forms of
                    image_warping's, picked by the grid's shape alone
                    (onchip_tiles): where the grid's 32 x 64 tiles number no
                    more than the card's SMs and a tile's state fits a
                    block's shared memory, the on-chip form (one block a
                    tile and an SM, every vector on chip for the whole
                    launch, only the tiles' edges through L2:
                    csrc/resident_onchip.cuh); elsewhere, and for poisson,
                    every vector in device memory (L2 at 512^2:
                    csrc/resident_kernels.cu on csrc/resident_pcg.cuh)

It is the "cuda" engine's GN PCG (warp_resident_backend, given to
WarpOperator by runtime/api.py for GN with the classic pcg_variant), and
StreamSolver's, whose outer step runs on WarpOperator's K3 or on the plan's
evaluator.

GN and LM both run the classic loop unless variant= picks the pipelined
one (stream_solver.py:725-760 gives GN pipelined), here and on volumes
(ops/stream3d_cuda.py).  On image_warping's hat
system the float32 pipelined recurrences drift from the residual they
stand for: at 2048^2, 8 x 400 on an NVIDIA H100 GN's final cost parted
from the float64 reference's by 28 to 4.6e6 times its value, where the
classic loop stayed within 1e-7 of it and ran 5.5% faster (PERF.md).
Every vector is the solver's flat unknown layout (Offset (H, W, 2) then Angle (H, W, 1)); the kernels
read their one-pixel halo in place, so nothing is padded.  The kernel
wrappers run their plain torch versions (warp_hat_apply_plain,
warp_pipelined_sweep_plain) for CPU tensors, so on a CPU plan
engine="stream" runs both backends on the plain versions.
"""

from __future__ import annotations

import math

import torch

from .. import energies
from ..compile import plan_fns
from ..solver.core import SolverConfig, make_solver
from ..solver.hat_pcg import classic_pcg, hat_pcg
from ..runtime.trace import LAUNCHES, kernel
from . import build
from .pcg_update import pcg_update, pcg_update_plain
from .poisson_cuda import is_poisson, poisson_jtj_plain
from .warp_cuda import (WarpOperator, _flat_keep, _shapes,
                        warp_jtj_apply_plain)

# engine="auto" routes image_warping to this engine at these sizes.  They
# are the JAX package's crossovers (opt_tpu/ops/stream_solver.py:234-235),
# measured on a TPU v5e: GN from 2048^2 pixels; LM from 512^2, where the
# JAX package's whole-solve kernel still holds the grid (its VMEM budget
# model, not ported, admits LM grids up to about 393,216 padded pixels),
# so LM takes this engine only above 512^2.  They stay until this card's
# own comparison of the two engines replaces them (ROADMAP.md).
AUTO_STREAM_MIN_PIXELS = 2048 * 2048
AUTO_STREAM_MIN_PIXELS_LM = 512 * 512

VARIANTS = ("pipelined", "classic")


def prefers_stream(plan):
    """True when engine="auto" sends this image_warping plan to "stream"
    rather than the whole-grid "cuda" engine."""
    pixels = math.prod(plan.dims)
    if plan.config.uses_lambda:
        return pixels > AUTO_STREAM_MIN_PIXELS_LM
    return pixels >= AUTO_STREAM_MIN_PIXELS


def pick_variant(variant=None):
    """The backend a grid or a volume runs, on one card or over a mesh:
    classic for GN and LM, unless variant names one."""
    return "classic" if variant is None else check_variant(variant)


def check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}: {variant!r}")
    return variant


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def warp_hat_apply_plain(x, ur, cons, mask, params, sq, scs, r, p_prev=None,
                         beta=None):
    """(p, A_hat p, <p, A_hat p>) for p = r + beta p_prev (p = r when
    p_prev is None), A_hat p = sq J^T J (sq p) + scs p at the kept pixels
    and 0 at the excluded ones."""
    p = r if p_prev is None else r + beta * p_prev
    jtj, _ = warp_jtj_apply_plain(x, sq * p, ur, cons, mask, params)
    ap = sq * jtj
    if scs is not None:
        ap = ap + scs * p
    H, W = mask.shape[:2]
    ap = torch.where(_flat_keep(mask.view(H, W) == 0), ap,
                     torch.zeros((), dtype=ap.dtype, device=ap.device))
    return p, ap, torch.dot(p, ap)


def sweep_update_plain(n, w_in, w_out, z, s, p, delta, r, alpha, beta,
                       b_hat=None, dot=torch.dot):
    """The pipelined sweep's recurrences, in place, given n = A_hat w_in:
    z = n + beta z, s = w + beta s, p = r + beta p, delta += alpha p,
    r -= alpha s, w_out = w - alpha z.  Returns (<r, r>, <w_out, r>, q),
    q = 0.5 <delta, r + b_hat> given b_hat (LM), else None.  dot takes the
    sums (a sharded operator's sums over the mesh)."""
    z.mul_(beta).add_(n)
    s.mul_(beta).add_(w_in)
    p.mul_(beta).add_(r)
    delta.add_(alpha * p)
    r.sub_(alpha * s)
    torch.sub(w_in, alpha * z, out=w_out)
    q = None if b_hat is None else 0.5 * dot(delta, r + b_hat)
    return dot(r, r), dot(w_out, r), q


def warp_pipelined_sweep_plain(x, ur, cons, mask, params, sq, scs, w_in,
                               w_out, z, s, p, delta, r, alpha, beta,
                               b_hat=None):
    """One pipelined PCG sweep, in place (sweep_update_plain on
    n = A_hat w_in).  Returns (<r, r>, <w_out, r>, q)."""
    _, n, _ = warp_hat_apply_plain(x, ur, cons, mask, params, sq, scs, w_in)
    return sweep_update_plain(n, w_in, w_out, z, s, p, delta, r, alpha, beta,
                              b_hat)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@kernel("K4.warp_hat_apply")
def warp_hat_apply(x, ur, cons, mask, params, sq, scs, r, p_prev=None,
                   beta=None):
    """K4: (p, A_hat p, <p, A_hat p>) -- kernel on CUDA, plain on CPU.
    beta is a 0-d device tensor, given with p_prev; p is a new buffer
    (r itself when p_prev is None)."""
    if build.all_on_cpu(x, ur, cons, mask, params, sq, scs, r, p_prev, beta):
        return warp_hat_apply_plain(x, ur, cons, mask, params, sq, scs, r,
                                    p_prev, beta)
    if (p_prev is None) != (beta is None):
        raise ValueError("warp_hat_apply: p_prev and beta come together")
    H, W = mask.shape[:2]
    n = 3 * H * W
    build.check_tensors(
        "warp_hat_apply",
        {**_shapes(H, W), "sq": (n,), "scs": (n,), "r": (n,),
         "p_prev": (n,), "beta": ()},
        **build.present(x=x, ur=ur, cons=cons, mask=mask, params=params,
                        sq=sq, scs=scs, r=r, p_prev=p_prev, beta=beta))
    lib = build.library()
    p = torch.empty_like(r) if p_prev is not None else r
    ap = torch.empty_like(r)
    parts = torch.empty(build.coop_blocks(lib.opt_warp_hat_apply_blocks(H, W),
                                          "warp_hat_apply"),
                        dtype=r.dtype, device=r.device)
    rc = lib.opt_warp_hat_apply(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(mask),
        build.ptr(params), build.ptr(sq), build.ptr(scs), build.ptr(r),
        build.ptr(p_prev), build.ptr(beta),
        build.ptr(p) if p_prev is not None else None, build.ptr(ap),
        build.ptr(parts), H, W, build.stream())
    build.check(rc, "warp_hat_apply")
    LAUNCHES["K4.warp_hat_apply"] += 1
    return p, ap, torch.sum(parts)


@kernel("K5.warp_pipelined_sweep")
def warp_pipelined_sweep(x, ur, cons, mask, params, sq, scs, w_in, w_out, z,
                         s, p, delta, r, alpha, beta, b_hat=None):
    """K5: one pipelined PCG sweep, updating z, s, p, delta, r in place
    and writing w_out -- kernel on CUDA, plain on CPU.  alpha and beta are
    0-d device tensors; b_hat (LM) adds q = 0.5 <delta, r + b_hat>.
    Returns (<r, r>, <w_out, r>, q) of the new values, q None for GN."""
    if build.all_on_cpu(x, ur, cons, mask, params, sq, scs, w_in, w_out, z,
                        s, p, delta, r, alpha, beta, b_hat):
        return warp_pipelined_sweep_plain(x, ur, cons, mask, params, sq, scs,
                                          w_in, w_out, z, s, p, delta, r,
                                          alpha, beta, b_hat)
    H, W = mask.shape[:2]
    n = 3 * H * W
    vecs = dict(sq=sq, scs=scs, b_hat=b_hat, w_in=w_in, w_out=w_out, z=z,
                s=s, p=p, delta=delta, r=r)
    build.check_tensors(
        "warp_pipelined_sweep",
        {**_shapes(H, W), **{k: (n,) for k in vecs}, "alpha": (),
         "beta": ()},
        **build.present(x=x, ur=ur, cons=cons, mask=mask, params=params,
                        alpha=alpha, beta=beta, **vecs))
    check_two_buffers("warp_pipelined_sweep", w_in, w_out)
    lib = build.library()
    g_parts, d_parts, q_parts = sweep_partials(lib.opt_warp_blocks(H, W), r,
                                               b_hat)
    rc = lib.opt_warp_pipelined_sweep(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(mask),
        build.ptr(params), build.ptr(sq), build.ptr(scs), build.ptr(b_hat),
        build.ptr(w_in), build.ptr(w_out), build.ptr(z), build.ptr(s),
        build.ptr(p), build.ptr(delta), build.ptr(r), build.ptr(alpha),
        build.ptr(beta), build.ptr(g_parts), build.ptr(d_parts),
        build.ptr(q_parts), H, W, build.stream())
    build.check(rc, "warp_pipelined_sweep")
    LAUNCHES["K5.warp_pipelined_sweep"] += 1
    return sweep_sums(g_parts, d_parts, q_parts)


def check_two_buffers(name, w_in, w_out):
    if w_in.data_ptr() == w_out.data_ptr():
        raise ValueError(f"{name}: w_in and w_out must be two buffers "
                         "(neighbouring blocks read w_in's halo)")


def sweep_partials(blocks, r, b_hat):
    """The per-block partials a pipelined sweep writes: gamma, dd and (LM
    only, else None) q."""
    new = lambda: torch.empty(blocks, dtype=r.dtype, device=r.device)
    return new(), new(), (new() if b_hat is not None else None)


def sweep_sums(g_parts, d_parts, q_parts):
    return (torch.sum(g_parts), torch.sum(d_parts),
            None if q_parts is None else torch.sum(q_parts))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class StreamOperator(WarpOperator):
    """WarpOperator (cost, outer, mask, model_cost on K1/K3) whose inner
    PCG solve is one of the two hat-space loops (solver/hat_pcg.py) on K4
    with K2 or on K5, given to the solver as pcg_backend."""

    def __init__(self, data, uses_lambda, variant=None):
        super().__init__(data)
        self.uses_lambda = uses_lambda
        self.variant = pick_variant(variant)

    def pcg_backend(self, sq, scs, b_hat, sp):
        lm = self.uses_lambda
        consts = (self._x, self.ur, self.cons, self.mask_img, self.params,
                  sq, scs)

        def hat_apply(r, p_prev=None, beta=None):
            return warp_hat_apply(*consts, r, p_prev, beta)

        def sweep(*state):
            return warp_pipelined_sweep(*consts, *state,
                                        b_hat=b_hat if lm else None)

        return hat_pcg(self.variant, hat_apply, pcg_update, sweep, torch.dot,
                       b_hat, sp, lm)


# ---------------------------------------------------------------------------
# the resident-state solver: one K13 launch per outer step
# ---------------------------------------------------------------------------


# K13's on-chip form (csrc/resident_onchip.cuh): a block a tile of
# ONCHIP_TILE pixels (rows, columns), holding in shared memory three float4
# a pixel over the tile and its one-pixel ring, and 17 floats of scratch;
# its barrier reads ONCHIP_MAX_TILES blocks' partials at most
ONCHIP_TILE = (32, 64)
ONCHIP_SMEM_BYTES = 16 * (3 * (ONCHIP_TILE[0] + 2) * (ONCHIP_TILE[1] + 2)
                          + 5)
ONCHIP_MAX_TILES = 256


def onchip_tiles(H, W, sms, smem_per_block):
    """The tiles of K13's on-chip form for an H x W image_warping grid on a
    card of `sms` SMs whose blocks may take `smem_per_block` bytes of
    shared memory: one block a tile and an SM, so the form holds where the
    tiles number no more than the SMs and a tile's state fits a block.  0
    where it does not: the grid takes the L2 form."""
    th, tw = ONCHIP_TILE
    tiles = -(-H // th) * -(-W // tw)
    fits = (tiles <= min(sms, ONCHIP_MAX_TILES)
            and ONCHIP_SMEM_BYTES <= smem_per_block)
    return tiles if fits else 0


class WarpHat:
    """image_warping's A_hat for K13, at the linearization point x, on the
    flat (3 H W) layout; its launch is the L2 form's."""

    parts_per_block = 2  # floats of scratch: a partial a dot

    def __init__(self, x, ur, cons, mask, params):
        self.operands = dict(x=x, ur=ur, cons=cons, mask=mask, params=params)
        self.H, self.W = mask.shape[:2]

    def form(self, card):
        """The form that runs this grid on a card of card = (SMs, shared
        memory a block may take): the on-chip one where onchip_tiles
        holds."""
        if onchip_tiles(self.H, self.W, *card):
            return OnChipWarpHat(**self.operands)
        return self

    def shapes(self):
        return _shapes(self.H, self.W)

    def apply_plain(self, sq, p):
        return warp_hat_apply_plain(*self.operands.values(), sq, None, p)[1]

    def planes(self, v):
        """v in the kernel's layout: the flat vector itself."""
        return v

    flat = planes

    def blocks(self, lib):
        return lib.opt_resident_warp_blocks(self.H, self.W)

    def launch(self, lib, vecs, n_iters, blocks):
        return lib.opt_resident_warp(
            *map(build.ptr, (*self.operands.values(), *vecs)), self.H,
            self.W, n_iters, blocks, build.stream())


class OnChipWarpHat(WarpHat):
    """WarpHat whose launch is K13's on-chip form."""

    parts_per_block = 4  # a tagged 8-byte slot a dot

    def form(self, card):
        return self

    def blocks(self, lib):
        return lib.opt_resident_warp_onchip_blocks(self.H, self.W)

    def launch(self, lib, vecs, n_iters, blocks):
        return resident_pcg_onchip(lib, self, vecs, n_iters, blocks)


@kernel("K13.resident_pcg_onchip")
def resident_pcg_onchip(lib, hat, vecs, n_iters, blocks):
    """K13's on-chip form: one cooperative launch on vecs = (sq, b_hat,
    delta, r, p0, p1, ap, parts), of which r, p0 and p1 carry only the
    tiles' edges and ap is not read; raises on a failed launch."""
    sq, b_hat, delta, r, p0, p1, _, parts = vecs
    rc = lib.opt_resident_warp_onchip(
        *map(build.ptr, (*hat.operands.values(), sq, b_hat, delta, r, p0, p1,
                         parts)),
        hat.H, hat.W, n_iters, blocks, build.stream())
    build.check(rc, "resident_pcg")
    LAUNCHES["K13.resident_pcg_onchip"] += 1
    return rc


class PoissonHat:
    """poisson_image_editing's A_hat for K13 on the flat (H, W, C) vector:
    sq J^T J (sq v); sq is 0 at the excluded pixels.  The kernel runs on
    (C, H, W) planes, as K12 does."""

    operands = {}
    parts_per_block = 2

    def __init__(self, H, W, C):
        self.H, self.W, self.C = H, W, C

    def shapes(self):
        return {}

    def apply_plain(self, sq, p):
        return sq * self.flat(poisson_jtj_plain(self.planes(sq * p)))

    def planes(self, v):
        """The flat (H, W, C) vector v as (C, H, W) planes."""
        return v.view(self.H, self.W, self.C).permute(2, 0, 1).contiguous()

    def flat(self, v):
        """(C, H, W) planes as the flat (H, W, C) vector."""
        return v.permute(1, 2, 0).reshape(-1)

    def form(self, card):
        return self

    def blocks(self, lib):
        return lib.opt_resident_poisson_blocks(self.H * self.W)

    def launch(self, lib, vecs, n_iters, blocks):
        return lib.opt_resident_poisson(
            *map(build.ptr, vecs), self.H, self.W, self.C, n_iters, blocks,
            build.stream())


def resident_pcg_plain(hat, sq, b_hat, n_iters):
    """K13's loop in torch (StreamSolver's kernel body,
    stream_solver.py:424-550): n_iters of solver/hat_pcg.py's classic loop
    on hat.apply_plain, GN, no early exit, in K13's phase order (p = r +
    beta p_prev formed where the apply reads it, from p_prev = 0 and
    beta = 0).  Returns d_hat."""

    def apply(r, p_prev, beta):
        p = r + beta * p_prev
        ap = hat.apply_plain(sq, p)
        return p, ap, torch.dot(p, ap)

    return classic_pcg(apply, pcg_update_plain, torch.dot, b_hat,
                       {"lIterations": n_iters}, lm=False)


@kernel("K13.resident_pcg")
def resident_pcg(hat, sq, b_hat, n_iters):
    """K13: d_hat after n_iters of PCG in the hat space (hat: WarpHat or
    PoissonHat) -- one cooperative launch on CUDA, of the form the card
    holds for the grid (hat.form), plain (resident_pcg_plain) on CPU."""
    if build.all_on_cpu(sq, b_hat, *hat.operands.values()):
        return resident_pcg_plain(hat, sq, b_hat, n_iters)
    n = b_hat.numel()
    build.check_tensors("resident_pcg", {**hat.shapes(), "sq": (n,),
                                         "b_hat": (n,)},
                        **hat.operands, sq=sq, b_hat=b_hat)
    lib = build.library()
    hat = hat.form(build.card_limits())
    blocks = build.coop_blocks(hat.blocks(lib), "resident_pcg")
    sq_k, b_k = hat.planes(sq), hat.planes(b_hat)
    # p0 and p1: the ping-pong pair of p_prev and p
    delta, r, p0, p1, ap = (torch.empty_like(b_k) for _ in range(5))
    parts = torch.empty(hat.parts_per_block * blocks, dtype=b_hat.dtype,
                        device=b_hat.device)
    rc = hat.launch(lib, (sq_k, b_k, delta, r, p0, p1, ap, parts),
                    int(n_iters), blocks)
    build.check(rc, "resident_pcg")
    LAUNCHES["K13.resident_pcg"] += 1
    return hat.flat(delta)


def warp_resident_backend(op):
    """K13 as a WarpOperator's pcg_backend (GN): one launch of
    lIterations on A_hat at the operator's linearization point."""

    def backend(sq, scs, b_hat, sp):
        hat = WarpHat(op._x, op.ur, op.cons, op.mask_img, op.params)
        return resident_pcg(hat, sq, b_hat, int(sp["lIterations"]))

    return backend




def supports(plan):
    """StreamSolver's gate (stream_solver.py:104-159, state_in="vmem"):
    Gauss-Newton, f32, one 2-D grid of centered term groups, and an energy
    whose A_hat K13 holds in closed form: image_warping, or poisson
    (poisson_cuda.is_poisson).  The JAX gate's lane and sublane alignment
    and its VMEM budget model are TPU scaffolding and are not ported."""
    return (not plan.config.uses_lambda
            and plan.funcs.dtype == torch.float32
            and not plan.spec.graphs and len(plan.dims) == 2
            and all(g.kind == "centered" for g in plan.funcs.groups)
            and (plan.problem.energy is energies.image_warping
                 or is_poisson(plan)))


class StreamSolver:
    """The whole GN solve with one outer step's PCG in one kernel (port of
    stream_solver.py StreamSolver, :327-684): nIterations outer steps,
    each the solver's GN step (solver/core.py) with K13 as its
    pcg_backend -- linearize, J^T F, diag, the masks and sq = sqrt(pre)
    (sq = 0 at excluded unknowns, pre = 1 without a preconditioner), then
    one K13 launch of lIterations on b_hat = sq (-J^T F), then
    x += sq d_hat and the cost.  The outer step runs on WarpOperator's K3
    for image_warping and on the plan's evaluator (EvaluatorOuter) for
    poisson, which the JAX package also runs in XLA.  It runs on the
    plan's device; no Plan.solve engine reaches it."""

    def __init__(self, plan):
        if not supports(plan):
            raise ValueError(
                "StreamSolver holds Gauss-Newton f32 plans of image_warping "
                "or poisson_image_editing on one 2-D grid")
        self.plan = plan
        config = SolverConfig(
            guarded_invert_type=plan.config.guarded_invert_type)
        self._full_solve = make_solver(config, plan.funcs.dtype,
                                       plan.funcs.use_preconditioner)[3]

    def _operator(self, data):
        plan = self.plan
        if plan.problem.energy is energies.image_warping:
            op = WarpOperator(data)
            op.pcg_backend = warp_resident_backend(op)
            return op
        op = plan_fns.EvaluatorOuter(plan.funcs, data, plan.layout)
        hat = PoissonHat(*plan.funcs.unknown_shapes["X"])
        op.pcg_backend = lambda sq, scs, b_hat, sp: resident_pcg(
            hat, sq, b_hat, int(sp["lIterations"]))
        return op

    def solve(self, inputs):
        """{"x": name -> unknown tensor, "final_cost": float}."""
        plan = self.plan
        x, data = plan.bind(inputs)
        st = self._full_solve(x, self._operator(data), plan.solver_params)
        return {"x": plan.layout.views(st["x"]),
                "final_cost": float(st["prev_cost"])}
