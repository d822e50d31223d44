"""Poisson image editing's whole-CG solver on a hand-written CUDA kernel
(port of opt_tpu/ops/poisson_pallas.py).

The JAX package's inside baseline for poisson (the reference's
WarpingSolver.cu) runs one Gauss-Newton step of the linear poisson energy
as a whole conjugate-gradient solve inside one Pallas kernel per channel.
Here:

  K12 poisson_cg     every channel's CG, each with its own alpha and beta,
                     in one cooperative launch (csrc/poisson_kernels.cu on
                     csrc/resident_pcg.cuh and csrc/poisson_energy.cuh)

and PoissonCudaSolver, the counterpart of PoissonPallasSolver: b = -J^T F
and the exclusion mask from the plan's evaluator, one K12 launch, then
x + delta and the cost.  Layouts at the kernel follow the JAX kernel's:
b and delta are (C, H, W), keep is (H, W), 1.0 where the unknown is free.
The JAX kernel's padding of W to 128 lanes is TPU scaffolding and is not
ported.
"""

from __future__ import annotations

import torch

from .. import energies
from ..compile import plan_fns
from ..compile.evaluate import shift_read
from ..dsl.env import EnergyEnv
from ..dsl.spec import ProblemSpec
from ..solver.core import _safe_div
from ..runtime.trace import LAUNCHES, kernel
from . import build

# the energy's stencil, (dx, dy) = (column, row) offsets, in its order
DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
# the most channels K12 and K13's poisson mode take (csrc/poisson_energy.cuh)
MAX_CHANNELS = 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _inside(H, W, dx, dy, device):
    """m_d: (H, W) True where the pixel's neighbour (j + dx, i + dy) lies in
    the H x W domain."""
    i = torch.arange(H, device=device)[:, None] + dy
    j = torch.arange(W, device=device)[None, :] + dx
    return (i >= 0) & (i < H) & (j >= 0) & (j < W)


def poisson_jtj_plain(v_chw):
    """J^T J v of the poisson energy for (C, H, W) planes, unmasked:
    sum_d m_d (v - v(. + d)) - shift_{-d}(m_d (v - v(. + d)))
    (poisson_pallas.py:69-74)."""
    C, H, W = v_chw.shape
    out = torch.zeros_like(v_chw)
    zero = torch.zeros((), dtype=v_chw.dtype, device=v_chw.device)
    for dx, dy in DIRS:
        m = _inside(H, W, dx, dy, v_chw.device)
        diff = torch.where(m, v_chw - shift_read(v_chw, (dx, dy, 0)), zero)
        out = out + diff - shift_read(diff, (-dx, -dy, 0))
    return out


def poisson_apply_plain(p_chw, keep_hw):
    """keep . J^T J p: the delta system's operator (keep (H, W) is 1.0 at
    the free pixels, 0.0 at the excluded ones)."""
    return poisson_jtj_plain(p_chw) * keep_hw


def poisson_cg_plain(b_chw, keep_hw, n_iters):
    """The JAX kernel's body (poisson_pallas.py:63-97) in torch: n_iters of
    CG from r = p = keep . b, per channel, alpha = an / ad where ad != 0,
    beta = bn / an where an != 0, no early exit.  Returns delta (C, H,
    W)."""
    sums = lambda a: a.sum(dim=(1, 2), keepdim=True)
    r = b_chw * keep_hw
    p = r
    an = sums(r * r)
    delta = torch.zeros_like(b_chw)
    for _ in range(n_iters):
        ap = poisson_apply_plain(p, keep_hw)
        alpha = _safe_div(an, sums(p * ap))
        delta = delta + alpha * p
        r = r - alpha * ap
        bn = sums(r * r)
        p = r + _safe_div(bn, an) * p
        an = bn
    return delta


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


@kernel("K12.poisson_cg")
def poisson_cg(b_chw, keep_hw, n_iters):
    """K12: delta (C, H, W) after n_iters of CG per channel -- one
    cooperative launch on CUDA, plain on CPU."""
    C, H, W = b_chw.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"poisson_cg: {C} channels; the kernel takes 1 to "
                         f"{MAX_CHANNELS}")
    if build.all_on_cpu(b_chw, keep_hw):
        return poisson_cg_plain(b_chw, keep_hw, n_iters)
    build.check_tensors("poisson_cg", {"b": (C, H, W), "keep": (H, W)},
                        b=b_chw, keep=keep_hw)
    lib = build.library()
    blocks = build.coop_blocks(lib.opt_poisson_cg_blocks(H * W),
                               "poisson_cg")
    # p_prev and p: a ping-pong pair (csrc/resident_pcg.cuh)
    delta, r, p0, p1, ap = (torch.empty_like(b_chw) for _ in range(5))
    parts = torch.empty(2 * C * blocks, dtype=b_chw.dtype,
                        device=b_chw.device)
    rc = lib.opt_poisson_cg(
        *map(build.ptr, (b_chw, keep_hw, delta, r, p0, p1, ap, parts)), C, H,
        W, int(n_iters), blocks, build.stream())
    build.check(rc, "poisson_cg")
    LAUNCHES["K12.poisson_cg"] += 1
    return delta




# ---------------------------------------------------------------------------
# the plans K12 and K13's poisson mode hold, and the solver
# ---------------------------------------------------------------------------


def is_poisson(plan):
    """True where the plan's residuals and exclusion are
    poisson_image_editing's, term for term, on 1 to MAX_CHANNELS channels
    of a 2-D grid, without a preconditioner: the delta system keep . J^T J
    that csrc/poisson_energy.cuh holds in closed form."""
    spec = plan.spec
    shapes = plan.funcs.unknown_shapes
    C = shapes["X"][-1] if list(shapes) == ["X"] else 0
    if (spec.use_preconditioner or len(plan.dims) != 2
            or not 1 <= C <= MAX_CHANNELS):
        return False
    ref = ProblemSpec()
    energies.poisson_image_editing(EnergyEnv(ref, plan.dims), C)
    return (repr(spec.terms), repr(spec.excludes)) == (repr(ref.terms),
                                                       repr(ref.excludes))


class PoissonCudaSolver:
    """One GN step of a poisson plan (is_poisson, f32) as one K12 launch:
    the counterpart of PoissonPallasSolver (poisson_pallas.py:119-174),
    which takes any plan and solves its delta system as poisson's.  It
    runs on the plan's device; on a CPU plan K12's plain version runs."""

    name = "X"

    def __init__(self, plan):
        if plan.funcs.dtype != torch.float32 or not is_poisson(plan):
            raise ValueError(
                "PoissonCudaSolver takes f32 plans of poisson_image_editing "
                f"on 1 to {MAX_CHANNELS} channels")
        self.plan = plan

    def _prep(self, xf, data):
        """(b, keep): b = -J^T F masked, as (C, H, W), and keep (H, W),
        from the plan's evaluator (poisson_pallas.py:129-137)."""
        op = plan_fns.EvaluatorOuter(self.plan.funcs, data, self.plan.layout)
        jtf, _ = op.outer(xf)
        b = op.mask(-jtf).view(self.plan.funcs.unknown_shapes[self.name])
        keep = (~op.masks[self.name][..., 0]).to(b.dtype)  # is_poisson: M
        return b.permute(2, 0, 1).contiguous(), keep

    def solve(self, inputs, n_iters):
        """{"x": name -> (H, W, C) tensor, "final_cost": float} after one
        n_iters CG solve of every channel in one K12 launch."""
        plan = self.plan
        xf, data = plan.bind(inputs)
        x = plan.layout.views(xf)
        b, keep = self._prep(xf, data)
        delta = poisson_cg(b, keep, n_iters)
        x_new = {self.name: x[self.name] + delta.permute(1, 2, 0)}
        return {"x": x_new,
                "final_cost": float(plan.funcs.cost(x_new, data))}
