"""The image_warping Gauss-Newton / Levenberg-Marquardt operator on
hand-written CUDA kernels (port of the work inside
opt_tpu/ops/vmem_solver.py).

On the TPU, VmemSolver runs the whole solve of any centered grid energy in
one Pallas kernel whose body traces the energy's JAX evaluator.  CUDA
cannot trace Python, so until the DSL->kernel emitter exists (ROADMAP.md
queue A item 6) the port specialises the kernels to one energy,
energies.image_warping -- the main path -- and every other energy runs the
plain engine (compile/plan_fns.FuncsOperator).  The outer loop and PCG stay
in solver/core.py; this module supplies the operator behind its seam:

  K3 warp_linearize  J^T F, diag(J^T J) and the masked cost at x, the
                     cost alone, or LM's model cost 0.5 sum mask(F + J d)^2
                     (csrc/warp_kernels.cu)
  K1 warp_jtj_apply  mask(J^T J p + ctc p) and <p, Ap>; ctc is LM's CtC
                     diagonal (csrc/warp_kernels.cu, on the row-marching
                     core of csrc/warp_tile.cuh)
  K2 pcg_update      the PCG Step2 (ops/pcg_update.py, csrc/pcg_update.cu)

K1 and K2 run LM's PCG and GN's pipelined one; GN's classic PCG runs as one
K13 launch an outer step (runtime/api.py gives WarpOperator
ops/stream_cuda.warp_resident_backend as its pcg_backend).

Beside each kernel wrapper sits a closed-form plain torch version of the
same function (the *_plain functions); the wrappers run it for CPU tensors,
and the tests hold it against the JAX package's linearize / jt / diag_jtj /
cost, which is what checks the hand-derived derivatives.

Layouts follow the JAX package: the flat unknown vector is Offset (H, W, 2)
then Angle (H, W, 1); UrShape and Constraints are (H, W, 2), Mask
(H, W, 1); params is the device tensor [w_fitSqrt, w_regSqrt].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import energies
from ..runtime.trace import LAUNCHES, kernel
from . import build
from .pcg_update import pcg_update

# the energy's stencil, (dx, dy) = (column, row) offsets, in its order
OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def supports(plan):
    """True when the plan is the energy these kernels hold, in f32, on a
    CUDA device (GN and LM)."""
    return supports_energy(plan) and plan.device.type == "cuda"


def supports_energy(plan):
    return (plan.problem.energy is energies.image_warping
            and plan.funcs.dtype == torch.float32)


# ---------------------------------------------------------------------------
# closed-form plain versions
# ---------------------------------------------------------------------------


def _shift(a, dx, dy):
    """out[i, j] = a[i + dy, j + dx], zero outside; a is (H, W[, C])."""
    pads = [0, 0] if a.ndim == 3 else []
    pads += [max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)]
    H, W = a.shape[:2]
    return F.pad(a, pads)[max(0, dy):max(0, dy) + H,
                          max(0, dx):max(0, dx) + W]


def _valid(keep, mask2, dx, dy, rows=None):
    """Validity of the reg residual centred at each pixel for offset
    (dx, dy): the neighbour is in bounds and neither pixel is masked.
    rows = (row0, Hg) places the array at global row row0 of a grid of Hg
    rows (an extended slab, ops/slab_cuda.py): a residual centred or
    reading past the global edge is then none."""
    H, W = keep.shape
    i = torch.arange(H, device=keep.device)[:, None] + dy
    j = torch.arange(W, device=keep.device)[None, :] + dx
    inb = (i >= 0) & (i < H) & (j >= 0) & (j < W)
    if rows is not None:
        row0, Hg = rows
        g = torch.arange(H, device=keep.device)[:, None] + row0
        inb = inb & (g >= 0) & (g < Hg) & (g + dy >= 0) & (g + dy < Hg)
    return inb & keep & (_shift(mask2, dx, dy) == 0)


def _split(v, H, W):
    return v[:2 * H * W].view(H, W, 2), v[2 * H * W:].view(H, W)


def _drot(s, c, e):
    """R'(a) e, for e (H, W, 2)."""
    return torch.stack((-s * e[..., 0] - c * e[..., 1],
                        c * e[..., 0] - s * e[..., 1]), dim=-1)


def _flat_keep(keep):
    H, W = keep.shape
    return torch.cat((keep[..., None].expand(H, W, 2).reshape(-1),
                      keep.reshape(-1)))


def warp_jtj_apply_plain(x, p, ur, cons, mask, params, ctc=None,
                         rows=None):
    """(mask(J^T J p + ctc p), <p, Ap>) at linearization point x; rows as
    in _valid."""
    H, W = mask.shape[:2]
    w_fit, w_reg = params[0], params[1]
    mask2 = mask.view(H, W)
    keep = mask2 == 0
    _, A = _split(x, H, W)
    pO, pA = _split(p, H, W)
    s, c = torch.sin(A), torch.cos(A)
    accO = torch.zeros_like(pO)
    accA = torch.zeros_like(pA)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for dx, dy in OFFSETS:
        valid = _valid(keep, mask2, dx, dy, rows)[..., None]
        G = _drot(s, c, ur - _shift(ur, dx, dy))
        jp = w_reg * ((pO - _shift(pO, dx, dy)) - G * pA[..., None])
        jp = torch.where(valid, jp, zero)
        accO = accO + w_reg * jp - _shift(w_reg * jp, -dx, -dy)
        accA = accA + (-w_reg * G * jp).sum(-1)
    fit = (cons >= 0).all(-1, keepdim=True)
    accO = accO + torch.where(fit, w_fit * (w_fit * pO), zero)
    ap = torch.cat((accO.reshape(-1), accA.reshape(-1)))
    if ctc is not None:
        ap = ap + ctc * p
    ap = torch.where(_flat_keep(keep), ap, zero)
    return ap, torch.dot(p, ap)


def warp_linearize_plain(x, ur, cons, mask, params, cost_only=False,
                         delta=None):
    """(J^T F, diag(J^T J), masked cost) at x; J^T F and diag are None
    when cost_only.  Given delta, the cost is LM's model cost
    0.5 sum mask(F + J delta)^2 at x, and J^T F and diag are None."""
    derivs = not (cost_only or delta is not None)
    jO, jA, gO, gA, ssq = linearize_fields(x, ur, cons, mask, params,
                                           derivs, delta)
    cost = 0.5 * torch.sum(ssq)
    if not derivs:
        return None, None, cost
    jtf = torch.cat((jO.reshape(-1), jA.reshape(-1)))
    diag = torch.cat((gO.reshape(-1), gA.reshape(-1)))
    return jtf, diag, cost


def linearize_fields(x, ur, cons, mask, params, derivs, delta=None,
                     rows=None):
    """Per pixel: J^T F and diag(J^T J) as (Offset (H, W, 2), Angle (H, W))
    parts, None unless derivs, and the masked sum of squared residuals
    centred there (H, W), of F + J delta given delta; rows as in _valid."""
    H, W = mask.shape[:2]
    w_fit, w_reg = params[0], params[1]
    mask2 = mask.view(H, W)
    keep = mask2 == 0
    O, A = _split(x, H, W)
    if delta is not None:
        dO, dA = _split(delta, H, W)
    s, c = torch.sin(A), torch.cos(A)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ssq = torch.zeros((H, W), dtype=x.dtype, device=x.device)
    jO = torch.zeros_like(O)
    jA = torch.zeros_like(A)
    gO = torch.zeros_like(O)
    gA = torch.zeros_like(A)
    for dx, dy in OFFSETS:
        valid = _valid(keep, mask2, dx, dy, rows)
        v3 = valid[..., None]
        e = ur - _shift(ur, dx, dy)
        rot = torch.stack((c * e[..., 0] - s * e[..., 1],
                           s * e[..., 0] + c * e[..., 1]), dim=-1)
        r = torch.where(v3, w_reg * ((O - _shift(O, dx, dy)) - rot), zero)
        if delta is not None:
            jd = w_reg * ((dO - _shift(dO, dx, dy))
                          - _drot(s, c, e) * dA[..., None])
            r = r + torch.where(v3, jd, zero)
        ssq = ssq + (r * r).sum(-1)
        if not derivs:
            continue
        G = torch.where(v3, -w_reg * _drot(s, c, e), zero)
        jO = jO + w_reg * r - _shift(w_reg * r, -dx, -dy)
        jA = jA + (G * r).sum(-1)
        vw = torch.where(valid, w_reg * w_reg, zero)
        gO = gO + (vw + _shift(vw, -dx, -dy))[..., None]
        gA = gA + (G * G).sum(-1)
    fit = (cons >= 0).all(-1, keepdim=True)
    f = w_fit * (O - cons)
    if delta is not None:
        f = f + w_fit * dO
    f = torch.where(fit, f, zero)
    ssq = torch.where(keep, ssq + (f * f).sum(-1), zero)
    if not derivs:
        return None, None, None, None, ssq
    jO = jO + w_fit * f
    gO = gO + torch.where(fit, w_fit * w_fit, zero)
    return jO, jA, gO, gA, ssq


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _shapes(H, W):
    n = 3 * H * W
    return {"x": (n,), "p": (n,), "ctc": (n,), "delta": (n,),
            "ur": (H, W, 2), "cons": (H, W, 2), "mask": (H, W, 1),
            "params": (2,)}


@kernel("K1.warp_jtj_apply")
def warp_jtj_apply(x, p, ur, cons, mask, params, ctc=None):
    """K1: (mask(J^T J p + ctc p), <p, Ap>) -- kernel on CUDA, plain on
    CPU."""
    if build.all_on_cpu(x, p, ur, cons, mask, params, ctc):
        return warp_jtj_apply_plain(x, p, ur, cons, mask, params, ctc)
    H, W = mask.shape[:2]
    build.check_tensors("warp_jtj_apply", _shapes(H, W), **build.present(
        x=x, p=p, ur=ur, cons=cons, mask=mask, params=params, ctc=ctc))
    lib = build.library()
    ap = torch.empty_like(p)
    parts = torch.empty(build.coop_blocks(lib.opt_warp_apply_blocks(H, W),
                                          "warp_jtj_apply"),
                        dtype=p.dtype, device=p.device)
    rc = lib.opt_warp_jtj_apply(
        build.ptr(x), build.ptr(p), build.ptr(ur), build.ptr(cons),
        build.ptr(mask), build.ptr(params), build.ptr(ctc), build.ptr(ap),
        build.ptr(parts), H, W, build.stream())
    build.check(rc, "warp_jtj_apply")
    LAUNCHES["K1.warp_jtj_apply"] += 1
    return ap, torch.sum(parts)


@kernel("K3.warp_linearize")
def warp_linearize(x, ur, cons, mask, params, cost_only=False, delta=None):
    """K3: (J^T F, diag(J^T J), masked cost) at x -- kernel on CUDA, plain
    on CPU.  cost_only skips J^T F and diag (returned as None); given
    delta, the cost is LM's model cost 0.5 sum mask(F + J delta)^2."""
    if build.all_on_cpu(x, ur, cons, mask, params, delta):
        return warp_linearize_plain(x, ur, cons, mask, params, cost_only,
                                    delta)
    H, W = mask.shape[:2]
    build.check_tensors("warp_linearize", _shapes(H, W), **build.present(
        x=x, ur=ur, cons=cons, mask=mask, params=params, delta=delta))
    lib = build.library()
    jtf = diag = None
    if delta is not None:
        mode = 2
    elif cost_only:
        mode = 1
    else:
        mode = 0
        jtf = torch.empty_like(x)
        diag = torch.empty_like(x)
    parts = torch.empty(build.coop_blocks(
        lib.opt_warp_linearize_blocks(1, H, W, mode), "warp_linearize"),
        dtype=x.dtype, device=x.device)
    rc = lib.opt_warp_linearize(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(mask),
        build.ptr(params), build.ptr(delta), build.ptr(jtf), build.ptr(diag),
        build.ptr(parts), H, W, mode, build.stream())
    build.check(rc, "warp_linearize")
    LAUNCHES["K3.warp_linearize"] += 1
    return jtf, diag, torch.sum(parts)




class WarpOperator:
    """The kernel-backed operator for the solver seam (solver/core.py).

    outer(x) makes x the linearization point for apply() and model_cost();
    the exclusion mask reads only the Mask constant, so it is fixed per
    bind."""

    pcg_backend = None
    dot = staticmethod(torch.dot)

    def __init__(self, data):
        im = data["images"]
        self.ur = im["UrShape"]
        self.cons = im["Constraints"]
        self.mask_img = im["Mask"]
        self.params = torch.stack((data["params"]["w_fitSqrt"],
                                   data["params"]["w_regSqrt"]))
        H, W = self.mask_img.shape[:2]
        self._excl = ~_flat_keep(self.mask_img.view(H, W) == 0)
        self._x = None

    def cost(self, x):
        return warp_linearize(x, self.ur, self.cons, self.mask_img,
                              self.params, cost_only=True)[2]

    def outer(self, x):
        self._x = x
        jtf, diag, _ = warp_linearize(x, self.ur, self.cons, self.mask_img,
                                      self.params)
        return jtf, diag

    def mask(self, v):
        return torch.where(self._excl, torch.zeros((), dtype=v.dtype,
                                                   device=v.device), v)

    def apply(self, p, ctc=None):
        return warp_jtj_apply(self._x, p, self.ur, self.cons, self.mask_img,
                              self.params, ctc)

    def model_cost(self, delta):
        return warp_linearize(self._x, self.ur, self.cons, self.mask_img,
                              self.params, delta=delta)[2]

    update = staticmethod(pcg_update)
