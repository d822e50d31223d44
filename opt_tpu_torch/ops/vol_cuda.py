"""The volumetric ARAP operator on a hand-written CUDA kernel: the outer
step of energies.volumetric_mesh_deformation, for the "stream3d" engine.

The JAX package runs a volume's outer step (J^T F, diag(J^T J), the cost,
LM's model cost) in fused XLA around its 3-D streamed PCG kernels
(opt_tpu/ops/stream3d.py StreamSolver3D.solve).  The port runs it as one
kernel, because the plain engine re-traces torch.func.linearize every
outer step:

  K8 vol_linearize  J^T F, diag(J^T J) and the cost at x, the cost alone,
                    or LM's model cost 0.5 sum (F + J d)^2
                    (csrc/vol_kernels.cu; the energy in closed form in
                    csrc/vol_energy.cuh)

The TPU kernels trace the energy's JAX evaluator; CUDA cannot trace
Python, so until the DSL->kernel emitter exists (ROADMAP.md queue A item 6)
the derivatives of this one energy are written out, and every other 3-D
energy runs the plain engine.  Beside the kernel sit closed-form plain
torch versions (vol_linearize_plain, vol_jtj_apply_plain); the wrapper runs
the plain version for CPU tensors, and the tests hold both against the JAX
package's linearize / transpose / diag_jtj / cost / model_cost.

Layouts follow the JAX package: dims (W, H, D) give arrays of shape
(D, H, W, C); the flat unknown vector is Offset (D, H, W, 3) then Angle
(D, H, W, 3); UrShape and Constraints are (D, H, W, 3); params is the
device tensor [w_fitSqrt, w_regSqrt].  The energy excludes no unknown, so
the operator's mask is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import energies
from ..runtime.trace import LAUNCHES, kernel
from . import build
from .pcg_update import pcg_update

# the energy's stencil, (dw, dh, dd), in its order
OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
           (0, 0, -1))
# Constraints[..., 0] at or above this marks a fit-constrained voxel
FIT_VALID = -999999.9


def supports(plan):
    """True when the plan is the energy these kernels hold, in f32, on a
    CUDA device (GN and LM)."""
    return supports_energy(plan) and plan.device.type == "cuda"


def supports_energy(plan):
    return (plan.problem.energy is energies.volumetric_mesh_deformation
            and plan.funcs.dtype == torch.float32)


# ---------------------------------------------------------------------------
# closed-form plain versions
# ---------------------------------------------------------------------------


def _shift(a, dw, dh, dd):
    """out[d, h, w] = a[d + dd, h + dh, w + dw], zero outside; a is
    (D, H, W[, C])."""
    pads = [0, 0] if a.ndim == 4 else []
    pads += [max(0, -dw), max(0, dw), max(0, -dh), max(0, dh), max(0, -dd),
             max(0, dd)]
    D, H, W = a.shape[:3]
    return F.pad(a, pads)[max(0, dd):max(0, dd) + D,
                          max(0, dh):max(0, dh) + H,
                          max(0, dw):max(0, dw) + W]


def _inbounds(D, H, W, dw, dh, dd, device, planes=None):
    """(D, H, W): the neighbour at offset (dw, dh, dd) is in the volume.
    planes = (d0, Dg) places the array at global plane d0 of a volume of
    Dg planes (an extended D slab, ops/slab_cuda.py): a residual centred
    or reading past the global edge is then none."""
    ar = lambda n, o: ((torch.arange(n, device=device) + o >= 0)
                       & (torch.arange(n, device=device) + o < n))
    inb = (ar(D, dd)[:, None, None] & ar(H, dh)[None, :, None]
           & ar(W, dw)[None, None, :])
    if planes is not None:
        d0, Dg = planes
        g = torch.arange(D, device=device) + d0
        inb = inb & ((g >= 0) & (g < Dg) & (g + dd >= 0)
                     & (g + dd < Dg))[:, None, None]
    return inb


def _split(v, shape):
    n = v.shape[0] // 2
    return v[:n].view(*shape, 3), v[n:].view(*shape, 3)


def _trig(A):
    s, c = torch.sin(A), torch.cos(A)
    return s[..., 0], c[..., 0], s[..., 1], c[..., 1], s[..., 2], c[..., 2]


def _rot(t, e):
    """R(a) e (Rotate3D), for e (..., 3)."""
    sa, ca, sb, cb, sg, cg = t
    e0, e1, e2 = e.unbind(-1)
    return torch.stack((
        cg * cb * e0 + (-sg * ca + cg * sb * sa) * e1
        + (sg * sa + cg * sb * ca) * e2,
        sg * cb * e0 + (cg * ca + sg * sb * sa) * e1
        + (-cg * sa + sg * sb * ca) * e2,
        -sb * e0 + cb * sa * e1 + cb * ca * e2), dim=-1)


def _drot(t, e):
    """(dR/da_k) e for k = alpha, beta, gamma, as (..., 3 [k], 3)."""
    sa, ca, sb, cb, sg, cg = t
    e0, e1, e2 = e.unbind(-1)
    zero = torch.zeros_like(e0)
    g_alpha = torch.stack((
        (sg * sa + cg * sb * ca) * e1 + (sg * ca - cg * sb * sa) * e2,
        (-cg * sa + sg * sb * ca) * e1 + (-cg * ca - sg * sb * sa) * e2,
        cb * ca * e1 - cb * sa * e2), dim=-1)
    g_beta = torch.stack((
        -cg * sb * e0 + cg * cb * sa * e1 + cg * cb * ca * e2,
        -sg * sb * e0 + sg * cb * sa * e1 + sg * cb * ca * e2,
        -cb * e0 - sb * sa * e1 - sb * ca * e2), dim=-1)
    g_gamma = torch.stack((
        -sg * cb * e0 + (-cg * ca - sg * sb * sa) * e1
        + (cg * sa - sg * sb * ca) * e2,
        cg * cb * e0 + (-sg * ca + cg * sb * sa) * e1
        + (sg * sa + cg * sb * ca) * e2,
        zero), dim=-1)
    return torch.stack((g_alpha, g_beta, g_gamma), dim=-2)


def _arap_jv(w_reg, G, vO, nO, vA):
    """J of one arap residual on v: w_reg ((vO - nO) - sum_k G_k vA_k)."""
    return w_reg * ((vO - nO) - (G * vA[..., :, None]).sum(-2))


def vol_jtj_apply_plain(x, p, ur, cons, params, ctc=None, planes=None):
    """(J^T J p + ctc p, <p, Ap>) at linearization point x; planes as in
    _inbounds."""
    shape = ur.shape[:3]
    w_fit, w_reg = params[0], params[1]
    _, A = _split(x, shape)
    pO, pA = _split(p, shape)
    t = _trig(A)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    accO = torch.zeros_like(pO)
    accA = torch.zeros_like(pA)
    for o in OFFSETS:
        valid = _inbounds(*shape, *o, p.device, planes)[..., None]
        G = _drot(t, ur - _shift(ur, *o))
        jp = torch.where(valid, _arap_jv(w_reg, G, pO, _shift(pO, *o), pA),
                         zero)
        accO = accO + w_reg * jp - _shift(w_reg * jp, *(-c for c in o))
        accA = accA - w_reg * (G * jp[..., None, :]).sum(-1)
    fit = cons[..., :1] >= FIT_VALID
    accO = accO + torch.where(fit, w_fit * (w_fit * pO), zero)
    ap = torch.cat((accO.reshape(-1), accA.reshape(-1)))
    if ctc is not None:
        ap = ap + ctc * p
    return ap, torch.dot(p, ap)


def vol_linearize_plain(x, ur, cons, params, cost_only=False, delta=None):
    """(J^T F, diag(J^T J), cost) at x; J^T F and diag are None when
    cost_only.  Given delta, the cost is LM's model cost
    0.5 sum (F + J delta)^2 at x, and J^T F and diag are None."""
    derivs = not (cost_only or delta is not None)
    jO, jA, gO, gA, ssq = linearize_fields(x, ur, cons, params, derivs,
                                           delta)
    cost = 0.5 * torch.sum(ssq)
    if not derivs:
        return None, None, cost
    shape = ur.shape[:3]
    jtf = torch.cat((jO.reshape(-1), jA.reshape(-1)))
    diag = torch.cat((gO[..., None].expand(*shape, 3).reshape(-1),
                      gA.reshape(-1)))
    return jtf, diag, cost


def linearize_fields(x, ur, cons, params, derivs, delta=None, planes=None):
    """Per voxel: J^T F as (Offset, Angle) parts (D, H, W, 3), diag(J^T J)
    as the Offset channels' common value (D, H, W) and the Angle part,
    None unless derivs, and the sum of squared residuals centred there
    (D, H, W), of F + J delta given delta; planes as in _inbounds."""
    shape = ur.shape[:3]
    w_fit, w_reg = params[0], params[1]
    O, A = _split(x, shape)
    if delta is not None:
        dO, dA = _split(delta, shape)
    t = _trig(A)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ssq = torch.zeros(shape, dtype=x.dtype, device=x.device)
    jO, jA = torch.zeros_like(O), torch.zeros_like(A)
    gO = torch.zeros(shape, dtype=x.dtype, device=x.device)
    gA = torch.zeros_like(A)
    for o in OFFSETS:
        inb = _inbounds(*shape, *o, x.device, planes)
        v3 = inb[..., None]
        back = tuple(-c for c in o)
        e = ur - _shift(ur, *o)
        r = torch.where(v3, w_reg * ((O - _shift(O, *o)) - _rot(t, e)), zero)
        if delta is not None:
            G = _drot(t, e)
            r = r + torch.where(v3, _arap_jv(w_reg, G, dO, _shift(dO, *o),
                                             dA), zero)
        ssq = ssq + (r * r).sum(-1)
        if not derivs:
            continue
        G = torch.where(v3[..., None], -w_reg * _drot(t, e), zero)
        jO = jO + w_reg * r - _shift(w_reg * r, *back)
        jA = jA + (G * r[..., None, :]).sum(-1)
        vw = torch.where(inb, w_reg * w_reg, zero)
        gO = gO + vw + _shift(vw, *back)
        gA = gA + (G * G).sum(-1)
    fit = cons[..., :1] >= FIT_VALID
    f = w_fit * (O - cons)
    if delta is not None:
        f = f + w_fit * dO
    f = torch.where(fit, f, zero)
    ssq = ssq + (f * f).sum(-1)
    if not derivs:
        return None, None, None, None, ssq
    jO = jO + w_fit * f
    gO = gO + torch.where(fit[..., 0], w_fit * w_fit, zero)
    return jO, jA, gO, gA, ssq


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


def shapes(D, H, W):
    """The shapes the volume kernels take, by operand name."""
    n = 6 * D * H * W
    return {"x": (n,), "delta": (n,), "ur": (D, H, W, 3),
            "cons": (D, H, W, 3), "params": (2,)}


@kernel("K8.vol_linearize")
def vol_linearize(x, ur, cons, params, cost_only=False, delta=None):
    """K8: (J^T F, diag(J^T J), cost) at x -- kernel on CUDA, plain on
    CPU.  cost_only skips J^T F and diag (returned as None); given delta,
    the cost is LM's model cost 0.5 sum (F + J delta)^2."""
    if build.all_on_cpu(x, ur, cons, params, delta):
        return vol_linearize_plain(x, ur, cons, params, cost_only, delta)
    D, H, W = ur.shape[:3]
    build.check_tensors("vol_linearize", shapes(D, H, W), **build.present(
        x=x, ur=ur, cons=cons, params=params, delta=delta))
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
        lib.opt_vol_linearize_blocks(1, D, H, W, mode), "vol_linearize"),
        dtype=x.dtype, device=x.device)
    rc = lib.opt_vol_linearize(
        build.ptr(x), build.ptr(ur), build.ptr(cons), build.ptr(params),
        build.ptr(delta), build.ptr(jtf), build.ptr(diag), build.ptr(parts),
        D, H, W, mode, build.stream())
    build.check(rc, "vol_linearize")
    LAUNCHES["K8.vol_linearize"] += 1
    return jtf, diag, torch.sum(parts)




class VolOperator:
    """The kernel-backed volume operator for the solver seam
    (solver/core.py).  outer(x) makes x the linearization point for
    apply() and model_cost(); apply runs the hat-space kernel K6 with
    sq = 1 (ops/stream3d_cuda.py)."""

    pcg_backend = None
    dot = staticmethod(torch.dot)

    def __init__(self, data):
        im = data["images"]
        self.ur = im["UrShape"]
        self.cons = im["Constraints"]
        self.params = torch.stack((data["params"]["w_fitSqrt"],
                                   data["params"]["w_regSqrt"]))
        self._x = None

    def cost(self, x):
        return vol_linearize(x, self.ur, self.cons, self.params,
                             cost_only=True)[2]

    def outer(self, x):
        self._x = x
        jtf, diag, _ = vol_linearize(x, self.ur, self.cons, self.params)
        return jtf, diag

    def mask(self, v):
        return v

    def apply(self, p, ctc=None):
        from .stream3d_cuda import vol_hat_apply

        _, ap, pap = vol_hat_apply(self._x, self.ur, self.cons, self.params,
                                   torch.ones_like(p), ctc, p)
        return ap, pap

    def model_cost(self, delta):
        return vol_linearize(self._x, self.ur, self.cons, self.params,
                             delta=delta)[2]

    update = staticmethod(pcg_update)
