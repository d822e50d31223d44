"""The algebra of K8 vol_linearize's march on the shared-memory 3-D core
(csrc/vol_kernels.cu vol_linearize_march, on csrc/vol_tile.cuh's loaders),
on the CPU.

The kernel cannot run here, so a torch rendering of its decomposition
stands in for it: `march` walks a volume's own planes chunk by chunk, as
a block does, one (H, W) plane at a time, and forms each arap residual
once, by its centre, in the kernel's order at each plane: the D pair
r_{d-1,+D}, r_{d,-D} with the plane before, each centre keeping its r^2
and (full mode) its halves, -w_reg r handed to the other; the plane
before, now whole, adds its fit term, its cost and its output; then the
four in-plane residuals in offset order, their centre halves into the
voxel's sums and (full mode) r routed to the neighbour, which adds
-w_reg r after its own residuals in offset order.  In the cost modes only
voxels on own planes form residuals; in full mode the face planes form
theirs too and hand their halves in, but count no cost.  Diag's Offset
part is w_reg^2 per residual half: two for each residual a voxel centres.
R(a) and dR/da come from one trig.  It is held (rtol 1e-5) against:

* vol_linearize_plain and vol_slab_linearize_plain, the versions the
  kernel is held to on the card, in each mode (J^T F, diag and the cost;
  the cost alone; LM's model cost): at 37x23 with D = 11, 1 and 33, in
  chunks of 32 planes (the kernel's at 128^3), 4 and 1; on 3 slabs of 1
  and of 17 planes with a halo of 2, the first slab's halo before the
  global edge and the last's past it, the whole volume's cost the sum of
  the slabs';
* the JAX package: J^T F, diag(J^T J), the cost and LM's model cost
  through its linearize of energies.volumetric_mesh_deformation at
  12x8x5.

The JAX reference is built once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu_torch.ops import slab_cuda, vol_cuda
from opt_tpu_torch.ops.vol_cuda import (FIT_VALID, OFFSETS, _drot, _rot,
                                        _shift, _split, _trig)
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack
from tests.test_torch_vol import vol_case_inputs

torch.set_num_threads(1)

RTOL = 1e-5
CHUNK = 32  # the planes a block marches at 128^3 on an H100 (one wave)
MODES = ["full", "cost_only", "model_cost"]
NAMES = ("Offset", "Angle")
SMALL = (37, 23)


# ---------------------------------------------------------------------------
# the rendering
# ---------------------------------------------------------------------------


def _plane_shift(a, dw, dh):
    """out[h, w] = a[h + dh, w + dw], zero outside; a is (H, W, C)."""
    return _shift(a[None], dw, dh, 0)[0]


def _plane_inb(H, W, dw, dh):
    """(H, W): the in-plane neighbour at (dw, dh) is in the plane."""
    h = torch.arange(H)[:, None] + dh
    w = torch.arange(W)[None, :] + dw
    return (h >= 0) & (h < H) & (w >= 0) & (w < W)


def _centre(c, n, valid, w_reg, mode):
    """The arap residuals centred at the plane's voxels c reading their
    neighbours n (Offset, UrShape, delta's Offset), zero where not valid:
    r, plus J delta in the model cost.  r^2 goes into c's ssq; in full mode
    c's halves go into its sums and two w_reg^2 halves into its diag
    count."""
    zero = torch.zeros(())
    v3 = valid[..., None]
    e = c["U"] - n["U"]
    r = w_reg * ((c["O"] - n["O"]) - _rot(c["t"], e))
    G = _drot(c["t"], e)
    if mode == "model_cost":
        r = r + w_reg * ((c["d"] - n["d"])
                         - (G * c["dA"][..., :, None]).sum(-2))
    r = torch.where(v3, r, zero)
    c["ssq"] = c["ssq"] + (r * r).sum(-1)
    if mode == "full":
        Gw = torch.where(v3[..., None], -w_reg * G, zero)
        c["j"] = c["j"] + w_reg * r
        c["jA"] = c["jA"] + (Gw * r[..., None, :]).sum(-1)
        c["gA"] = c["gA"] + (Gw * Gw).sum(-1)
        c["nreg"] = c["nreg"] + 2 * valid
    return r


def march(x, ur, cons, params, mode="full", delta=None, own=None,
          planes=None, chunk=CHUNK):
    """K8's march over the own planes [lo, hi) of a (D, H, W) array (all
    of them by default), in chunks of `chunk` planes; planes = (d0, Dg)
    places array plane 0 at global plane d0 of Dg (an extended slab).
    Returns J^T F (Offset, Angle, (D, H, W, 3) each), diag (the Offset
    channels' common value (D, H, W), Angle (D, H, W, 3)) and the squared
    residuals (D, H, W) each voxel centres, zero off the own planes."""
    D, H, W = ur.shape[:3]
    w_fit, w_reg = params[0], params[1]
    O, ang = _split(x, (D, H, W))
    dO, dA = _split(delta, (D, H, W)) if delta is not None else (O, ang)
    lo, hi = own or (0, D)
    d0, Dg = planes or (0, D)
    full = mode == "full"
    zero = torch.zeros(())
    jO, jA = torch.zeros(D, H, W, 3), torch.zeros(D, H, W, 3)
    gO, gA = torch.zeros(D, H, W), torch.zeros(D, H, W, 3)
    ssq = torch.zeros(D, H, W)
    every = torch.ones(H, W, dtype=torch.bool)
    for c0 in range(lo, hi, chunk):
        c1 = min(c0 + chunk, hi)
        prev = None
        for d in range(c0 - 1, c1 + 1):
            cur = None
            if 0 <= d < D and 0 <= d0 + d < Dg:
                cur = {"O": O[d], "U": ur[d], "d": dO[d], "dA": dA[d],
                       "t": _trig(ang[d]), "mine": c0 <= d < c1,
                       "j": torch.zeros(H, W, 3), "jA": torch.zeros(H, W, 3),
                       "gA": torch.zeros(H, W, 3), "ssq": torch.zeros(H, W),
                       "nreg": torch.zeros(H, W)}
            if prev is not None and cur is not None:
                # the D pair: r_{d-1,+D}, then r_{d,-D}
                r = _centre(prev, cur, every & (full or prev["mine"]), w_reg,
                            mode)
                cur["j"] = cur["j"] - w_reg * r
                r = _centre(cur, prev, every & (full or cur["mine"]), w_reg,
                            mode)
                prev["j"] = prev["j"] - w_reg * r
            if prev is not None and prev["mine"]:
                # plane d - 1 is whole: its fit term, cost and output
                fit = cons[d - 1][..., :1] >= FIT_VALID
                f = w_fit * (prev["O"] - cons[d - 1])
                if mode == "model_cost":
                    f = f + w_fit * prev["d"]
                f = torch.where(fit, f, zero)
                ssq[d - 1] = prev["ssq"] + (f * f).sum(-1)
                jO[d - 1] = prev["j"] + w_fit * f
                jA[d - 1] = prev["jA"]
                gO[d - 1] = (prev["nreg"] * (w_reg * w_reg)
                             + torch.where(fit[..., 0], w_fit * w_fit, zero))
                gA[d - 1] = prev["gA"]
            if cur is not None and cur["mine"]:
                sent = []
                for dw, dh, _ in OFFSETS[:4]:  # in-plane, centre halves
                    n = {k: _plane_shift(cur[k], dw, dh)
                         for k in ("O", "U", "d")}
                    sent.append(_centre(cur, n, _plane_inb(H, W, dw, dh),
                                        w_reg, mode))
                if full:
                    for (dw, dh, _), r in zip(OFFSETS[:4], sent):
                        # what the source voxel k - o sent: -w_reg r on O(k)
                        got = _plane_shift(r, -dw, -dh)
                        cur["j"] = cur["j"] - torch.where(
                            _plane_inb(H, W, -dw, -dh)[..., None],
                            w_reg * got, zero)
            prev = cur
    return jO, jA, gO, gA, ssq


def _mode_args(mode, delta):
    return {"full": {}, "cost_only": {"cost_only": True},
            "model_cost": {"delta": delta}}[mode]


def lin_march(x, ur, cons, params, mode="full", delta=None, chunk=CHUNK):
    """K8's function by the march: (J^T F, diag, cost) as
    vol_linearize_plain returns them."""
    jO, jA, gO, gA, ssq = march(x, ur, cons, params, mode, delta,
                                chunk=chunk)
    cost = 0.5 * torch.sum(ssq)
    if mode != "full":
        return None, None, cost
    return (torch.cat((jO.reshape(-1), jA.reshape(-1))),
            torch.cat((gO[..., None].expand_as(jO).reshape(-1),
                       gA.reshape(-1))), cost)


def slab_lin_march(x, ur, cons, params, g, mode="full", delta=None,
                   chunk=CHUNK):
    """K8's offset mode by the march: (J^T F, diag) at every D slab's own
    planes in the local layout (None in the cost modes) and the (S,)
    per-slab costs."""
    n, he, d0, total = g
    own = slice(he, he + n)
    costs, jtf, diag = [], [], []
    for s in range(x.shape[0]):
        jO, jA, gO, gA, ssq = march(
            x[s], ur[s], cons[s], params, mode,
            None if delta is None else delta[s], own=(he, he + n),
            planes=(d0 + s * n, total), chunk=chunk)
        costs.append(0.5 * torch.sum(ssq[own]))
        jtf.append((jO[own], jA[own]))
        diag.append((gO[own][..., None].expand_as(jO[own]), gA[own]))
    costs = torch.stack(costs)
    if mode != "full":
        return None, None, costs
    return slab_cuda._local(jtf), slab_cuda._local(diag), costs


def _close(got, want, what):
    for name, a, b in zip(("J^T F", "diag", "cost"), got, want):
        if b is None:
            assert a is None, f"{what}: {name}"
            continue
        assert_close(a.numpy(), b.numpy(), RTOL, f"{what}: {name}")


# ---------------------------------------------------------------------------
# against the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk", [CHUNK, 4, 1])
@pytest.mark.parametrize("D", [11, 1, CHUNK + 1])
def test_march_matches_plain_linearize(D, chunk, mode):
    x, ur, cons, params, t = chip_smoke.volume_kernel_operands(
        torch, *SMALL, D, torch.device("cpu"), seed=41)
    args = (x, ur, cons, params)
    got = lin_march(*args, mode, t["delta"] if mode == "model_cost" else None,
                    chunk)
    want = vol_cuda.vol_linearize_plain(*args, **_mode_args(mode, t["delta"]))
    _close(got, want, f"D = {D} {mode}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk", [CHUNK, 4])
@pytest.mark.parametrize("n", [1, 17])
def test_march_on_slabs_matches_plain(n, chunk, mode):
    """3 slabs of n own planes of 37x23, a halo of 2; the whole volume's
    cost by the march is the sum of the slabs'."""
    S = 3
    x, ur, cons, params, t, g = chip_smoke.vol_slab_operands(
        torch, *SMALL, S * n, S, torch.device("cpu"), seed=42)
    assert g[:2] == (n, 2)
    delta = t["delta"] if mode == "model_cost" else None
    got = slab_lin_march(x, ur, cons, params, g, mode, delta, chunk)
    want = slab_cuda.vol_slab_linearize_plain(
        x, ur, cons, params, g, **_mode_args(mode, t["delta"]))
    _close(got, want, f"3 slabs of {n} {mode}")
    xw, urw, consw, paramsw, tw = chip_smoke.volume_kernel_operands(
        torch, *SMALL, S * n, torch.device("cpu"), seed=42)
    whole = lin_march(xw, urw, consw, paramsw, mode,
                      tw["delta"] if delta is not None else None, chunk)[2]
    assert float(torch.sum(got[2])) == pytest.approx(float(whole), rel=RTOL)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_linearized():
    """At 12x8x5 on tests/test_torch_vol.py's inputs: the port's bound
    operands, delta, and JAX's J^T F, diag(J^T J), cost and model cost."""
    W, H, D = 12, 8, 5
    inputs = vol_case_inputs(W, H, D, seed=43)
    jplan, tplan = plans("volumetric_mesh_deformation", [W, H, D])
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    rng = np.random.RandomState(44)
    delta = {n: jnp.asarray(rng.randn(*s).astype(np.float32))
             for n, s in f.unknown_shapes.items()}
    r0, jvp, jt = f.linearize(jx, jdata)
    ref = {"jtf": pack(f.jtf(r0, jt), NAMES),
           "diag": pack(f.diag_jtj(jx, jdata), NAMES),
           "cost": float(f.cost(jx, jdata)),
           "model_cost": float(f.model_cost(r0, jvp, delta, jx, jdata))}
    tx, tdata = tplan.bind(inputs)
    op = vol_cuda.VolOperator(tdata)
    return tx, op, torch.as_tensor(pack(delta, NAMES)), ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk", [CHUNK, 2])
def test_march_matches_jax_linearize(jax_linearized, chunk, mode):
    x, op, delta, ref = jax_linearized
    jtf, diag, cost = lin_march(x, op.ur, op.cons, op.params, mode,
                                delta if mode == "model_cost" else None,
                                chunk)
    want = ref["model_cost" if mode == "model_cost" else "cost"]
    assert float(cost) == pytest.approx(want, rel=RTOL)
    if mode == "full":
        assert_close(jtf.numpy(), ref["jtf"], RTOL, "J^T F")
        assert_close(diag.numpy(), ref["diag"], RTOL, "diag")
