"""The algebra of the shared-memory 3-D apply core (csrc/vol_tile.cuh) that
K6 vol_hat_apply and K16 vol_slab_apply run on, on the CPU.

The kernels cannot run here, so a torch rendering of their decomposition
stands in for them: `march` walks a volume's own planes chunk by chunk, as
a block does, one (H, W) plane at a time, and forms each arap residual's
jv once per (voxel, offset), in the kernel's order at each plane: the D
pair r_{d-1,+D}, r_{d,-D} with the plane before, each half into its
voxel's sums; the plane before, now whole, gets its fit term and is
written; then the four in-plane residuals, their centre halves into the
voxel's sums and jv routed to the neighbour, which adds -w_reg jv after
the centre halves in offset order.  A chunk's face planes are read for
the pair that crosses them.  It is held (rtol 1e-5) against:

* vol_hat_apply_plain and vol_slab_apply_plain, the versions the kernels
  are held to on the card: at 37x23x11, D = 1 and a chunk-ragged D, GN and
  LM, with and without beta and p_prev, in chunks of 16 planes (the
  kernel's) and of 4 (faces inside the volume); on 4 slabs of 3 planes
  with a halo of 2;
* the JAX package: the hat apply through its linearize (the evaluator
  the classic kernel traces, as tests/test_torch_vol.py holds it) at
  37x23x11, and ShardedStream3D.build_apply_kernel in interpret mode on 4
  slabs of 3 planes, he = 2 (as tests/test_torch_shard_stream.py runs it,
  at its gates' 128x8 planes).

The JAX references are built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opt_tpu.parallel import stream_shard as jss
from opt_tpu_torch.ops import slab_cuda, stream3d_cuda
from opt_tpu_torch.ops.vol_cuda import (FIT_VALID, OFFSETS, _drot, _shift,
                                        _split, _trig)
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack
from tests.test_torch_shard_stream import VOL, _jax_apply, _mesh, _plans

torch.set_num_threads(1)

RTOL = 1e-5
CHUNK = 16  # kTileD, the planes a block marches
SMALL = (37, 23)
BETA = 0.61


# ---------------------------------------------------------------------------
# the rendering
# ---------------------------------------------------------------------------


def _plane_shift(a, dw, dh):
    """out[h, w] = a[h + dh, w + dw], zero outside; a is (H, W, 3)."""
    return _shift(a[None], dw, dh, 0)[0]


def _plane_inb(H, W, dw, dh):
    """(H, W, 1): the in-plane neighbour at (dw, dh) is in the plane."""
    h = torch.arange(H)[:, None] + dh
    w = torch.arange(W)[None, :] + dw
    return ((h >= 0) & (h < H) & (w >= 0) & (w < W))[..., None]


def _residual(t, cO, cA, cU, nO, nU, w_reg):
    """jv of the residuals centred at voxels of trig t reading their
    neighbours (nO, nU), and the centre halves (on O, on A)."""
    G = _drot(t, cU - nU)
    jv = w_reg * ((cO - nO) - (G * cA[..., :, None]).sum(-2))
    return jv, w_reg * jv, -w_reg * (G * jv[..., None, :]).sum(-1)


def march(x, ur, cons, params, u, own=None, planes=None, chunk=CHUNK):
    """J^T J u at the own planes [lo, hi) of a (D, H, W) array (all of
    them by default), as the core's blocks form it; planes = (d0, Dg)
    places array plane 0 at global plane d0 of Dg (an extended slab).
    Returns the (O, A) parts, (D, H, W, 3), zero off the own planes."""
    D, H, W = ur.shape[:3]
    w_fit, w_reg = params[0], params[1]
    _, ang = _split(x, (D, H, W))
    uO, uA = _split(u, (D, H, W))
    lo, hi = own or (0, D)
    d0, Dg = planes or (0, D)
    zero = torch.zeros(())
    accO, accA = torch.zeros_like(uO), torch.zeros_like(uA)
    for c0 in range(lo, hi, chunk):
        c1 = min(c0 + chunk, hi)
        prev = None
        for d in range(c0 - 1, c1 + 1):
            cur = None
            if 0 <= d < D and 0 <= d0 + d < Dg:
                cur = {"O": uO[d], "A": uA[d], "U": ur[d], "t": _trig(ang[d]),
                       "aO": torch.zeros_like(uO[d]),
                       "aA": torch.zeros_like(uA[d])}
            if prev is not None and cur is not None:  # the D pair
                jv, dO, dA = _residual(prev["t"], prev["O"], prev["A"],
                                       prev["U"], cur["O"], cur["U"], w_reg)
                prev["aO"], prev["aA"] = prev["aO"] + dO, prev["aA"] + dA
                cur["aO"] = cur["aO"] - w_reg * jv
                jv, dO, dA = _residual(cur["t"], cur["O"], cur["A"],
                                       cur["U"], prev["O"], prev["U"], w_reg)
                cur["aO"], cur["aA"] = cur["aO"] + dO, cur["aA"] + dA
                prev["aO"] = prev["aO"] - w_reg * jv
            if prev is not None and d - 1 >= c0:  # plane d - 1 is whole
                fit = cons[d - 1][..., :1] >= FIT_VALID
                accO[d - 1] = prev["aO"] + torch.where(
                    fit, w_fit * (w_fit * prev["O"]), zero)
                accA[d - 1] = prev["aA"]
            if cur is not None and c0 <= d < c1:
                sent = []
                for dw, dh, _ in OFFSETS[:4]:  # in-plane, centre halves
                    valid = _plane_inb(H, W, dw, dh)
                    jv, dO, dA = _residual(
                        cur["t"], cur["O"], cur["A"], cur["U"],
                        _plane_shift(cur["O"], dw, dh),
                        _plane_shift(cur["U"], dw, dh), w_reg)
                    cur["aO"] = cur["aO"] + torch.where(valid, dO, zero)
                    cur["aA"] = cur["aA"] + torch.where(valid, dA, zero)
                    sent.append(torch.where(valid, jv, zero))
                for (dw, dh, _), jv in zip(OFFSETS[:4], sent):
                    # what the source voxel k - o sent: -w_reg jv on O(k)
                    got = _plane_shift(jv, -dw, -dh)
                    cur["aO"] = cur["aO"] - torch.where(
                        _plane_inb(H, W, -dw, -dh), w_reg * got, zero)
            prev = cur
    return accO, accA


def hat_march(x, ur, cons, params, sq, scs, r, p_prev=None, beta=None,
              chunk=CHUNK):
    """K6's function by the march: (p, A_hat p, <p, A_hat p>)."""
    p = r if p_prev is None else r + beta * p_prev
    O, A = march(x, ur, cons, params, sq * p, chunk=chunk)
    ap = sq * torch.cat((O.reshape(-1), A.reshape(-1)))
    if scs is not None:
        ap = ap + scs * p
    return p, ap, torch.dot(p, ap)


def slab_march(x, ur, cons, params, sq, p, g, chunk=CHUNK):
    """K16's function by the march: A_hat p at every slab's own planes,
    in the local layout."""
    n, he, d0, total = g
    own = slice(he, he + n)
    out = []
    for s in range(x.shape[0]):
        O, A = march(x[s], ur[s], cons[s], params, sq[s] * p[s],
                     own=(he, he + n), planes=(d0 + s * n, total),
                     chunk=chunk)
        sO, sA = _split(sq[s], ur.shape[1:4])
        out.append(((sO * O)[own], (sA * A)[own]))
    return slab_cuda._local(out)


# ---------------------------------------------------------------------------
# against the plain versions
# ---------------------------------------------------------------------------


def _operands(W, H, D, seed=11):
    return chip_smoke.volume_kernel_operands(torch, W, H, D,
                                             torch.device("cpu"), seed=seed)


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("chunk", [4, CHUNK])
@pytest.mark.parametrize("D", [11, 1, CHUNK + 1])
def test_march_matches_plain_hat_apply(D, chunk, lm, prev):
    x, ur, cons, params, t = _operands(*SMALL, D)
    args = (x, ur, cons, params, t["sq"], t["scs"] if lm else None, t["r"])
    extra = (t["p"], torch.tensor(BETA)) if prev else ()
    got = hat_march(*args, *extra, chunk=chunk)
    want = stream3d_cuda.vol_hat_apply_plain(*args, *extra)
    for name, a, b in zip(("p", "A_hat p"), got, want):
        assert_close(a.numpy(), b.numpy(), RTOL, name)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=RTOL)


@pytest.mark.parametrize("chunk", [2, CHUNK])
def test_march_on_slabs_matches_plain(chunk):
    """4 slabs of 3 own planes and a halo of 2: the first slab's halo lies
    before the global edge, the last's past it."""
    x, ur, cons, params, t, g = chip_smoke.vol_slab_operands(
        torch, *SMALL, 12, 4, torch.device("cpu"), seed=12)
    assert g[:2] == (3, 2)
    got = slab_march(x, ur, cons, params, t["sq"], t["p"], g, chunk)
    want = slab_cuda.vol_slab_apply_plain(x, ur, cons, params, t["sq"],
                                          t["p"], g)
    assert_close(got.numpy(), want.numpy(), RTOL, "A_hat p")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_hat():
    """At 37x23x11: the inputs, sq, scs, r, p_prev, and sq J^T J (sq v)
    through JAX's linearize for v = r and v = r + beta p_prev."""
    W, H, D = SMALL + (11,)
    x, ur, cons, params, t = _operands(W, H, D, seed=13)
    jplan, _ = plans("volumetric_mesh_deformation", [W, H, D])
    names = ("Offset", "Angle")
    half = 3 * D * H * W
    inputs = {"Offset": x[:half].view(D, H, W, 3).numpy(),
              "Angle": x[half:].view(D, H, W, 3).numpy(),
              "UrShape": ur.numpy(), "Constraints": cons.numpy(),
              "w_fitSqrt": np.float32(params[0]),
              "w_regSqrt": np.float32(params[1])}
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    _, jvp, jt = f.linearize(jx, jdata)
    tree = lambda v: {n: jnp.asarray(a.reshape(D, H, W, 3).numpy())
                      for n, a in zip(names, (v[:half], v[half:]))}
    sq = t["sq"]
    ref = {}
    for prev in (False, True):
        v = t["r"] + BETA * t["p"] if prev else t["r"]
        ref[prev] = sq * torch.as_tensor(pack(jt(jvp(tree(sq * v))), names))
    return (x, ur, cons, params, t), ref


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("lm", [False, True])
def test_march_matches_jax_linearize(jax_hat, lm, prev):
    (x, ur, cons, params, t), ref = jax_hat
    scs = t["scs"] if lm else None
    extra = (t["p"], torch.tensor(BETA)) if prev else ()
    p, ap, _ = hat_march(x, ur, cons, params, t["sq"], scs, t["r"], *extra)
    want = ref[prev] + (scs * p if lm else 0)
    assert_close(ap.numpy(), want.numpy(), RTOL, "A_hat p")


def test_march_on_slabs_matches_the_tpu_kernel():
    """4 slabs of 3 planes, he = 2, against ShardedStream3D's apply
    kernel in interpret mode (as tests/test_torch_shard_stream.py runs
    it: W a multiple of 128, H of 8)."""
    W3, H3, D3 = 128, 8, 12
    jplan, _ = _plans(VOL, [W3, H3, D3])
    eng = jss.ShardedStream3D(jplan, _mesh())
    kern = jax.jit(eng.build_apply_kernel(interpret=True))
    n, he, h_d, h_h = eng.n_local, eng.he, eng.h_d, eng.h_h
    assert (n, he) == (3, 2)
    N = 4
    planes = n + 2 * he
    rng = np.random.RandomState(14)
    f = lambda: rng.randn(N, planes, H3, W3, 3).astype(np.float32)
    off, ang, ur = 0.3 * f(), 0.4 * f(), f()
    cons = np.where(rng.rand(N, planes, H3, W3, 1) < 0.3, f(), -1e7
                    ).astype(np.float32)
    sq, p = np.abs(f()), f()
    params = np.array([0.7, 1.3], np.float32)
    flat = lambda o, a: torch.as_tensor(np.concatenate(
        [o.reshape(N, -1), a.reshape(N, -1)], 1))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    got = slab_march(flat(off, ang), t(ur), t(cons), t(params),
                     flat(sq, sq), flat(p, 2 * p), (n, he, -he, D3), chunk=2)
    got = got.view(2, N, n, H3, W3, 3).numpy()
    pad = ((0, 0), (h_d, h_d), (h_h, h_h), (0, 0))
    chan = lambda a, s: [a[s, ..., c] for c in range(3)]
    own = slice(he, he + n)
    for s in range(N):
        ins = np.stack(chan(ang, s) + chan(off, s) + chan(cons, s)
                       + chan(ur, s) + chan(sq, s) + chan(sq, s))
        pp = np.stack(chan(2 * p, s) + chan(p, s))
        out = _jax_apply(kern, ins, pp, params, s * n - he, pad)
        assert_close(got[0, s], np.stack(
            [out[3 + c, own] for c in range(3)], -1), RTOL, f"slab {s} O")
        assert_close(got[1, s], np.stack(
            [out[c, own] for c in range(3)], -1), RTOL, f"slab {s} A")
