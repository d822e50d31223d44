"""The volumetric ARAP closed forms (ops/vol_cuda.py, ops/stream3d_cuda.py)
against the JAX package's ProblemFunctions for the same energy: cost, J^T
F, diag(J^T J), J^T J p through JAX's linearize and its transpose, the hat
apply with sq and scs, the pipelined sweep and the model cost, at
12x8x5 with angles ~0.3 rad (so the rotation's derivatives are
exercised), unconstrained (-inf) voxels and every boundary face.  The CUDA
kernels K6-K8 are held against these same plain versions on the card
(chip_smoke.py, test_torch_cuda.py), so this is what checks the
hand-derived derivatives.  rtol 1e-5 in f32 (see assert_close)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
import chip_smoke
import opt_tpu_torch
from opt_tpu_torch import energies
from opt_tpu_torch.ops import stream3d_cuda, vol_cuda
from opt_tpu_torch.runtime.trace import LAUNCHES
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack

torch.set_num_threads(1)

RTOL = 1e-5
NAMES = ("Offset", "Angle")
W, H, D = 12, 8, 5


def vol_case_inputs(W, H, D, seed=0):
    """A deformed grid with random rest shape, angles ~0.3 rad and about a
    third of the voxels fit-constrained (the rest -inf)."""
    rng = np.random.RandomState(seed)
    shape = (D, H, W, 3)
    cons = np.full(shape, -np.inf, np.float32)
    pinned = rng.rand(D, H, W) < 0.3
    cons[pinned] = rng.randn(int(pinned.sum()), 3).astype(np.float32)
    return {
        "Offset": rng.randn(*shape).astype(np.float32),
        "UrShape": rng.randn(*shape).astype(np.float32),
        "Angle": (0.3 * rng.randn(*shape)).astype(np.float32),
        "Constraints": cons,
        "w_fitSqrt": np.float32(0.8),
        "w_regSqrt": np.float32(1.3),
    }


@pytest.fixture(scope="module")
def case():
    inputs = vol_case_inputs(W, H, D)
    jplan, tplan = plans("volumetric_mesh_deformation", [W, H, D])
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    rng = np.random.RandomState(2)
    rand = lambda: {n: jnp.asarray(rng.randn(*s).astype(np.float32))
                    for n, s in f.unknown_shapes.items()}
    p, delta = rand(), rand()
    sq = {n: jnp.abs(v) + 0.1 for n, v in rand().items()}
    ctc = {n: jnp.abs(v) for n, v in rand().items()}
    r0, jvp, jt = f.linearize(jx, jdata)
    jtj_sqp = jt(jvp({n: sq[n] * p[n] for n in p}))
    ref = {
        "cost": float(f.cost(jx, jdata)),
        "jtf": pack(f.jtf(r0, jt), NAMES),
        "diag": pack(f.diag_jtj(jx, jdata), NAMES),
        "jtjp": pack(jt(jvp(p)), NAMES),
        "model_cost": float(f.model_cost(r0, jvp, delta, jx, jdata)),
        "hat_gn": pack({n: sq[n] * jtj_sqp[n] for n in p}, NAMES),
        "hat_lm": pack({n: sq[n] * jtj_sqp[n] + sq[n] * sq[n] * ctc[n] * p[n]
                        for n in p}, NAMES),
    }
    t = lambda tree: torch.as_tensor(pack(tree, NAMES))
    vecs = {"p": t(p), "delta": t(delta), "sq": t(sq)}
    vecs["scs"] = vecs["sq"] * vecs["sq"] * t(ctc)
    tx, tdata = tplan.bind(inputs)
    op = vol_cuda.VolOperator(tdata)
    return op, tx, vecs, ref


def test_layout_is_the_solver_layout(case):
    op, x, _, _ = case
    assert tuple(op.ur.shape) == (D, H, W, 3)
    assert x.shape == (6 * D * H * W,)


def test_linearize_plain_matches_jax(case):
    op, x, _, ref = case
    jtf, diag, cost = vol_cuda.vol_linearize_plain(x, op.ur, op.cons,
                                                   op.params)
    assert_close(jtf.numpy(), ref["jtf"], RTOL, "J^T F")
    assert_close(diag.numpy(), ref["diag"], RTOL, "diag")
    assert float(cost) == pytest.approx(ref["cost"], rel=RTOL)
    assert np.isfinite(float(cost))  # the -inf constraints drop out


def test_linearize_plain_cost_only_and_model_cost(case):
    op, x, vecs, ref = case
    jtf, diag, cost = vol_cuda.vol_linearize_plain(x, op.ur, op.cons,
                                                   op.params, cost_only=True)
    assert jtf is None and diag is None
    assert float(cost) == pytest.approx(ref["cost"], rel=RTOL)
    op.outer(x)
    got = op.model_cost(vecs["delta"])
    assert float(got) == pytest.approx(ref["model_cost"], rel=RTOL)


def test_jtj_apply_plain_matches_jax(case):
    op, x, vecs, ref = case
    p = vecs["p"]
    ap, pap = vol_cuda.vol_jtj_apply_plain(x, p, op.ur, op.cons, op.params)
    assert_close(ap.numpy(), ref["jtjp"], RTOL, "J^T J p")
    assert float(pap) == pytest.approx(float(p.numpy() @ ref["jtjp"]),
                                       rel=RTOL)


@pytest.mark.parametrize("lm", [False, True])
def test_hat_apply_plain_matches_jax(case, lm):
    """sq . J^T J (sq . p) + scs . p, and the fused beta step: r + beta
    p_prev with r = p - beta p_prev gives the same p."""
    op, x, vecs, ref = case
    p, sq = vecs["p"], vecs["sq"]
    scs = vecs["scs"] if lm else None
    want = ref["hat_lm" if lm else "hat_gn"]
    got_p, ap, pap = stream3d_cuda.vol_hat_apply_plain(
        x, op.ur, op.cons, op.params, sq, scs, p)
    assert got_p is p
    assert_close(ap.numpy(), want, RTOL, "A_hat p")
    assert float(pap) == pytest.approx(float(p.numpy() @ want), rel=RTOL)
    beta = torch.tensor(0.61)
    prev = vecs["delta"]
    got_p, ap2, _ = stream3d_cuda.vol_hat_apply_plain(
        x, op.ur, op.cons, op.params, sq, scs, p - beta * prev, prev, beta)
    assert_close(got_p.numpy(), p.numpy(), RTOL, "p")
    assert_close(ap2.numpy(), want, RTOL, "A_hat p (beta step)")


@pytest.mark.parametrize("lm", [False, True])
def test_pipelined_sweep_plain_recurrences(case, lm):
    """One sweep of K7's plain version against the recurrences written
    out on the hat apply, with LM's q = 0.5 <delta, r + b_hat>."""
    op, x, vecs, _ = case
    rng = np.random.RandomState(5)
    n = x.shape[0]
    st = {k: torch.as_tensor(rng.randn(n).astype(np.float32))
          for k in ("w", "z", "s", "p", "delta", "r", "b")}
    alpha, beta = torch.tensor(0.37), torch.tensor(0.61)
    scs = vecs["scs"] if lm else None
    b_hat = st["b"] if lm else None
    _, nv, _ = stream3d_cuda.vol_hat_apply_plain(
        x, op.ur, op.cons, op.params, vecs["sq"], scs, st["w"])
    z = nv + beta * st["z"]
    s = st["w"] + beta * st["s"]
    p = st["r"] + beta * st["p"]
    d = st["delta"] + alpha * p
    r = st["r"] - alpha * s
    w_out = st["w"] - alpha * z
    got = {k: v.clone() for k, v in st.items()}
    w_buf = torch.empty_like(st["w"])
    g, dd, q = stream3d_cuda.vol_pipelined_sweep(
        x, op.ur, op.cons, op.params, vecs["sq"], scs, got["w"], w_buf,
        got["z"], got["s"], got["p"], got["delta"], got["r"], alpha, beta,
        b_hat)
    for name, want in (("z", z), ("s", s), ("p", p), ("delta", d),
                       ("r", r)):
        assert torch.equal(got[name], want), name
    assert torch.equal(w_buf, w_out)
    assert float(g) == pytest.approx(float(r @ r), rel=RTOL)
    assert float(dd) == pytest.approx(float(w_out @ r), rel=RTOL)
    if lm:
        assert float(q) == pytest.approx(0.5 * float(d @ (r + st["b"])),
                                         rel=RTOL)
    else:
        assert q is None


def test_operator_on_cpu_runs_the_plain_versions(case):
    """The kernel wrappers take the plain path only because the tensors
    lie on the CPU; nothing counts as a launch."""
    op, x, vecs, ref = case
    counts = lambda: (LAUNCHES["K8.vol_linearize"],
                      LAUNCHES["K6.vol_hat_apply"],
                      LAUNCHES["K7.vol_pipelined_sweep"])
    before = counts()
    jtf, diag = op.outer(x)
    ap, _ = op.apply(vecs["p"])
    assert counts() == before
    want = vol_cuda.vol_linearize_plain(x, op.ur, op.cons, op.params)
    assert torch.equal(jtf, want[0]) and torch.equal(diag, want[1])
    assert_close(ap.numpy(), ref["jtjp"], RTOL, "apply")
    assert float(op.cost(x)) == pytest.approx(ref["cost"], rel=RTOL)
    assert op.mask(vecs["p"]) is vecs["p"]  # the energy excludes nothing


def test_wrappers_raise_for_tensors_off_cpu_and_cuda():
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel's checks, which refuse anything but contiguous f32 CUDA."""
    meta = lambda *s: torch.empty(*s, device="meta")
    n = 6 * D * H * W
    vol = meta(D, H, W, 3)
    with pytest.raises(ValueError, match="cuda"):
        vol_cuda.vol_linearize(meta(n), vol, vol, meta(2))
    with pytest.raises(ValueError, match="cuda"):
        stream3d_cuda.vol_hat_apply(meta(n), vol, vol, meta(2), meta(n),
                                    None, meta(n))
    with pytest.raises(ValueError, match="cuda"):
        stream3d_cuda.vol_pipelined_sweep(
            meta(n), vol, vol, meta(2), meta(n), None, meta(n), meta(n),
            meta(n), meta(n), meta(n), meta(n), meta(n), meta(()),
            meta(()))


def test_supports_needs_the_energy_and_a_cuda_plan():
    st = opt_tpu_torch.NewState(device="cpu")
    vol = st.problem_plan(
        st.problem_define(energies.volumetric_mesh_deformation), [4, 4, 4])
    warp = st.problem_plan(st.problem_define(energies.image_warping), [8, 6])
    assert vol_cuda.supports_energy(vol)
    assert not vol_cuda.supports(vol)  # a CPU plan
    assert not vol_cuda.supports_energy(warp)
    assert vol._pick_engine("auto") == "torch"
    assert vol._pick_engine("stream3d") == "stream3d"
    with pytest.raises(ValueError, match="volumetric"):
        warp._pick_engine("stream3d")
    with pytest.raises(ValueError, match="image_warping"):
        vol._pick_engine("stream")


def test_volume_inputs_equal_bench(monkeypatch):
    """chip_smoke.volume_inputs is bench.aux_volumetric's inline inputs:
    the bench run is stopped where it binds them, and they are compared."""
    import opt_tpu

    class Bound(Exception):
        pass

    class Plan:
        def set_solver_parameter(self, *a):
            pass

        def bind(self, inputs):
            raise Bound(inputs)

    class State:
        problem_define = staticmethod(lambda *a: None)
        problem_plan = staticmethod(lambda *a: Plan())

    monkeypatch.setattr(opt_tpu, "NewState", State)
    with pytest.raises(Bound) as got:
        bench.aux_volumetric(None)
    want = got.value.args[0]
    mine = chip_smoke.volume_inputs(128)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(v),
                                      err_msg=k)
