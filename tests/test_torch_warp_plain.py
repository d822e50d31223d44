"""The closed-form plain versions of K1 (warp_jtj_apply) and K3
(warp_linearize) against the JAX package's linearize / jt / diag_jtj /
cost for image_warping.  The CUDA kernels are held against these same
plain versions on the card (chip_smoke.py, test_torch_cuda.py), so this is
what checks the hand-derived derivatives.  rtol 1e-5 in f32 (see
assert_close)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from opt_tpu_torch.ops import warp_cuda
from opt_tpu_torch.runtime.trace import LAUNCHES
from tests.test_solver_dense import warp_inputs
from tests.test_torch_evaluate import assert_close, plans
from tests.test_torch_plan_fns import pack

torch.set_num_threads(1)

RTOL = 1e-5
NAMES = ("Offset", "Angle")

INPUTS = {
    # one excluded pixel, two constraints, small angles
    "dense": lambda W, H: warp_inputs(W, H, seed=7),
    # an excluded pixel, a constraint band, angles ~0.3 rad
    "band": lambda W, H: chip_smoke.kernel_inputs(W, H, seed=3)[0],
}


@pytest.fixture(scope="module",
                params=[("dense", 16, 12), ("band", 37, 23)],
                ids=lambda p: f"{p[0]}-{p[1]}x{p[2]}")
def case(request):
    kind, W, H = request.param
    inputs = INPUTS[kind](W, H)
    jplan, tplan = plans("image_warping", [W, H])
    jx, jdata = jplan.bind(inputs)
    f = jplan.funcs
    rng = np.random.RandomState(2)
    masks = f.unknown_masks(jx, jdata)
    p = f.mask_unknown_tree(
        {n: jnp.asarray(rng.randn(*s).astype(np.float32))
         for n, s in f.unknown_shapes.items()}, masks)
    r0, jvp, jt = f.linearize(jx, jdata)
    ref = {
        "cost": float(f.cost(jx, jdata)),
        "jtf": pack(f.jtf(r0, jt), NAMES),
        "diag": pack(f.diag_jtj(jx, jdata), NAMES),
        "jtjp": pack(f.mask_unknown_tree(jt(jvp(p)), masks), NAMES),
        "p": pack(p, NAMES),
    }
    tx, tdata = tplan.bind(inputs)
    op = warp_cuda.WarpOperator(tdata)
    return op, tx, ref


def test_linearize_plain_matches_jax(case):
    op, x, ref = case
    jtf, diag, cost = warp_cuda.warp_linearize_plain(
        x, op.ur, op.cons, op.mask_img, op.params)
    assert_close(jtf.numpy(), ref["jtf"], RTOL, "J^T F")
    assert_close(diag.numpy(), ref["diag"], RTOL, "diag")
    assert float(cost) == pytest.approx(ref["cost"], rel=RTOL)


def test_linearize_plain_cost_only(case):
    op, x, ref = case
    jtf, diag, cost = warp_cuda.warp_linearize_plain(
        x, op.ur, op.cons, op.mask_img, op.params, cost_only=True)
    assert jtf is None and diag is None
    assert float(cost) == pytest.approx(ref["cost"], rel=RTOL)


def test_jtj_apply_plain_matches_jax(case):
    op, x, ref = case
    p = torch.as_tensor(ref["p"])
    ap, pap = warp_cuda.warp_jtj_apply_plain(x, p, op.ur, op.cons,
                                             op.mask_img, op.params)
    assert_close(ap.numpy(), ref["jtjp"], RTOL, "J^T J p")
    assert float(pap) == pytest.approx(float(ref["p"] @ ref["jtjp"]),
                                       rel=RTOL)


def test_operator_on_cpu_runs_the_plain_versions(case):
    """The kernel wrappers take the plain path only because the tensors
    lie on the CPU; the operator's results are the plain functions'."""
    op, x, ref = case
    p = torch.as_tensor(ref["p"])
    n1, n3 = LAUNCHES["K1.warp_jtj_apply"], LAUNCHES["K3.warp_linearize"]
    jtf, diag = op.outer(x)
    ap, pap = op.apply(p)
    assert (LAUNCHES["K1.warp_jtj_apply"],
            LAUNCHES["K3.warp_linearize"]) == (n1, n3)
    want = warp_cuda.warp_linearize_plain(x, op.ur, op.cons, op.mask_img,
                                          op.params)
    assert torch.equal(jtf, want[0]) and torch.equal(diag, want[1])
    assert torch.equal(ap, warp_cuda.warp_jtj_apply_plain(
        x, p, op.ur, op.cons, op.mask_img, op.params)[0])
    assert float(op.cost(x)) == pytest.approx(ref["cost"], rel=RTOL)


def test_wrappers_raise_for_tensors_off_cpu_and_cuda():
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel's checks, which refuse anything but contiguous f32 CUDA."""
    H, W = 4, 5
    meta = lambda *s: torch.empty(*s, device="meta")
    n = 3 * H * W
    with pytest.raises(ValueError, match="cuda"):
        warp_cuda.warp_jtj_apply(meta(n), meta(n), meta(H, W, 2),
                                 meta(H, W, 2), meta(H, W, 1), meta(2))
    with pytest.raises(ValueError, match="cuda"):
        warp_cuda.warp_linearize(meta(n), meta(H, W, 2), meta(H, W, 2),
                                 meta(H, W, 1), meta(2))


def test_supports_needs_the_energy_and_a_cuda_plan():
    import opt_tpu_torch
    from opt_tpu_torch import energies

    st = opt_tpu_torch.NewState(device="cpu")
    warp = st.problem_plan(st.problem_define(energies.image_warping), [8, 6])
    poisson = st.problem_plan(
        st.problem_define(energies.poisson_image_editing), [8, 6])
    assert warp_cuda.supports_energy(warp)
    assert not warp_cuda.supports(warp)  # a CPU plan
    assert not warp_cuda.supports_energy(poisson)
    assert warp._pick_engine("auto") == "torch"
    assert warp._pick_engine("cuda") == "cuda"
    with pytest.raises(ValueError, match="image_warping"):
        poisson._pick_engine("cuda")
