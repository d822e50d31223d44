"""The port's poisson whole-CG solver (ops/poisson_cuda.py) on the CPU,
through K12's plain version, against the JAX package's
(opt_tpu/ops/poisson_pallas.py) run in interpret mode as
tests/test_poisson_pallas.py runs it, at 40x24: the closed-form J^T J
against both packages' linearize, the CG loop against poisson_cg_vmem
(per channel, an all-zero channel included), and whole solves against
PoissonPallasSolver on both of that file's cases.

Tolerances: rtol 1e-5 (an element's scale: max |JAX|) for the apply and
the CG loop, whose arithmetic is the JAX kernel's own, one op for one op,
with sums taken in another order; the final costs at rtol 1e-5 as well,
since one linear GN step adds no re-associated outer loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.ops.poisson_pallas import PoissonPallasSolver, poisson_cg_vmem
from opt_tpu_torch import energies
from opt_tpu_torch.ops import poisson_cuda
from tests.test_poisson_pallas import make_inputs
from tests.test_torch_evaluate import assert_close

torch.set_num_threads(1)

W, H = 40, 24
RTOL = 1e-5


def poisson1(O):
    """poisson_image_editing on one channel (tests/test_poisson_pallas.py
    test_pallas_cg_exact_parity_single_channel)."""
    W, H = O.Dim("W", 0), O.Dim("H", 1)
    X = O.Unknown("X", O.opt_float, (W, H), 0)
    T = O.Array("T", O.opt_float, (W, H), 1)
    M = O.Array("M", O.opt_float, (W, H), 2)
    O.UsePreconditioner(False)
    O.Exclude(O.Not(O.eq(M(0, 0), 0)))
    for x, y in O.Stencil([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        e = (X(0, 0) - X(x, y)) - (T(0, 0) - T(x, y))
        O.Energy(O.Select(O.InBounds(x, y), e, 0))


def _plans(jax_energy, torch_energy, n_lin=10):
    js = opt_tpu.NewState()
    jplan = js.problem_plan(js.problem_define(jax_energy, "gaussNewtonGPU"),
                            [W, H])
    ts = opt_tpu_torch.NewState(device="cpu")
    tplan = ts.problem_plan(ts.problem_define(torch_energy,
                                              "gaussNewtonGPU"), [W, H])
    for plan in (jplan, tplan):
        plan.set_solver_parameter("nIterations", 1)
        plan.set_solver_parameter("lIterations", n_lin)
    return jplan, tplan


def _keep(inputs):
    return (inputs["M"][..., 0] == 0).astype(np.float32)


def test_apply_matches_plan_fns_and_jax_linearize():
    """poisson_apply_plain = keep . J^T J p, against the port's evaluator
    (FuncsOperator.apply, torch.func) and the JAX package's linearize."""
    inputs = make_inputs(W, H)
    jplan, tplan = _plans(jax_energies.poisson_image_editing,
                          energies.poisson_image_editing)
    p = np.random.RandomState(3).randn(H, W, 4).astype(np.float32)
    keep = _keep(inputs)
    got = poisson_cuda.poisson_apply_plain(
        torch.as_tensor(p).permute(2, 0, 1), torch.as_tensor(keep))
    got = got.permute(1, 2, 0).numpy()

    f = jplan.funcs
    jx, jdata = jplan.bind(inputs)
    _, jvp, jt = f.linearize(jx, jdata)
    want = f.mask_unknown_tree(jt(jvp({"X": jnp.asarray(p)})),
                               f.unknown_masks(jx, jdata))["X"]
    assert_close(got, np.asarray(want), RTOL, "vs JAX linearize")

    from opt_tpu_torch.compile.plan_fns import FuncsOperator

    tx, tdata = tplan.bind(inputs)
    op = FuncsOperator(tplan.funcs, tdata, tplan.layout)
    op.outer(tx)
    ap, _ = op.apply(torch.as_tensor(p).reshape(-1))
    assert_close(got, ap.view(H, W, 4).numpy(), RTOL, "vs plan_fns")


def _jax_cg(b_chw, keep, n_iters):
    """poisson_cg_vmem per channel, on the lane-padded planes, as
    PoissonPallasSolver calls it."""
    C, _, Wd = b_chw.shape
    Wp = -(-Wd // 128) * 128
    bp = jnp.pad(jnp.asarray(b_chw), ((0, 0), (0, 0), (0, Wp - Wd)))
    kp = jnp.pad(jnp.asarray(keep), ((0, 0), (0, Wp - Wd)))
    return np.concatenate([
        np.asarray(poisson_cg_vmem(bp[c:c + 1], kp, n_iters, Wd,
                                   interpret=True))[:, :, :Wd]
        for c in range(C)])


@pytest.mark.parametrize("n_iters", [10, 30])
@pytest.mark.parametrize("C", [1, 4])
def test_cg_matches_poisson_cg_vmem(C, n_iters):
    """K12's plain version against the JAX kernel; with four channels the
    third one's b is zero (as where T equals X): its delta is 0, no NaN."""
    rng = np.random.RandomState(C + n_iters)
    keep = _keep(make_inputs(W, H))
    b = rng.randn(C, H, W).astype(np.float32)
    if C == 4:
        b[2] = 0.0
    want = _jax_cg(b, keep, n_iters)
    got = poisson_cuda.poisson_cg(torch.as_tensor(b), torch.as_tensor(keep),
                                  n_iters).numpy()
    assert np.isfinite(got).all()
    assert_close(got, want, RTOL)
    if C == 4:
        assert not got[2].any()
    # excluded pixels never move
    assert not got[:, keep == 0].any()


def test_cg_rejects_too_many_channels():
    with pytest.raises(ValueError, match="channels"):
        poisson_cuda.poisson_cg(torch.zeros(5, 4, 4), torch.ones(4, 4), 3)


@pytest.fixture(scope="module", params=["rgba", "one_channel"])
def pallas_case(request):
    """(case, inputs, the port's plan, PoissonPallasSolver's result): the
    two cases of tests/test_poisson_pallas.py."""
    inputs = make_inputs(W, H)
    if request.param == "rgba":
        n_lin = 30
        jplan, tplan = _plans(jax_energies.poisson_image_editing,
                              energies.poisson_image_editing, n_lin)
    else:
        n_lin = 25
        inputs = {k: (v[..., :1] if k in ("X", "T") else v)
                  for k, v in inputs.items()}
        jplan, tplan = _plans(poisson1, poisson1, n_lin)
    out = PoissonPallasSolver(jplan).solve(inputs, n_iters=n_lin,
                                           interpret=True)
    return request.param, inputs, tplan, n_lin, out


def test_solver_matches_poisson_pallas_solver(pallas_case):
    _, inputs, tplan, n_lin, want = pallas_case
    launches = poisson_cuda.poisson_cg.launches
    got = poisson_cuda.PoissonCudaSolver(tplan).solve(inputs, n_lin)
    assert poisson_cuda.poisson_cg.launches == launches  # plain on CPU
    assert got["final_cost"] == pytest.approx(want["final_cost"], rel=RTOL)
    assert_close(got["x"]["X"].numpy(), np.asarray(want["x"]["X"]), RTOL)
    # the excluded pixels keep their value
    excl = inputs["M"][..., 0] != 0
    np.testing.assert_array_equal(got["x"]["X"].numpy()[excl],
                                  inputs["X"][excl])


def smooth(O):
    """One unknown on a 2-D grid whose delta system is not poisson's."""
    Wd, Hd = O.Dim("W", 0), O.Dim("H", 1)
    X = O.Unknown("X", O.opt_float, (Wd, Hd), 0)
    O.UsePreconditioner(False)
    for x, y in ((1, 0), (0, 1)):
        O.Energy(O.Select(O.InBounds(x, y), X(0, 0) - X(x, y), 0))


def poisson_precond(O):
    """poisson1 with the Jacobi preconditioner on."""
    poisson1(O)
    O.UsePreconditioner(True)


def test_solver_rejects_other_plans():
    def plan(energy, **state):
        ts = opt_tpu_torch.NewState(device="cpu", **state)
        return ts.problem_plan(ts.problem_define(energy, "gaussNewtonGPU"),
                               [W, H])

    for energy in (energies.poisson_image_editing, poisson1):
        assert poisson_cuda.is_poisson(plan(energy))
        poisson_cuda.PoissonCudaSolver(plan(energy))
    with pytest.raises(ValueError, match="f32"):
        poisson_cuda.PoissonCudaSolver(plan(energies.poisson_image_editing,
                                            double_precision=True))
    # K12 solves poisson's Laplacian whatever the plan: any other delta
    # system would get a wrong delta with no error
    for energy in (energies.image_warping, smooth, poisson_precond):
        assert not poisson_cuda.is_poisson(plan(energy))
        with pytest.raises(ValueError, match="poisson_image_editing"):
            poisson_cuda.PoissonCudaSolver(plan(energy))
