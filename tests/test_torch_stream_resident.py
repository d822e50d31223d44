"""The port's resident-state solver (ops/stream_cuda.py StreamSolver, K13)
on the CPU, through K13's plain version, against the JAX package's
StreamSolver run in interpret mode as tests/test_stream_solver.py runs it:
image_warping and poisson with Exclude at 128x64, 3 outer x 15 PCG.  The
tolerances are that test's own: cost rtol 1e-4 and x rtol 1e-3, atol 1e-4
(the scaled-space PCG reorders float ops; GN absorbs it,
opt_tpu/ops/stream_solver.py:25-28).  Also StreamSolver's gate, K13's
plain loop against the port's shared classic_pcg, and chip_smoke's copy
of the JAX tests' poisson inputs."""

import numpy as np
import pytest
import torch

import opt_tpu_torch
from opt_tpu.ops import stream_solver as ssv
from opt_tpu_torch import energies
from opt_tpu_torch.ops import stream_cuda
from tests.test_stream_solver import _poisson_inputs, _warp_inputs
from tests.test_torch_lm import make_plans

torch.set_num_threads(1)

W, H = 128, 64
CASES = {"image_warping": _warp_inputs,
         "poisson_image_editing": _poisson_inputs}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_stream(request):
    """(energy name, inputs, the JAX StreamSolver's result)."""
    name = request.param
    inputs = CASES[name](W, H)
    jplan, _ = make_plans(name, "gaussNewtonGPU", W, H, 3, 15)
    assert ssv.supports(jplan)
    return name, inputs, ssv.StreamSolver(jplan).solve(inputs)


def test_stream_solver_matches_jax(jax_stream):
    name, inputs, want = jax_stream
    _, tplan = make_plans(name, "gaussNewtonGPU", W, H, 3, 15)
    assert stream_cuda.supports(tplan)
    launches = stream_cuda.resident_pcg.launches
    got = stream_cuda.StreamSolver(tplan).solve(inputs)
    assert stream_cuda.resident_pcg.launches == launches  # plain on CPU
    assert got["final_cost"] == pytest.approx(want["final_cost"], rel=1e-4)
    for n, arr in got["x"].items():
        np.testing.assert_allclose(arr.numpy(), np.asarray(want["x"][n]),
                                   rtol=1e-3, atol=1e-4, err_msg=n)
    if name == "poisson_image_editing":
        # the excluded frame never moves: sq = 0 there
        excl = inputs["M"][..., 0] != 0
        np.testing.assert_array_equal(got["x"]["X"].numpy()[excl],
                                      inputs["X"][excl])


def test_supports_refuses_what_the_kernel_does_not_hold():
    def plan(energy, kind="gaussNewtonGPU", dims=(W, H), **state):
        st = opt_tpu_torch.NewState(device="cpu", **state)
        return st.problem_plan(st.problem_define(energy, kind), list(dims))

    assert stream_cuda.supports(plan(energies.image_warping))
    assert stream_cuda.supports(plan(energies.poisson_image_editing))
    assert not stream_cuda.supports(plan(energies.image_warping, "LMGPU"))
    assert not stream_cuda.supports(plan(energies.image_warping,
                                         double_precision=True))
    assert not stream_cuda.supports(plan(energies.arap_mesh_deformation,
                                         dims=(64, 128)))
    # a grid energy without a closed form in csrc/
    def smooth(O):
        Wd, Hd = O.Dim("W", 0), O.Dim("H", 1)
        X = O.Unknown("X", O.opt_float, (Wd, Hd), 0)
        for x, y in ((1, 0), (0, 1)):
            O.Energy(O.Select(O.InBounds(x, y), X(0, 0) - X(x, y), 0))

    assert not stream_cuda.supports(plan(smooth))
    with pytest.raises(ValueError, match="Gauss-Newton"):
        stream_cuda.StreamSolver(plan(energies.image_warping, "LMGPU"))


def test_resident_loop_matches_classic_pcg():
    """K13's plain loop (p = r + beta p at the end of an iteration) and the
    shared classic_pcg (p = r + beta p at the start of the next) are one
    algorithm: both on the same poisson hat apply, 20 iterations."""
    rng = np.random.RandomState(5)
    Hs, Ws, C = 12, 10, 4
    hat = stream_cuda.PoissonHat(Hs, Ws, C)
    sq = torch.as_tensor((rng.rand(Hs * Ws * C) > 0.2).astype(np.float32))
    b_hat = sq * torch.as_tensor(rng.randn(Hs * Ws * C).astype(np.float32))
    got = stream_cuda.resident_pcg(hat, sq, b_hat, 20)

    def hat_apply(r, p_prev=None, beta=None):
        p = r if p_prev is None else r + beta * p_prev
        ap = hat.apply_plain(sq, p)
        return p, ap, torch.dot(p, ap)

    want = stream_cuda.classic_pcg(
        hat_apply, b_hat, {"lIterations": 20, "residual_reset_period": 10,
                           "q_tolerance": 0.0}, lm=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not got[sq == 0].any()


@pytest.mark.parametrize("W,H", [(128, 64), (37, 23)])
def test_poisson_inputs_are_the_jax_tests_inputs(W, H):
    """chip_smoke.poisson_inputs, which the slice-5 paths solve, is
    tests/test_stream_solver._poisson_inputs."""
    import chip_smoke

    mine, theirs = chip_smoke.poisson_inputs(W, H), _poisson_inputs(W, H)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
