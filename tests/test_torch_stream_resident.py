"""The port's resident-state solver (ops/stream_cuda.py StreamSolver, K13)
on the CPU, through K13's plain version, against the JAX package's
StreamSolver run in interpret mode as tests/test_stream_solver.py runs it:
image_warping and poisson with Exclude at 128x64, 3 outer x 15 PCG.  The
tolerances are that test's own: cost rtol 1e-4 and x rtol 1e-3, atol 1e-4
(the scaled-space PCG reorders float ops; GN absorbs it,
opt_tpu/ops/stream_solver.py:25-28).  Also StreamSolver's gate and chip_smoke's copy of the JAX tests' poisson
inputs."""

import numpy as np
import pytest
import torch

import opt_tpu_torch
from opt_tpu.ops import stream_solver as ssv
from opt_tpu_torch import energies
from opt_tpu_torch.ops import stream_cuda
from opt_tpu_torch.runtime.trace import LAUNCHES
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
    launches = LAUNCHES["K13.resident_pcg"]
    got = stream_cuda.StreamSolver(tplan).solve(inputs)
    assert LAUNCHES["K13.resident_pcg"] == launches  # plain on CPU
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


@pytest.mark.parametrize("W,H", [(128, 64), (37, 23)])
def test_poisson_inputs_are_the_jax_tests_inputs(W, H):
    """chip_smoke.poisson_inputs, which the slice-5 paths solve, is
    tests/test_stream_solver._poisson_inputs."""
    import chip_smoke

    mine, theirs = chip_smoke.poisson_inputs(W, H), _poisson_inputs(W, H)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
