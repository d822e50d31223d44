"""Whole solves: opt_tpu_torch's Plan against opt_tpu's on the same numpy
inputs, for both port engines ("torch", the plain engine, and "cuda",
whose kernel wrappers run their closed-form plain versions on CPU
tensors).  The lifecycle and checkpoint contracts are in
test_torch_state.py."""

import numpy as np
import pytest
import torch

import opt_tpu
import opt_tpu_torch
from opt_tpu import energies as jax_energies
from opt_tpu.ops import vmem_solver
from opt_tpu_torch import energies
from tests.test_solver_dense import warp_inputs

torch.set_num_threads(1)

ENGINES = ["torch", "cuda"]


def jax_plan(W, H, n, l):
    st = opt_tpu.NewState()
    plan = st.problem_plan(st.problem_define(jax_energies.image_warping,
                                             "gaussNewtonGPU"), [W, H])
    plan.set_solver_parameter("nIterations", n)
    plan.set_solver_parameter("lIterations", l)
    return plan


def port_plan(W, H, n, l):
    st = opt_tpu_torch.NewState(device="cpu")
    plan = st.problem_plan(st.problem_define(energies.image_warping,
                                             "gaussNewtonGPU"), [W, H])
    plan.set_solver_parameter("nIterations", n)
    plan.set_solver_parameter("lIterations", l)
    return plan


@pytest.fixture(scope="module")
def vmem_8x6():
    """The TPU whole-solve kernel in interpret mode, as
    tests/test_vmem_solver.py runs it: GN 2x6 at 8x6."""
    inputs = warp_inputs(8, 6, seed=31)
    got = vmem_solver.VmemSolver(jax_plan(8, 6, 2, 6)).solve(
        inputs, interpret=True)
    return inputs, got


@pytest.mark.parametrize("engine", ENGINES)
def test_solve_matches_vmem_kernel(vmem_8x6, engine):
    inputs, want = vmem_8x6
    plan = port_plan(8, 6, 2, 6)
    cost = plan.solve(inputs, engine=engine)
    assert plan.engine == engine
    assert cost == pytest.approx(want["final_cost"], rel=2e-4)
    for n, arr in plan.unknowns().items():
        np.testing.assert_allclose(arr, np.asarray(want["x"][n]), rtol=2e-4,
                                   atol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def xla_64x48():
    inputs = warp_inputs(64, 48, seed=4)
    plan = jax_plan(64, 48, 4, 50)
    return inputs, plan.solve(inputs, engine="xla")


@pytest.mark.parametrize("engine", ENGINES)
def test_solve_matches_xla(xla_64x48, engine):
    """64x48, GN 4x50; rtol 1e-4, the bound for re-associated inner loops
    (docs/GUIDE.md:204-207)."""
    inputs, want = xla_64x48
    plan = port_plan(64, 48, 4, 50)
    cost = plan.solve(inputs, engine=engine)
    assert np.isfinite(cost)
    assert cost == pytest.approx(want, rel=1e-4)
