"""The plain reference against opt_tpu_torch's plain engine ("torch") on
the CPU, at each cell's small size (a grid, a volume, a mesh), GN and LM,
and its Jacobian against finite differences and J^T J.  This file and
test_portbench_graph.py import the port."""

import numpy as np
import pytest
import torch

from portbench_testlib import bench, small_cell
from portbench.benchlib import check, window
from portbench.reference.grid import inside, shift

import opt_tpu_torch
from opt_tpu_torch import energies

WORKLOADS = [w["name"] for w in bench(held=True)["workloads"]]


def is_graph(name):
    return getattr(small_cell(name)[0].energy(), "EDGE", None) is not None


GRIDS = [n for n in WORKLOADS if not is_graph(n)]
GRAPHS = [n for n in WORKLOADS if is_graph(n)]


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("solver", ["gaussNewtonGPU", "LMGPU"])
def test_reference_matches_the_ports_plain_engine(name, solver):
    cell, _ = small_cell(name, solver=solver)
    inputs = window.make_pool(cell, 2 ** 31 + 99)[1]
    state = opt_tpu_torch.NewState(device="cpu")
    plan = state.problem_plan(
        state.problem_define(getattr(energies, cell.config["energy"]),
                             cell.traffic["solver"]), cell.config["dims"])
    plan.set_solver_parameter("nIterations", cell.config["nIterations"])
    plan.set_solver_parameter("lIterations", cell.config["lIterations"])
    cost = plan.solve(inputs, engine="torch")
    ref_cost, ref_x, x0 = check.reference_solve(cell, inputs, "cpu",
                                                torch.float64)
    g = check.gaps(cost, plan.unknowns(), ref_cost, ref_x, x0)
    # float32 against float64 after a few outer steps of 10-20 iterations:
    # a few ulp of float32 (the 128 x 128 mesh at 2 x 10 reads about 3e-7 /
    # 3e-6)
    assert g["cost_gap"] < 1e-6
    assert g["x_gap"] < 1e-4
    # and the solve moved the unknowns
    assert all(np.linalg.norm(ref_x[k] - x0[k]) > 0 for k in ref_x)


def test_shift_moves_values_and_fills_zeros():
    v = torch.arange(12.0).view(3, 4, 1)
    s = shift(v, (0, 1))
    assert torch.equal(s[:, :3, 0], v[:, 1:, 0])
    assert torch.equal(s[:, 3, 0], torch.zeros(3))
    s = shift(v, (-1, 0))
    assert torch.equal(s[1:, :, 0], v[:2, :, 0])
    assert torch.equal(s[0, :, 0], torch.zeros(4))
    m = inside((3, 4), (-1, 0), "cpu")
    assert not m[0].any() and m[1:].all()


@pytest.mark.parametrize("name", WORKLOADS)
def test_jacobian_blocks_match_finite_differences(name):
    cell, _ = small_cell(name)
    inputs = window.make_pool(cell, 5)[0]
    en = cell.reference().build(inputs, torch.float64, "cpu")
    g = torch.Generator().manual_seed(0)
    x = en.x0 + 0.1 * torch.randn(en.x0.shape, generator=g,
                                  dtype=torch.float64)
    p = torch.randn(x.shape, generator=g, dtype=torch.float64)
    en.linearize(x)
    # <J^T J p, p> = |J p|^2, and J p against a central difference of the
    # residuals
    jp = en._j(p)
    eps = 1e-6
    for f, v in zip(en.families, jp):
        hi, lo = en._residual(f, x + eps * p), en._residual(f, x - eps * p)
        assert torch.allclose(v, (hi - lo) / (2 * eps), atol=1e-6)
    assert torch.dot(en.jtj(p).flatten(), p.flatten()) == pytest.approx(
        sum(float(torch.sum(v * v)) for v in jp), rel=1e-10)


@pytest.mark.parametrize("name", GRIDS)
def test_assembled_jtj_is_jt_of_j(name):
    """The stencil blocks of J^T J against J^T applied to J p, family by
    family, with excluded points on the grid."""
    cell, _ = small_cell(name)
    inputs = window.make_pool(cell, 7)[0]
    if "Mask" in inputs:
        inputs["Mask"][3:6, 4:9] = 1
    en = cell.reference().build(inputs, torch.float64, "cpu")
    g = torch.Generator().manual_seed(1)
    x = en.x0 + 0.3 * torch.randn(en.x0.shape, generator=g,
                                  dtype=torch.float64)
    p = torch.randn(x.shape, generator=g, dtype=torch.float64)
    en.linearize(x)
    assert torch.allclose(en.jtj(p), en._jt(en._j(p)), rtol=1e-12,
                          atol=1e-12)
