"""On the card (marked `card`; skips without one):

    python3 -m pytest portbench/tests -m card

The float64 reference on the generators' seed-0 inputs at the cells' full
sizes reproduces the JAX package's recorded final costs (its CPU solves,
copied from chip_smoke.py, within that file's COST_RTOL)."""

import pytest
import torch

from portbench_testlib import bench, with_solver
from portbench.benchlib import check
from portbench.benchlib.spec import load_cell

pytestmark = pytest.mark.card

COST_RTOL = 2e-4
# the JAX package's final costs on seed 0 (chip_smoke.py: 512^2 GN and LM
# 8x400 in float32, 128^3 GN and LM 8x100 in float64)
JAX_CPU_FINAL_COST = {
    ("warp512_gn", "gaussNewtonGPU"): 8170.7724609375,
    ("warp512_gn", "LMGPU"): 8171.9326171875,
    ("vol128_gn", "gaussNewtonGPU"): 52.12877722531129,
    ("vol128_gn", "LMGPU"): 52.1739656981525,
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("name,solver", sorted(JAX_CPU_FINAL_COST))
def test_reference_reproduces_jax_constants(card, name, solver):
    cell = with_solver(load_cell(bench(), name, False), solver)
    inputs = cell.energy().inputs(cell.config["dims"], 0)
    cost, _, _ = check.reference_solve(cell, inputs, card, torch.float64)
    want = JAX_CPU_FINAL_COST[name, solver]
    print(f"{name}: reference {cost!r}, JAX {want!r}, "
          f"rel {abs(cost - want) / want:.3e}")
    assert abs(cost - want) / want < COST_RTOL
