"""Helpers of the benchmark's tests: small cells on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.benchlib.spec import load_cell, read_json  # noqa: E402

# a size at which each cell runs in a test: (dims, outer, PCG, engine on
# CPU tensors, which runs the kernels' plain versions)
SMALL = {
    "image_warping": ([24, 20], 2, 10, "cuda"),
    "volumetric_mesh_deformation": ([10, 10, 10], 3, 20, "stream3d"),
}


def bench():
    return read_json(ROOT / "BENCHMARK.json")


def with_solver(cell, solver):
    """The cell with its traffic's solver kind replaced."""
    cell.traffic = dict(cell.traffic, solver=solver)
    return cell


def small_cell(name, trace=False, solver=None):
    """The cell `name` of BENCHMARK.json at its small size (with another
    solver kind, if given), and the engine to run it with on the CPU."""
    cell = load_cell(bench(), name, trace)
    if solver:
        with_solver(cell, solver)
    dims, outer, pcg, engine = SMALL[cell.config["energy"]]
    cell.config = dict(cell.config, dims=dims, nIterations=outer,
                       lIterations=pcg)
    return cell, engine
