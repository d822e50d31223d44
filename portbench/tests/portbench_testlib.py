"""Helpers of the benchmark's tests: small cells on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.benchlib.spec import load_cell, read_json  # noqa: E402


# cells whose files portbench/ holds but BENCHMARK.json does not run: the
# entries that would add each to it, for the tests.  arap262k_gn's runs
# spread past half of the solve_ms bound (PERF.md section 7).
HELD = {
    "configs": [{"name": "arap_mesh_262k",
                 "file": "portbench/configs/arap_mesh_262k.json"}],
    "workloads": [{"name": "arap262k_gn", "config": "arap_mesh_262k",
                   "traffic": "arap_gn", "chips": 1}],
}


def bench(held=False):
    """BENCHMARK.json, with the held cells' entries where held is true."""
    b = read_json(ROOT / "BENCHMARK.json")
    if held:
        for key, entries in HELD.items():
            b[key] = b[key] + entries
    return b


def with_solver(cell, solver):
    """The cell with its traffic's solver kind replaced."""
    cell.traffic = dict(cell.traffic, solver=solver)
    return cell


def small_cell(name, trace=False, solver=None):
    """The cell `name` of BENCHMARK.json at its energy's small size (with
    another solver kind, if given), and the engine to run it with on the
    CPU, on CPU tensors, where the engine's kernels run their plain
    versions."""
    cell = load_cell(bench(held=True), name, trace)
    if solver:
        with_solver(cell, solver)
    small = cell.energy().SMALL
    cell.config = dict(cell.config, dims=list(small["dims"]),
                       nIterations=small["outer"], lIterations=small["pcg"])
    return cell, small["engine"]
