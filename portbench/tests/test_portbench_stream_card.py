"""The stream engine's cell (warp2048_gn), with GN and with LM, on the card,
at its full size (marked `card`; skips without one):

    python3 -m pytest -c portbench/pytest.ini portbench/tests -m card

The float64 reference at 2048^2 reproduces the JAX package's recorded
final costs; one solve of each solver kind through engine="auto" runs the
stream engine's variant with exactly its launch counts and its kernels'
spans inside opt.pcg; and a traced solve of the cell keeps the spans off
the device track, with the PCG's kernels most of its kernel time."""

import math

import pytest
import torch

from portbench_testlib import bench, with_solver
from portbench.benchlib import check, pcg, spans, window
from portbench.benchlib.profile import trace
from portbench.benchlib.spec import load_cell, reader
from test_portbench_spans import SPAN_METRICS, _run as _record

pytestmark = pytest.mark.card

CELL = "warp2048_gn"

COST_RTOL = 2e-4
# the JAX package's final costs on seed 0 at 2048^2 with 8 outer x 100 PCG
# iterations, not the cells' 400 (chip_smoke.py PATHS: float32 CPU solves)
JAX_CPU_FINAL_COST_8X100 = {
    "gaussNewtonGPU": 129813.453125,
    "LMGPU": 129824.890625,
}

# (engine, variant, launches a solve by counter; every other counter 0):
# both classic (stream_cuda.pick_variant), a K4 and a K2 an iteration, and in
# LM a K4 for each of the 40 residual resets an outer step; K3 for the
# first cost and each outer step's linearization and cost, and LM's model
# cost
PATHS = {
    "gaussNewtonGPU": ("stream", "classic",
                       {"K4.warp_hat_apply": 3200, "K2.pcg_update": 3200,
                        "K3.warp_linearize": 17}),
    "LMGPU": ("stream", "classic",
              {"K4.warp_hat_apply": 3520, "K2.pcg_update": 3200,
               "K3.warp_linearize": 25}),
}
PCG_SPANS = ("opt.kernel.K4.", "opt.kernel.K5.", "opt.kernel.K2.")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("solver", sorted(JAX_CPU_FINAL_COST_8X100))
def test_reference_reproduces_jax_constants_at_2048(card, solver):
    cell = with_solver(load_cell(bench(), CELL, False), solver)
    cell.config = dict(cell.config, lIterations=100)
    inputs = cell.energy().inputs(cell.config["dims"], 0)
    cost, _, _ = check.reference_solve(cell, inputs, card, torch.float64)
    want = JAX_CPU_FINAL_COST_8X100[solver]
    print(f"{solver}: reference {cost!r}, JAX {want!r}, "
          f"rel {abs(cost - want) / want:.3e}")
    assert abs(cost - want) / want < COST_RTOL


def _within(ivs, s, e):
    return any(a <= s and e <= b for a, b in ivs)


@pytest.mark.parametrize("solver", sorted(PATHS))
def test_cell_path_runs_its_launches_and_spans(card, solver):
    from opt_tpu_torch.runtime.trace import LAUNCHES

    engine, variant, want = PATHS[solver]
    cell = with_solver(load_cell(bench(), CELL, False), solver)
    loop = window.Loop(window.new_plan(cell, card),
                       window.make_pool(cell, 2 ** 31 + 11))
    loop.solve()
    before = dict(LAUNCHES)
    _, cost = loop.solve()
    got = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    assert (loop.plan.engine, loop.plan.variant) == (engine, variant)
    assert math.isfinite(cost)
    assert got == want
    tr = trace(torch, loop.solve, 1)
    pcg_ivs = spans.intervals(tr, lambda n: n == "opt.pcg")
    assert len(pcg_ivs) == cell.config["nIterations"]
    kernel_spans = [(n, s, e) for n, s, e in tr.host
                    if n.startswith(PCG_SPANS)]
    # each launch's wrapper span, and every one inside an opt.pcg
    assert len(kernel_spans) == sum(
        v for k, v in want.items() if not k.startswith("K3."))
    assert all(_within(pcg_ivs, s, e) for _, s, e in kernel_spans)


def test_traced_stream_solve_keeps_spans_off_the_device_track(card):
    """warp2048_gn at its own size: no device event is named after a span,
    every span metric reads a finite value, the idle time the bind and the
    loop spans see lies within the idle time of their solves, and the
    PCG's kernels take most of the kernel time."""
    cell = load_cell(bench(), CELL, True)
    loop = window.Loop(window.new_plan(cell, card),
                       window.make_pool(cell, 2 ** 31 + 7))
    loop.solve()
    tr = trace(torch, loop.solve, 2)
    assert loop.plan.engine == "stream"
    assert tr.device
    assert not [n for n, _, _, _ in tr.device if n.startswith("opt.")]
    run = _record(tr)
    got = {m: reader(m)(run) for m in SPAN_METRICS}
    share = pcg.share_pct(tr, pcg.kernel_names(cell))
    print("warp2048_gn", got, "pcg share", share)
    assert all(v is not None and math.isfinite(v) for v in got.values())
    solve_idle = spans.idle_ms_per_solve(tr, lambda n: n == "opt.solve")
    assert got["bind_idle_ms"] + got["loop_idle_ms"] <= solve_idle + 1e-9
    assert share >= 75
