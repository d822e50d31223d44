"""The stream engine's cell (warp2048_gn), with GN and with LM, on the CPU,
at a small grid: there the engine's kernel wrappers run their plain
versions (K4 warp_hat_apply, K5 warp_pipelined_sweep, K2 pcg_update), so
engine="stream" runs the cell's own PCG loop, classic for GN and LM, and
GN's pipelined loop on request.  Also the work the cell
counts, and the readers of the PCG kernels' share and roofline on
hand-built traces."""

import time

import pytest
import torch

from portbench_testlib import bench, small_cell, with_solver
from portbench.benchlib import check, pcg, window
from portbench.benchlib.profile import Trace
from portbench.benchlib.runner import RunRecord, run_cell
from portbench.benchlib.spec import load_cell, reader
from portbench.benchlib.work import bound, cell_calls, peaks_for
from test_portbench_check import answer_altered, half_left_out, \
    state_unchanged

import opt_tpu_torch
from opt_tpu_torch import energies

CELL = "warp2048_gn"
SOLVERS = ("LMGPU", "gaussNewtonGPU")
SEED = 2 ** 31 + 2024
H100 = peaks_for("NVIDIA H100 80GB HBM3")


def _stream_cell(solver, outer=None, pcg_its=None):
    cell, _ = small_cell(CELL, solver=solver)
    if outer:
        cell.config = dict(cell.config, nIterations=outer,
                           lIterations=pcg_its)
    return cell


# (solver kind, outer, PCG iterations, the variant, cost_gap and x_gap
# tolerances).  Why each: float32 against float64 on the stream engine's
# loops.  At 2 x 10 the classic loop (LM) stays within a few ulp of
# float32, as the plain engine does (1.2e-7 / 4.6e-6 over six seeds); the
# pipelined loop's recurrences (GN) carry float32 rounding from one
# iteration to the next and part from classic PCG by up to 9.8e-7 /
# 7.8e-5.  At 2 x 60 the 1,440 unknowns' ill-conditioned hat system has run
# past where float32 resolves its residual: the classic loop reaches
# 6.2e-5 / 3.7e-3 (the plain engine 1.1e-4 / 3.2e-3), the pipelined one
# 9.1e-4 / 2.0e-2; GN on the classic loop at 2 x 101, 3.4e-4 / 2.2e-3.
# The classic rows run the stream engine's default loop, the pipelined
# ones ask for theirs (Plan.stream_variant).  Each tolerance lies 5-10x
# above those worst readings and 10x or more below the reference's own in bfloat16 on the same inputs (GN 9.6e-3
# / 0.22 at 2 x 10, 7.9e-2 / 1.16 at 2 x 60, 0.17 / 1.17 at 2 x 101; LM
# 6.8e-2 / 0.63, 0.27 / 0.99).
TOLERANCES = [
    ("gaussNewtonGPU", 2, 10, "pipelined", 1e-5, 1e-3),
    ("LMGPU", 2, 10, "classic", 1e-6, 1e-4),
    ("gaussNewtonGPU", 2, 60, "pipelined", 5e-3, 0.1),
    ("LMGPU", 2, 60, "classic", 5e-4, 0.03),
    ("gaussNewtonGPU", 2, 101, "classic", 2e-3, 0.02),
]


@pytest.mark.parametrize("solver,outer,its,variant,cost_tol,x_tol",
                         TOLERANCES)
def test_reference_matches_the_stream_engine(solver, outer, its, variant,
                                             cost_tol, x_tol):
    cell = _stream_cell(solver, outer, its)
    inputs = window.make_pool(cell, 2 ** 31 + 99)[1]
    state = opt_tpu_torch.NewState(device="cpu")
    plan = state.problem_plan(
        state.problem_define(getattr(energies, cell.config["energy"]),
                             cell.traffic["solver"]), cell.config["dims"])
    plan.set_solver_parameter("nIterations", outer)
    plan.set_solver_parameter("lIterations", its)
    plan.stream_variant = None if variant == "classic" else variant
    cost = plan.solve(inputs, engine="stream")
    assert (plan.engine, plan.variant) == ("stream", variant)
    ref_cost, ref_x, x0 = check.reference_solve(cell, inputs, "cpu",
                                                torch.float64)
    g = check.gaps(cost, plan.unknowns(), ref_cost, ref_x, x0)
    assert g["cost_gap"] < cost_tol
    assert g["x_gap"] < x_tol
    # and the bfloat16 reference falls outside one of the two
    c, x, _ = check.reference_solve(cell, inputs, "cpu", torch.bfloat16)
    bf = check.gaps(c, x, ref_cost, ref_x, x0)
    assert bf["cost_gap"] > cost_tol or bf["x_gap"] > x_tol


def _run(solver, hook=None):
    return run_cell(_stream_cell(solver), SEED, 0.2, False, "cpu",
                    time.perf_counter(), engine="stream", plan_hook=hook)


@pytest.mark.parametrize("solver", SOLVERS)
def test_stream_cell_sound_run_is_correct(solver):
    r = _run(solver)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) >= {"solve_ms", "setup_s"}


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
def test_stream_cell_fault_is_not_correct(solver, fault):
    r = _run(solver, fault)
    assert not r["correct"]
    assert r["failed"] > 0


# -- the work the cells count ------------------------------------------------

def _calls(solver):
    cell = with_solver(load_cell(bench(), CELL, False), solver)
    calls = cell_calls(cell, H100["l2_bytes"])
    return cell, calls, bound(calls, H100)


def test_work_warp2048_gn_by_hand():
    n = 2048 * 2048
    cell, calls, b = _calls("gaussNewtonGPU")
    assert cell.config["dims"] == [2048, 2048]
    its = [c for c in calls if c[0] == "pcg_iteration"]
    # 6 vectors of 3 words, x and 5 constants: 436 MB, past the 50 MB L2,
    # so each of the 8 x 400 iterations is a call, beside the first cost and
    # each outer step's linearization and update
    assert len(its) == 3200 and len(calls) == 1 + 8 * 2 + 3200
    # an iteration reads p, r, delta, pre (12 words) and what the apply
    # needs (6), writes delta, r, p (9): 108 B a pixel, 453 MB
    assert its[1][1] == n * 27 * 4 == 452_984_832
    assert its[1][2] == n * (160 + 12 * 3)
    # the first reads J^T F and diag instead (6 + 6), the last writes delta
    # alone (3)
    assert its[0][1] == n * (6 + 6 + 9) * 4
    assert its[399][1] == n * (12 + 6 + 3) * 4
    # bound by bytes: 135.2 us an iteration against 12.3 us of operations
    per_it = n * 27 * 4 / 3.35e12
    assert per_it == pytest.approx(135.2e-6, rel=1e-3)
    assert its[1][2] / 67e12 < per_it / 10
    assert pcg.pcg_bound_s(cell, H100) == pytest.approx(
        8 * (398 * per_it + n * (21 + 21) * 4 / 3.35e12), rel=1e-9)
    assert b["bytes_share"] > 0.99


def test_work_warp2048_lm_by_hand():
    """LM on the 2048^2 configuration (no cell: a set of six runs spread
    1.63% of their median, past the 1.6% that a cell needs, PERF.md)."""
    n = 2048 * 2048
    cell, calls, _ = _calls("LMGPU")
    its = [c for c in calls if c[0] == "pcg_iteration"]
    assert len(its) == 3200
    # LM also reads ctc and b: 33 words, 132 B a pixel, 554 MB
    assert its[1][1] == n * 33 * 4 == 553_648_128
    # every 10th iteration adds the residual reset's apply (160)
    assert its[9][2] == n * (196 + 160)
    assert its[8][2] == n * 196
    model = [c for c in calls if c[0] == "model_cost"]
    assert len(model) == 8


# -- the readers -------------------------------------------------------------

US = 1000  # ns


def _pcg_trace(solves=2):
    """Each solve: K5 [0, 300] us, K4 [300, 500], K2 [500, 600], torch's
    sum [600, 700], a K3 [700, 800], an HtoD copy [800, 1000]; the solves
    1 ms apart."""
    rows = [("void (anonymous namespace)::warp_pipelined_sweep_kernel"
             "(float const*)", 0, 300, "kernel"),
            ("void (anonymous namespace)::warp_hat_apply_kernel(float "
             "const*)", 300, 200, "kernel"),
            ("pcg_update_kernel(float const*)", 500, 100, "kernel"),
            ("void at::native::reduce_kernel<512, 1>", 600, 100, "kernel"),
            ("void (anonymous namespace)::warp_linearize_march<0>", 700,
             100, "kernel"),
            ("Memcpy HtoD (Pageable -> Device)", 800, 200, "h2d")]
    device = [(n, (1000 * i + s) * US, d * US, k) for i in range(solves)
              for n, s, d, k in rows]
    return Trace(solves, 0.002, device, [])


def _record(trace, work=True, cell=None):
    """A run's record of warp2048_gn (or `cell`) on an H100."""
    cell = cell or load_cell(bench(), CELL, True)
    return RunRecord(1.0, [], 1.0, trace, {"seconds": 1.0} if work else None,
                     cell, H100 if work else None)


@pytest.mark.parametrize("solves", [1, 2])
def test_pcg_share_reads_the_named_kernels(solves):
    tr = _pcg_trace(solves)
    names = pcg.kernel_names(load_cell(bench(), CELL, True))
    assert names == ("warp_pipelined_sweep", "warp_hat_apply", "pcg_update")
    # 600 us of the PCG's kernels in 800 us of kernels (the copy is none)
    assert pcg.share_pct(tr, names) == pytest.approx(75.0)
    assert reader("pcg_kernel_share_pct")(_record(tr)) == pytest.approx(75.0)


def test_pcg_roofline_reads_the_loops_bound():
    tr = _pcg_trace(2)
    cell = load_cell(bench(), CELL, True)
    assert cell.name == "warp2048_gn" and not cell.lm
    want = 100.0 * pcg.pcg_bound_s(cell, H100) / 600e-6
    names = pcg.kernel_names(cell)
    assert pcg.roofline_pct(tr, names, cell, H100) == pytest.approx(want)
    assert reader("pcg_kernel_roofline_pct")(_record(tr)) == pytest.approx(
        want)


@pytest.mark.parametrize("metric", ["pcg_kernel_share_pct",
                                    "pcg_kernel_roofline_pct"])
def test_pcg_readers_are_none_without_rows_work_or_cell(metric):
    read = reader(metric)
    tr = _pcg_trace()
    # no trace, or a record that names no cell
    assert read(_record(None)) is None
    rec = _record(tr)
    rec.cell = None
    assert read(rec) is None
    # no row of the PCG's kernels (a program that launched none of them)
    names = pcg.kernel_names(load_cell(bench(), CELL, True))
    tr.device = [ev for ev in tr.device if not pcg.is_pcg(ev[0], names)]
    assert read(_record(tr)) is None
    # a run with no work bound (not on a card): the roofline reads none
    if metric == "pcg_kernel_roofline_pct":
        assert read(_record(_pcg_trace(), work=False)) is None


@pytest.mark.parametrize("metric", ["pcg_kernel_share_pct",
                                    "pcg_kernel_roofline_pct"])
def test_pcg_readers_read_the_records_cell_whatever_the_command_line(
        metric, monkeypatch):
    """The readers give the same inside and outside run.py: the command
    line is not read, the record's cell is."""
    read = reader(metric)
    want = read(_record(_pcg_trace()))
    assert want is not None
    for argv in (["pytest"], ["portbench/run.py", "--workload", "warp512_gn",
                              "--seed", "7", "--seconds", "51"]):
        monkeypatch.setattr("sys.argv", argv)
        assert read(_record(_pcg_trace())) == want
