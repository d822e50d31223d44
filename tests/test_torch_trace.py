"""runtime/trace.py: the spans of a solve under torch.profiler, the launch
counter and the phase table, on the CPU."""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
import opt_tpu_torch
from opt_tpu_torch import energies
from opt_tpu_torch.ops import (  # noqa: F401  (each registers its counters)
    graph_cuda, halo_stencil, pcg_update, poisson_cuda, slab_cuda,
    stream3d_cuda, stream_cuda, vol_cuda, warp_cuda)
from opt_tpu_torch.runtime import trace
from opt_tpu_torch.runtime.trace import LAUNCHES, PhaseTable, span

torch.set_num_threads(1)

OPS = Path(opt_tpu_torch.__file__).parent / "ops"
N_OUTER, N_LINEAR = 2, 4
# every kernel of PERF.md's table, with K3's and K8's slab modes and K11's
# two passes
COUNTERS = {
    "K1.warp_jtj_apply", "K2.pcg_update", "K3.warp_linearize",
    "K3.warp_slab_linearize", "K4.warp_hat_apply", "K5.warp_pipelined_sweep",
    "K6.vol_hat_apply", "K7.vol_pipelined_sweep", "K8.vol_linearize",
    "K8.vol_slab_linearize", "K9.graph_gather", "K10.graph_scatter",
    "K11.graph_hat_edge", "K11.graph_hat_vertex", "K12.poisson_cg",
    "K13.resident_pcg", "K14.stencil_apply", "K15.warp_slab_apply",
    "K16.vol_slab_apply"}


def _plan(**state):
    st = opt_tpu_torch.NewState(device="cpu", **state)
    plan = st.problem_plan(st.problem_define(energies.image_warping), [8, 6])
    plan.set_solver_parameter("nIterations", N_OUTER)
    plan.set_solver_parameter("lIterations", N_LINEAR)
    return plan


def _traced_solve(engine):
    """(final cost, [(name, start_ns, end_ns, thread, user annotation)])
    of one 8x6 image_warping solve under torch.profiler."""
    plan = _plan()
    inputs = chip_smoke.warp_inputs(8, 6, seed=5)
    plan.solve(inputs, engine=engine)  # the first call's set-up untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cost = plan.solve(inputs, engine=engine)
    events = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return cost, events


def _tree(events):
    """The opt.* spans as nested [name, start, end, children]."""
    roots, stack = [], []
    for name, s, e, _, _ in sorted(
            (ev for ev in events if ev[0].startswith("opt.")),
            key=lambda ev: (ev[1], -ev[2])):
        node = [name, s, e, []]
        while stack and stack[-1][2] < e:
            stack.pop()
        (stack[-1][3] if stack else roots).append(node)
        stack.append(node)
    return roots


def _names(nodes, kernels=False):
    return [n[0] for n in nodes
            if kernels or not n[0].startswith("opt.kernel.")]


def _kernel_spans(node, parent=None):
    """(kernel span, its nearest enclosing span that is no kernel's)."""
    for child in node[3]:
        if child[0].startswith("opt.kernel."):
            yield child[0], parent or node[0]
            yield from _kernel_spans(child, parent or node[0])
        else:
            yield from _kernel_spans(child)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_solve_span_tree(engine):
    """One opt.solve holds opt.bind, opt.init, nIterations opt.step (each
    opt.linearize, opt.pcg, opt.update) and opt.read; on the cuda engine
    the wrappers' spans (K3, K13) lie inside the solver's phases."""
    _, events = _traced_solve(engine)
    roots = _tree(events)
    assert _names(roots) == ["opt.solve"]
    solve = roots[0]
    assert _names(solve[3]) == (["opt.bind", "opt.init"]
                                + ["opt.step"] * N_OUTER + ["opt.read"])
    for step in solve[3]:
        if step[0] == "opt.step":
            assert _names(step[3]) == ["opt.linearize", "opt.pcg",
                                       "opt.update"]
    kernels = list(_kernel_spans(solve))
    if engine == "torch":
        assert not kernels
        return
    assert {k for k, _ in kernels} == {"opt.kernel.K3.warp_linearize",
                                       "opt.kernel.K13.resident_pcg"}
    assert {p for _, p in kernels} <= {"opt.init", "opt.linearize",
                                       "opt.pcg", "opt.update"}
    assert [p for k, p in kernels if "K13" in k] == ["opt.pcg"] * N_OUTER
    # K3: the initial cost, then each step's linearize and new cost
    assert len(kernels) == N_OUTER + 1 + 2 * N_OUTER


def test_spans_are_no_user_annotations():
    """A span is a CPU op range, not a user annotation: the profiler
    mirrors user annotations onto the device track, and these never."""
    _, events = _traced_solve("cuda")
    spans = [ev for ev in events if ev[0].startswith("opt.")]
    assert len(spans) > 5 * N_OUTER
    assert not any(ev[4] for ev in spans)


def test_spans_nest_around_the_aten_ops_on_one_clock():
    """The aten ops of the solve lie inside its spans, on the same clock
    and thread: each op that starts inside a span ends inside it, and each
    outer step holds ops of its own."""
    _, events = _traced_solve("torch")
    spans = [ev for ev in events if ev[0].startswith("opt.")]
    ops = [ev for ev in events if ev[0].startswith("aten::")]
    for name, s, e, tid, _ in spans:
        inside = [op for op in ops if s <= op[1] < e and op[3] == tid]
        assert all(op[2] <= e for op in inside), name
        if name in ("opt.step", "opt.linearize", "opt.update"):
            assert inside, name
    solve = next(ev for ev in spans if ev[0] == "opt.solve")
    assert all(solve[1] <= ev[1] and ev[2] <= solve[2] for ev in spans
               if ev[0] != "opt.solve")


def test_a_traced_jp_replay_runs_each_gather_in_its_span():
    """torch.func.linearize's replay calls K9 through the dispatcher, which
    runs graph_gather's Python body: its span (and on the card its count)
    comes with every replayed gather."""
    st = opt_tpu_torch.NewState(device="cpu")
    w = 19
    plan = st.problem_plan(
        st.problem_define(energies.arap_mesh_deformation, "gaussNewtonGPU"),
        [w * w, len(chip_smoke.tri_grid_graph(w, w)[0])])
    x, data = plan.bind(chip_smoke.arap_inputs(w, seed=4))
    _, jvp, _ = plan.funcs.linearize(plan.layout.views(x), data)
    p = plan.layout.views(torch.randn(x.numel(), generator=torch.Generator(
    ).manual_seed(0)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        jvp(p)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    ops = names.count("opt_tpu_torch::graph_gather")
    assert ops > 0
    assert names.count("opt.kernel.K9.graph_gather") == ops


def test_span_is_the_shared_noop_when_nothing_records():
    assert span("opt.solve") is trace.OFF
    assert span("opt.kernel.K1.warp_jtj_apply") is trace.OFF
    with span("opt.step") as s:
        assert s is trace.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("opt.solve") is not trace.OFF
    table = PhaseTable(True, "cpu")
    with table.on():
        assert span("opt.solve") is not trace.OFF
    assert span("opt.solve") is trace.OFF
    assert PhaseTable(False, "cpu").on() is trace.OFF


def _ops_sources():
    return {p.name: p.read_text() for p in sorted(OPS.glob("*.py"))}


def test_each_wrapper_counts_under_a_name_of_its_own():
    """Every counter is registered once, by one wrapper's @kernel, under
    "<K>.<name>"; each launch site adds to a registered counter; a second
    registration raises."""
    assert set(LAUNCHES) == COUNTERS
    tags, sites = [], set()
    for src in _ops_sources().values():
        tags += re.findall(r'^@kernel\("([^"]+)"\)', src, re.M)
        sites |= set(re.findall(r'LAUNCHES\["([^"]+)"\] \+= 1', src))
    assert len(tags) == len(set(tags))
    assert set(tags) == COUNTERS
    assert sites == COUNTERS
    assert all(re.fullmatch(r"K\d+\.\w+", k) for k in COUNTERS)
    with pytest.raises(ValueError, match="registered twice"):
        LAUNCHES.register("K13.resident_pcg")
    # no wrapper keeps a counter of its own
    assert not any(".launches" in src for src in _ops_sources().values())


@pytest.mark.parametrize("engine", ["cuda", "stream"])
def test_the_plain_cpu_path_counts_nothing(engine):
    """On CPU tensors the wrappers run their plain versions and count no
    launch, though their spans run."""
    before = dict(LAUNCHES)
    plan = _plan()
    plan.solve(chip_smoke.warp_inputs(8, 6, seed=6), engine=engine)
    assert dict(LAUNCHES) == before


def test_phase_table_has_a_bind_row_and_never_synchronizes(monkeypatch,
                                                           capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("a phase synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    plan = _plan(collect_kernel_timing=True)
    plan.solve(chip_smoke.warp_inputs(8, 6, seed=7), engine="cuda")
    out = capsys.readouterr().out
    timing = next(line for line in out.splitlines()
                  if line.startswith("TIMING "))
    rows = [kv.split("=")[0] for kv in timing.split()[1:]]
    assert rows == (["bind", "init"] + [f"step_{i}" for i in range(N_OUTER)]
                    + ["solve"])
    assert plan.timer.records["bind"][0] == 1
    assert not plan.timer.pending


class _Event:
    """A stand-in for torch.cuda.Event: its time is its place in the
    order of records."""

    clock = 0
    synced = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        _Event.clock += 1
        self.at = _Event.clock

    def synchronize(self):
        _Event.synced.append(self.at)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_phase_table_times_cuda_rows_by_events(monkeypatch):
    """On a CUDA device each row is a pair of CUDA events recorded at the
    span's entry and exit; the table waits once, on the last event, when
    it is read."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(_Event, "synced", [])
    table = PhaseTable(True, "cuda")
    with table.on():
        with span("opt.solve"):
            with span("opt.bind"):
                pass
            with span("opt.init"):
                pass
            for _ in range(2):
                with span("opt.step"), span("opt.pcg"):
                    pass
    assert _Event.synced == []
    lines = []
    table.evaluate(out=lines.append)
    assert _Event.synced == [_Event.clock]
    timing = next(line for line in lines if line.startswith("TIMING "))
    assert timing == ("TIMING bind=1.000 init=1.000 step_0=1.000 "
                      "step_1=1.000 solve=9.000")
