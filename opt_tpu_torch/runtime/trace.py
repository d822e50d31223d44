"""Tracing of opt_tpu_torch: spans, the launch counter and the phase table.
Nothing else in the package traces or times itself.

Spans.  `with span(name):` marks a stretch of host work.  Every name starts
with "opt.", and a solve's spans nest inside its one opt.solve on the
calling thread:

  opt.solve        Plan.solve, on one device or over a mesh
    opt.bind       the engine pick, bind's conversions and copies, and the
                   operator build (Plan._bind_engine, parallel/dispatch.py)
    opt.init       the initial cost (solver/core.py init_fn)
    opt.step       one outer step (solver/core.py step_fn), holding
      opt.linearize  op.outer and the preconditioner built from it
      opt.pcg        the pcg_backend, or the PCG loop; no span inside it
      opt.update     the new x, its cost and LM's accept or reject
    opt.read       final_cost's host read, where the host waits for the
                   device
  opt.kernel.<K>.<name>  each kernel wrapper of ops/, named after its row
                   in PERF.md's kernel table (K1-K16), on its CUDA launch
                   and its plain CPU path alike

While torch.profiler records on the calling thread, a span is a CPU op
range (torch._C._profiler._RecordFunctionFast) on the host track of
the profiler's trace, on the clock of its device events.  It is not a user
annotation (torch.profiler.record_function), so the profiler mirrors
nothing of it onto the device track.  It is no dispatcher op either, so
make_fx does not trace it into a graph.  With no profiler recording and no
phase table on, span() returns one shared no-op object.

The launch counter.  LAUNCHES maps "<K>.<name>" to the CUDA kernel
launches of that kernel in this process.  A wrapper adds one after each
launch whose return code it has checked, and nothing on its plain CPU
path; a wrapper that launches two kernels (K11) adds one to each.  K9 and
K10 run as torch.library operators: torch.func.linearize's replay of its
traced J p calls them through the dispatcher, which runs their Python
body, so each replayed launch is counted, inside its span.

The phase table (collect_kernel_timing): the reference's aggregated
timing report (API/src/backend_cpu.t:202-312, backend_cuda.t:152-299),
fed by the spans opt.bind, opt.init, opt.step and opt.solve as the rows
bind, init, step_N and solve.  On a CUDA device a row is timed by a pair
of CUDA events recorded at the span's entry and exit, resolved once the
solve's last event has completed; nothing inside a phase synchronizes.
On the CPU a row is the host clock's.
"""

from __future__ import annotations

import functools
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled as _profiling
from torch._C._profiler import _RecordFunctionFast


class Launches(dict):
    """name -> CUDA kernel launches: one entry a kernel, registered once
    by the module whose wrapper launches it."""

    def register(self, name):
        if name in self:
            raise ValueError(f"launch counter {name!r} registered twice")
        self[name] = 0


LAUNCHES = Launches()


class _Off:
    """The span of an untraced call: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()
_tables = 0  # phase tables switched on, on any thread
_tables_lock = threading.Lock()
_local = threading.local()  # .table: the phase table spans feed here


def _table():
    return getattr(_local, "table", None)


class _Span:
    __slots__ = ("name", "_range", "_table", "_row")

    def __init__(self, name):
        self.name = name
        self._range = self._table = self._row = None

    def __enter__(self):
        table = _table() if _tables else None
        if table is not None:
            self._row = table.enter(self.name)
            if self._row is not None:
                self._table = table
        if _profiling():
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._table is not None:
            self._table.exit(self._row)
        return False


def span(name):
    """A context manager around host work named `name` (see the module's
    docstring); OFF where nothing records it."""
    if _tables or _profiling():
        return _Span(name)
    return OFF


def kernel(tag, counts=True):
    """Decorator of a kernel wrapper: each call runs inside the span
    opt.kernel.<tag>.  counts registers LAUNCHES[tag], which the wrapper
    adds to after each launch."""
    name = "opt.kernel." + tag
    if counts:
        LAUNCHES.register(tag)

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not (_tables or _profiling()):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


class PhaseTable:
    """The reference's timing table, one row a phase span (the module's
    docstring).  enabled False: the table records nothing."""

    ROWS = {"opt.bind": "bind", "opt.init": "init", "opt.step": "step",
            "opt.solve": "solve"}

    def __init__(self, enabled, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.records = {}  # row -> [count, total_ms]
        self.order = []
        self.pending = []  # (row, start event, end event) not yet read
        self.step = 0  # the row number of the next opt.step

    def on(self):
        """A context manager that feeds this table the calling thread's
        phase spans while it is open (OFF where the table is disabled)."""
        return _Feeding(self) if self.enabled else OFF

    def enter(self, name):
        row = self.ROWS.get(name)
        if row is None:
            return None
        if row == "init":
            self.step = 0
        elif row == "step":
            row = f"step_{self.step}"
            self.step += 1
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            return row, start
        return row, time.perf_counter()

    def exit(self, token):
        row, start = token
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.pending.append((row, start, end))
        else:
            self._add(row, (time.perf_counter() - start) * 1e3)

    def _add(self, row, ms):
        rec = self.records.get(row)
        if rec is None:
            self.records[row] = [1, ms]
            self.order.append(row)
        else:
            rec[0] += 1
            rec[1] += ms

    def resolve(self):
        """Fold the CUDA events recorded so far into the rows, once the
        last of them has completed."""
        if not self.pending:
            return
        self.pending[-1][2].synchronize()
        for row, start, end in self.pending:
            self._add(row, start.elapsed_time(end))
        self.pending = []

    def evaluate(self, out=print):
        """Print the aggregated table (backend_cpu.t:245-312 format)."""
        self.resolve()
        if not self.records:
            return
        out("--------------------------------------------------------")
        out(f"{'Kernel':<40}{'Count':>8}{'Total(ms)':>12}{'Average(ms)':>14}")
        out("--------------------------------------------------------")
        for name in self.order:
            c, t = self.records[name]
            out(f"{name:<40}{c:>8}{t:>12.3f}{t / c:>14.4f}")
        out("--------------------------------------------------------")
        steps = [n for n in self.order if n.startswith("step_")]
        overall = sum(self.records[n][1] for n in steps)
        out(
            "TIMING "
            + " ".join(
                f"{name}={self.records[name][1]:.3f}" for name in self.order
            )
        )
        if steps:
            out(
                f"Per-iter times ms (nonlinear): {overall / len(steps):.3f}"
            )


class _Feeding:
    """PhaseTable.on()'s context: installs the table on this thread."""

    __slots__ = ("table", "_prev")

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        global _tables
        self._prev = _table()
        _local.table = self.table
        with _tables_lock:
            _tables += 1
        return self

    def __exit__(self, *exc):
        global _tables
        _local.table = self._prev
        with _tables_lock:
            _tables -= 1
        return False
