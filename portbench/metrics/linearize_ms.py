"""linearize_ms: host ms a traced solve inside the solver's opt.linearize
spans (solver/core.py: each outer step's op.outer and preconditioner; on
the graph engine the vjp for J^T F, the leaf partials on K9 and K10 and the
diagonal), from the profiler's host track."""

from portbench.benchlib.spans import host_ms_per_solve


def read(run):
    if run.trace is None:
        return None
    return host_ms_per_solve(run.trace, lambda name: name == "opt.linearize")
