"""bind_ms: host ms a traced solve inside the program's opt.bind span
(Plan._bind_engine: the engine pick, bind's conversions and copies, the
operator build), from the profiler's host track."""

from portbench.benchlib.spans import host_ms_per_solve


def read(run):
    if run.trace is None:
        return None
    return host_ms_per_solve(run.trace, lambda name: name == "opt.bind")
