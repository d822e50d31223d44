"""bind_idle_ms: ms a traced solve of the opt.bind span's interval in which
no device event (kernel, copy or memset) runs: the device waiting on the
bind."""

from portbench.benchlib.spans import idle_ms_per_solve


def read(run):
    if run.trace is None:
        return None
    return idle_ms_per_solve(run.trace, lambda name: name == "opt.bind")
