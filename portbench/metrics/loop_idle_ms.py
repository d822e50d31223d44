"""loop_idle_ms: ms a traced solve of the opt.init and opt.step spans'
intervals in which no device event runs: the device starved while the
host issued the solver loop."""

from portbench.benchlib.spans import idle_ms_per_solve

LOOP = ("opt.init", "opt.step")


def read(run):
    if run.trace is None:
        return None
    return idle_ms_per_solve(run.trace, lambda name: name in LOOP)
