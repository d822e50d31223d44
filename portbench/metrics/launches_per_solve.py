"""launches_per_solve: kernels the device ran a traced solve, the port's
and torch's alike (every profiler device row that is not a copy or a
memset)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("kernel"):
        return None
    return tr.count("kernel") / tr.solves
