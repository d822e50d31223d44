"""kernel_roofline_pct: the solve's work bound (benchlib/work.py: the work
the algorithm needs at the card's published peaks) over the time the
device ran kernels a traced solve, in %."""


def read(run):
    tr = run.trace
    if tr is None or run.work is None:
        return None
    busy = tr.busy_s({"kernel"})
    if busy <= 0:
        return None
    return 100.0 * run.work["seconds"] * tr.solves / busy
