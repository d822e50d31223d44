"""device_idle_pct: 100 x (1 - the device's busy time a traced solve (any
kernel, copy or memset) / solve_ms of the same run's untraced window)."""


def read(run):
    tr = run.trace
    if tr is None or not run.solves:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    solve_s = run.elapsed_s / len(run.solves)
    return 100.0 * (1.0 - busy / tr.solves / solve_s)
