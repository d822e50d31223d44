"""h2d_ms: the device's time in host-to-device copies (the profiler's
Memcpy HtoD rows) a traced solve, in ms: Plan.bind's copy of the inputs."""


def read(run):
    tr = run.trace
    if tr is None or not tr.count("h2d"):
        return None
    return 1e3 * tr.seconds("h2d") / tr.solves
