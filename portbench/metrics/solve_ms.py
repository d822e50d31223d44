"""solve_ms: the window's length, from its start to the end of its last
solve, over the solves it completed (host clock), in ms."""


def read(run):
    if not run.solves:
        return None
    return 1e3 * run.elapsed_s / len(run.solves)
