"""solve_ms_p95: the 95th percentile of the wall times of all solves in the
window (host clock), in ms, linear between order statistics."""

import numpy as np


def read(run):
    if not run.solves:
        return None
    return 1e3 * float(np.percentile([s.wall_s for s in run.solves], 95))
