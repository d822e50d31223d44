"""graph_apply_roofline_pct: K11's share of its roofline.  The PCG
applies' work bound a solve (benchlib/work.py: one hat-space apply's
function work, p, the scaling and what J^T J p reads in and A_hat p out,
the edges' indices but not the partials a kernel materializes, times the
applies a solve makes) over the device time of the energy's APPLY_KERNELS
(the graph engine's graph_hat_edge and graph_hat_vertex rows) a traced
solve, in %."""

from portbench.benchlib import pcg


def read(run):
    if run.trace is None or run.cell is None or run.peaks is None:
        return None
    return pcg.apply_roofline_pct(run.trace, run.cell, run.peaks)
