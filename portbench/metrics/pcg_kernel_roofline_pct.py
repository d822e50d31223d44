"""pcg_kernel_roofline_pct: the inner PCG loops' work bound a solve
(benchlib/work.py's pcg_ calls: the function's work at the card's
published peaks) over the device time of the kernels that run them (the
cell's energy's PCG_KERNELS, benchlib/pcg.py) a traced solve, in %."""

from portbench.benchlib import pcg


def read(run):
    if run.trace is None or run.cell is None or run.peaks is None:
        return None
    return pcg.roofline_pct(run.trace, pcg.kernel_names(run.cell), run.cell,
                            run.peaks)
