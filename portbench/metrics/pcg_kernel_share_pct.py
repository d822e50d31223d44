"""pcg_kernel_share_pct: 100 x the device time of the kernels that run the
inner PCG loop (the cell's energy's PCG_KERNELS, benchlib/pcg.py) over all
kernel time, a traced solve: how much of the device's work the loop's
kernels do."""

from portbench.benchlib import pcg


def read(run):
    if run.trace is None or run.cell is None:
        return None
    return pcg.share_pct(run.trace, pcg.kernel_names(run.cell))
