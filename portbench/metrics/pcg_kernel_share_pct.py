"""pcg_kernel_share_pct: 100 x the device time of the kernels that run the
inner PCG loop (benchlib/pcg.py's PCG_KERNELS for the cell's energy) over
all kernel time, a traced solve: how much of the device's work the loop's
kernels do."""

from portbench.benchlib import pcg


def read(run):
    cell = pcg.run_cell_of() if run.trace is not None else None
    if cell is None:
        return None
    return pcg.share_pct(run.trace, pcg.kernel_names(cell))
