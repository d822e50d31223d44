"""pcg_kernel_roofline_pct: the inner PCG loops' work bound a solve
(benchlib/work.py's pcg_ calls: the function's work at the card's
published peaks) over the device time of the kernels that run them
(benchlib/pcg.py's PCG_KERNELS for the cell's energy) a traced solve, in
%."""

from portbench.benchlib import pcg
from portbench.benchlib.work import peaks_for


def read(run):
    if run.trace is None or run.work is None:
        return None
    cell = pcg.run_cell_of()
    if cell is None:
        return None
    import torch

    return pcg.roofline_pct(run.trace, pcg.kernel_names(cell), cell,
                            peaks_for(torch.cuda.get_device_name()))
