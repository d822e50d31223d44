"""The inner PCG loop's kernels in a traced run: which device rows they are,
their device time a traced solve, and the work the loop needs a solve.

PCG_KERNELS names, by energy, the kernels that run the inner PCG on the
engine its cells take; a device row is one of them where its name holds
one of the names.  A later cell whose energy runs other kernels adds its
own entry.

The readers learn their cell from the run's own command line (run.py's
--workload), the one thing that names it in the process that reads them.
"""

from __future__ import annotations

import argparse
import sys

from .profile import union_s
from .work import bound, cell_calls

PCG_KERNELS = {
    # the stream engine (ops/stream_cuda.py): K5 the pipelined sweep (GN),
    # K4 the hat apply (w_0 for GN; every classic iteration and LM's
    # residual resets), K2 the hat-mode update (classic)
    "image_warping": ("warp_pipelined_sweep", "warp_hat_apply",
                      "pcg_update"),
}


def workload(argv=None):
    """The --workload of the command line (sys.argv), or None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    args, _ = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args.workload


def run_cell_of(argv=None):
    """The Cell that the command line's --workload names in
    BENCHMARK.json, or None where it names none."""
    from .spec import ROOT, load_cell, read_json

    name = workload(argv)
    if name is None:
        return None
    try:
        return load_cell(read_json(ROOT / "BENCHMARK.json"), name, True)
    except (KeyError, OSError):
        return None


def kernel_names(cell):
    """The energy's PCG kernel names, or () where it lists none."""
    return PCG_KERNELS.get(cell.config["energy"], ())


def is_pcg(name, names):
    return any(n in name for n in names)


def pcg_busy_s(trace, names):
    """Seconds over the trace in which one of the named kernels ran."""
    return union_s((s, s + d) for n, s, d, k in trace.device
                   if k == "kernel" and is_pcg(n, names))


def share_pct(trace, names):
    """100 x the named kernels' device time over all kernel time, or None
    where the trace holds none of them."""
    pcg = pcg_busy_s(trace, names)
    total = trace.busy_s({"kernel"})
    if pcg <= 0 or total <= 0:
        return None
    return 100.0 * pcg / total


def pcg_bound_s(cell, peaks):
    """The least time the inner PCG loops of one solve can take: the sum
    of work.py's bounds of the solve's pcg_ calls (a loop that fits the L2,
    or each iteration of one that does not) at the card's peaks."""
    calls = [c for c in cell_calls(cell, peaks["l2_bytes"])
             if c[0].startswith("pcg_")]
    return bound(calls, peaks)["seconds"]


def roofline_pct(trace, names, cell, peaks):
    """100 x the PCG loops' bound a solve over the named kernels' device
    time a traced solve, or None where the trace holds none of them."""
    busy = pcg_busy_s(trace, names)
    if busy <= 0:
        return None
    return 100.0 * pcg_bound_s(cell, peaks) * trace.solves / busy
