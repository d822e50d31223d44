"""The inner PCG loop's kernels in a traced run: which device rows they are,
their device time a traced solve, and the work the loop, or its apply
alone, needs a solve.

Each energy names the kernels that run its inner PCG on the engine its
cells take (energies/<energy>.py PCG_KERNELS), and those of the loop's
apply alone (APPLY_KERNELS) where a metric reads them; a device row is one
of them where its name holds one of the names.  The readers take the cell
and the card's peaks from the run's record (runner.RunRecord), so they
read the same inside and outside run.py.
"""

from __future__ import annotations

from .profile import union_s
from .work import applies, apply_call, bound, cell_calls, counts


def kernel_names(cell):
    """The energy's PCG kernel names, or () where it lists none."""
    return tuple(getattr(cell.energy(), "PCG_KERNELS", ()))


def apply_kernel_names(cell):
    """The names of the kernels that run the energy's PCG apply, or ()."""
    return tuple(getattr(cell.energy(), "APPLY_KERNELS", ()))


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


def apply_bound_s(cell, peaks):
    """The least time the PCG applies of one solve can take: work.py's
    bound of one apply times the applies a solve makes."""
    energy, c = cell.energy(), cell.config
    n_points, n_edges = counts(cell)
    one = apply_call(energy.POINT, n_points, getattr(energy, "EDGE", None),
                     n_edges)
    return bound([one], peaks)["seconds"] * applies(
        cell.lm, int(c["nIterations"]), int(c["lIterations"]))


def _pct(trace, names, bound_s):
    busy = pcg_busy_s(trace, names) if names else 0.0
    if busy <= 0:
        return None
    return 100.0 * bound_s * trace.solves / busy


def roofline_pct(trace, names, cell, peaks):
    """100 x the PCG loops' bound a solve over the named kernels' device
    time a traced solve, or None where the trace holds none of them."""
    return _pct(trace, names, pcg_bound_s(cell, peaks))


def apply_roofline_pct(trace, cell, peaks):
    """100 x the PCG applies' bound a solve over the device time of the
    energy's apply kernels a traced solve, or None where it names none or
    the trace holds none of them."""
    return _pct(trace, apply_kernel_names(cell), apply_bound_s(cell, peaks))
