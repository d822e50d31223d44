"""The program's own spans in a traced run: the host events named "opt.*"
(opt_tpu_torch/runtime/trace.py) that profile.Trace keeps, read against
the device events of the same trace, on the same clock.

Nothing here imports the program: a trace of a program with no spans has
no such events, and every reader then returns None.
"""

from __future__ import annotations

import bisect

PREFIX = "opt."


def intervals(trace, match):
    """[(start_ns, end_ns)] of the trace's host events whose name
    match(name) accepts, in time order."""
    return sorted((s, e) for name, s, e in trace.host
                  if name.startswith(PREFIX) and match(name))


def merge(ivs):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered_ns(ivs):
    """Nanoseconds covered by the union of the intervals."""
    return sum(e - s for s, e in merge(ivs))


class DeviceBusy:
    """The union of a trace's device events (kernels, copies, memsets),
    asked how much of an interval it covers."""

    def __init__(self, trace):
        self.ivs = merge((s, s + d) for _, s, d, _ in trace.device)
        self.starts = [s for s, _ in self.ivs]

    def within_ns(self, a, b):
        """Nanoseconds of [a, b) in which a device event runs."""
        total = 0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.ivs) and self.ivs[i][0] < b:
            s, e = self.ivs[i]
            total += max(0, min(e, b) - max(s, a))
            i += 1
        return total


def host_ms_per_solve(trace, match):
    """ms a traced solve covered by the union of the matching spans, or
    None where the trace holds none."""
    ivs = intervals(trace, match)
    if not ivs:
        return None
    return covered_ns(ivs) / 1e6 / trace.solves


def idle_ms_per_solve(trace, match):
    """ms a traced solve of the matching spans' union in which no device
    event runs, or None where the trace holds no such span."""
    ivs = merge(intervals(trace, match))
    if not ivs:
        return None
    busy = DeviceBusy(trace)
    idle = sum((e - s) - busy.within_ns(s, e) for s, e in ivs)
    return idle / 1e6 / trace.solves
