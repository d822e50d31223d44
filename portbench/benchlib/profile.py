"""The traced solves: torch.profiler over a few solves, summarised in
memory (nothing is written to disk).

After one solve in the profiler's warm-up step (the first calls a profiler
traces can lose launches), `n` solves are traced.  What is kept: each
device event (name, start, duration, kind: kernel, h2d, d2h, d2d, memset)
and each host event (name, start, end), for the metric readers and the
breakdown.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

NAME_CHARS = 120


def kind_of(name):
    if name.startswith("Memcpy"):
        for k in ("HtoD", "DtoH", "DtoD"):
            if k in name:
                return k.lower().replace("to", "2")
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_s(intervals):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


@dataclass
class Trace:
    solves: int
    window_s: float  # host wall time of the traced solves, the
    # profiler's processing of the trace after the last one left out
    device: list  # (name, start_ns, duration_ns, kind)
    host: list  # (name, start_ns, end_ns)

    def busy_s(self, kinds=None):
        """Seconds in which the device ran an event (of the given kinds)."""
        return union_s((s, s + d) for _, s, d, k in self.device
                       if kinds is None or k in kinds)

    def count(self, kind):
        return sum(1 for ev in self.device if ev[3] == kind)

    def seconds(self, kind):
        return sum(d for _, _, d, k in self.device if k == kind) / 1e9

    def top_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time
        over the traced solves."""
        total = defaultdict(int)
        for name, _, d, _ in self.device:
            total[name[:NAME_CHARS]] += d
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in rows]

    def idle_gaps(self, n=10):
        """[[name, seconds]] of the longest gaps between device events,
        each named by the innermost host event that spans its middle."""
        ivs = sorted((s, s + d) for _, s, d, _ in self.device)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) // 2
            best = None
            for name, hs, he in self.host:
                if hs <= mid <= he and (best is None
                                        or he - hs < best[1] - best[0]):
                    best = (hs, he, name)
            out.append([("host: " + best[2][:NAME_CHARS]) if best
                        else "host: no traced op", length / 1e9])
        return out


def trace(torch, step, n):
    """Trace n calls of step() after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        step()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
            # the last prof.step() stops the trace and processes it:
            # seconds at tens of thousands of launches, outside the window
            window_s = time.perf_counter() - t0
            prof.step()
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith("ProfilerStep"):
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if dur > 0:
                device.append((name, start, dur, kind_of(name)))
        else:
            host.append((name, start, start + dur))
    return Trace(n, window_s, device, host)
