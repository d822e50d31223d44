"""One run of a cell: set-up, the measured window, the traced solves, the
output check, and the result's metrics.

    set-up    the input pool from the seed; a plan; `warmup` solves at the
              cell's shapes (the first run of a checkout builds the kernel
              library here);
    window    back-to-back solves for `seconds` (window.Loop);
    trace     with trace, `trace_solves` solves under torch.profiler after
              the window;
    check     once the window has closed, the peak memory read and the
              program's state freed: the reference on the sampled entries
              (check.py), in float64 on the run's device.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass

from . import check, window
from .spec import reader
from .work import bound, cell_calls, counts, peaks_for


@dataclass
class RunRecord:
    """What the metric readers read."""
    setup_s: float
    solves: list  # [window.Solve]
    elapsed_s: float  # window start to the end of its last solve
    trace: object  # profile.Trace, or None
    work: dict  # work.bound() of one solve, or None
    cell: object = None  # the spec.Cell that ran
    peaks: dict = None  # the card's peaks (work.peaks_for), or None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def log_walls(solves):
    """The spread of the window's solve times, and how the first half of
    the window compares with the second, on standard error."""
    import numpy as np

    w = np.array([s.wall_s for s in solves]) * 1e3
    h = len(w) // 2
    q = np.percentile(w, [0, 25, 50, 75, 100])
    log(f"solve ms: min {q[0]:.3f} q1 {q[1]:.3f} median {q[2]:.3f} q3 "
        f"{q[3]:.3f} max {q[4]:.3f}; halves {w[:h].mean() if h else 0:.3f} "
        f"{w[h:].mean():.3f}; load {os.getloadavg()}")


def finite_or_none(v):
    return v if v is not None and math.isfinite(v) else None


def work_bound(cell, peaks):
    """work.bound() of one solve at the card's peaks."""
    return bound(cell_calls(cell, peaks["l2_bytes"]), peaks)


def counted_over(cell):
    """What a cell's work bound is counted over, in words."""
    n_points, n_edges = counts(cell)
    if not n_edges:
        return f"{n_points} points"
    return f"{n_points} vertices and {n_edges} edges"


def keep_last(loop):
    """kept entry -> (its last solve's index in the window, name -> its
    unknowns as float64 numpy arrays)."""
    import torch

    return {e: (i, {k: v.detach().to("cpu", torch.float64).numpy()
                    for k, v in x.items()})
            for e, (i, x) in loop.last.items()}


def check_window(cell, pool, solves, entries, kept, device):
    """(the worst of each number, the solves that failed, {entry: the
    reference's (cost, unknowns, starting unknowns)}): every window solve
    of the entries against the float64 reference (check.py)."""
    import torch

    rows, refs = [], {}
    failed = sum(1 for s in solves if not math.isfinite(s.cost))
    for e in entries:
        refs[e] = ref_cost, ref_x, x0 = check.reference_solve(
            cell, pool[e], device, torch.float64)
        last, x = kept[e]
        for i, s in enumerate(solves):
            if s.entry != e:
                continue
            row = check.gaps(s.cost, x if i == last else None, ref_cost,
                             ref_x, x0)
            failed += not check.judge(row, {k: cell.limits[k] for k in row})
            rows.append(row)
    return check.worst(rows), failed, refs


def run_cell(cell, seed, seconds, trace, device, t_start, engine="auto",
             plan_hook=None):
    """The result dict of one run (the keys the benchmark prints), and the
    compared numbers with their limits under "check".  plan_hook(plan), if
    given, may replace parts of the plan before the warm-up."""
    import torch

    clock = time.perf_counter
    on_card = torch.device(device).type == "cuda"
    traffic = cell.traffic
    t0 = clock()
    pool = window.make_pool(cell, seed)
    t1 = clock()
    plan = window.new_plan(cell, device)
    if plan_hook is not None:
        plan_hook(plan)
    entries = check.sample(seed, len(pool), int(traffic["check_entries"]))
    loop = window.Loop(plan, pool, engine, keep=frozenset(entries))
    t2 = clock()
    for _ in range(int(traffic["warmup"])):
        loop.solve()
    setup_s = clock() - t_start
    log(f"set-up {setup_s:.3f} s: pool {t1 - t0:.3f}, plan {t2 - t1:.3f}, "
        f"warm-up {t_start + setup_s - t2:.3f}; engine {plan.engine}, "
        f"variant {plan.variant}; window of {seconds} s")

    solves, elapsed = loop.window(seconds, min_solves=len(pool))
    log_walls(solves)
    tr = None
    if trace:
        from .profile import trace as profile_trace
        tr = profile_trace(torch, loop.solve, int(traffic["trace_solves"]))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    peaks = peaks_for(kind) if on_card else None
    work = work_bound(cell, peaks) if on_card else None

    # the check, once the program's state is freed
    kept = keep_last(loop)
    del loop, plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = clock()
    numbers, failed, _ = check_window(cell, pool, solves, entries, kept,
                                      device)
    correct = (bool(entries) and set(numbers) == set(cell.limits)
               and check.judge(numbers, cell.limits))
    log(f"check: entries {entries}, reference {clock() - t0:.1f} s")

    record = RunRecord(setup_s, solves, elapsed, tr, work, cell, peaks)
    metrics = {}
    for m in cell.metrics:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(solves),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if work is not None:
        log(f"work bound of a solve: {work['seconds'] * 1e3:.4f} ms "
            f"({work['bytes']} bytes, {work['operations']} operations, "
            f"counted over {counted_over(cell)}; "
            f"{100 * work['bytes_share']:.1f}% of it bound by bytes)")
    result["check"] = {k: {"value": finite_or_none(numbers.get(k)),
                           "limit": cell.limits[k]} for k in cell.limits}
    return result
