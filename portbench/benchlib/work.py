"""The least time the card could take for one solve: the work that the
algorithm needs, counted from the shapes, at the card's published peaks.

The count is the function's, never a kernel's: each call reads its inputs
once and writes its outputs once, and does the operations the function
needs (an energy module's POINT table, a sincosf taken as 40).  A call's
bound is the larger of its bytes over the memory bandwidth and its
operations over the float32 rate; a solve's bound is the sum over its
calls, in the order the solver makes them:

  the initial cost;
  for each outer step: the linearization (J^T F and diag(J^T J)); the PCG
  loop; the update x + delta with the new cost; for LM, the model cost.

A PCG loop whose working set (its six vectors, LM's ctc and b beside them,
the unknowns and the constants) fits the card's L2 is one call: its
vectors need never reach memory, so it reads its inputs and writes delta
once.  A loop that does not fit makes a call of each iteration: the
iteration reads p, r, delta and the preconditioner (the first reads J^T F
and the diagonal instead), what the apply needs of the unknowns and the
constants, and LM's ctc and b, and writes delta, r and p (the last writes
delta alone).  LM's residual reset every RESET_PERIOD iterations adds one
apply's operations.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"
WORD = 4  # float32
RESET_PERIOD = 10  # LM's residual_reset_period, the solver's default


def peaks_for(device_name):
    """The peaks table entry whose key the device's name contains."""
    for key, entry in json.loads(PEAKS.read_text()).items():
        if key in device_name:
            return entry
    raise KeyError(f"no peaks for {device_name!r} in {PEAKS}")


def cell_calls(cell, l2_bytes):
    """solve_calls() of a cell: its energy's POINT table at its sizes."""
    c = cell.config
    return solve_calls(cell.energy().POINT, math.prod(c["dims"]), cell.lm,
                       int(c["nIterations"]), int(c["lIterations"]),
                       l2_bytes)


def solve_calls(point, n_points, lm, n_outer, n_linear, l2_bytes):
    """[(label, bytes, operations)] of one solve.  point: the energy's
    POINT table (float32 words a point: unknowns, consts, apply_reads;
    operations a point: linearize, cost, model_cost, apply, and vector, the
    operations a PCG iteration's vector updates and dots take an unknown
    word)."""
    u, c, a = point["unknowns"], point["consts"], point["apply_reads"]
    ops = point["ops"]
    n = n_points
    calls = [("cost", n * (u + c) * WORD, n * ops["cost"])]
    it_ops = ops["apply"] + ops["vector"] * u
    resets = n_linear // RESET_PERIOD if lm else 0
    vectors = 6 + (2 if lm else 0)
    fits = n * (vectors * u + u + c) * WORD <= l2_bytes
    for _ in range(n_outer):
        calls.append(("linearize", n * (u + c + 2 * u) * WORD,
                      n * ops["linearize"]))
        if fits:
            calls.append(("pcg_loop", n * (u + c + 2 * u + u) * WORD,
                          n * (n_linear * it_ops + resets * ops["apply"])))
        else:
            for i in range(n_linear):
                reads = (2 * u if i == 0 else 4 * u) + a
                if lm and i:
                    reads += 2 * u  # ctc and b
                writes = u if i == n_linear - 1 else 3 * u
                extra = (ops["apply"] if lm and (i + 1) % RESET_PERIOD == 0
                         else 0)
                calls.append(("pcg_iteration", n * (reads + writes) * WORD,
                              n * (it_ops + extra)))
        calls.append(("update_cost", n * (u + u + c + u) * WORD,
                      n * (ops["cost"] + u)))
        if lm:
            calls.append(("model_cost", n * (u + u + c) * WORD,
                          n * ops["model_cost"]))
    return calls


def bound(calls, peaks):
    """{"seconds", "bytes", "operations", "bytes_share"}: the solve's bound
    and the share of it that calls bound by bytes take."""
    bw, fl = peaks["hbm_bytes_per_s"], peaks["f32_flops_per_s"]
    total = by_bytes = 0.0
    n_bytes = n_ops = 0
    for _, b, o in calls:
        t = max(b / bw, o / fl)
        total += t
        if b / bw >= o / fl:
            by_bytes += t
        n_bytes += b
        n_ops += o
    return {"seconds": total, "bytes": n_bytes, "operations": n_ops,
            "bytes_share": by_bytes / total if total else math.nan}
