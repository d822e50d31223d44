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

A grid energy counts its points from the product of the dims, by its POINT
table.  A graph energy's dims are [vertices, edges]: its POINT table
counts the vertices, which hold the unknowns and the vectors, and its EDGE
table the edges, whose words are the indices that each call reads once
(what a kernel materializes per edge, such as the graph engine's partials,
is the kernel's choice and not counted).
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


def counts(cell):
    """(points, edges) of a cell: a grid's points and no edge, or a graph
    energy's vertices and edges (dims [vertices, edges])."""
    dims = cell.config["dims"]
    if getattr(cell.energy(), "EDGE", None) is None:
        return math.prod(dims), 0
    return int(dims[0]), int(dims[1])


def cell_calls(cell, l2_bytes):
    """solve_calls() of a cell: its energy's POINT (and EDGE) tables at its
    sizes."""
    c, energy = cell.config, cell.energy()
    n_points, n_edges = counts(cell)
    return solve_calls(energy.POINT, n_points, cell.lm,
                       int(c["nIterations"]), int(c["lIterations"]),
                       l2_bytes, getattr(energy, "EDGE", None), n_edges)


def solve_calls(point, n_points, lm, n_outer, n_linear, l2_bytes,
                edge=None, n_edges=0):
    """[(label, bytes, operations)] of one solve.  point: the energy's
    POINT table (float32 words a point: unknowns, consts, apply_reads;
    operations a point: linearize, cost, model_cost, apply, and vector, the
    operations a PCG iteration's vector updates and dots take an unknown
    word); edge: a graph energy's EDGE table of the same keys, whose consts
    and apply_reads are the words an edge adds to every call (its
    indices), at n_edges edges."""
    u, c, a = point["unknowns"], point["consts"], point["apply_reads"]
    ops = point["ops"]
    n, e = n_points, n_edges
    eops = edge["ops"] if edge else dict.fromkeys(ops, 0)
    idx = e * edge["consts"] * WORD if edge else 0  # each call's indices
    e_apply = e * edge["apply_reads"] * WORD if edge else 0
    calls = [("cost", n * (u + c) * WORD + idx,
              n * ops["cost"] + e * eops["cost"])]
    it_ops = ops["apply"] + ops["vector"] * u
    resets = n_linear // RESET_PERIOD if lm else 0
    vectors = 6 + (2 if lm else 0)
    fits = n * (vectors * u + u + c) * WORD + idx <= l2_bytes
    for _ in range(n_outer):
        calls.append(("linearize", n * (u + c + 2 * u) * WORD + idx,
                      n * ops["linearize"] + e * eops["linearize"]))
        if fits:
            calls.append(("pcg_loop", n * (u + c + 2 * u + u) * WORD + idx,
                          n * (n_linear * it_ops + resets * ops["apply"])
                          + e * (n_linear + resets) * eops["apply"]))
        else:
            for i in range(n_linear):
                reads = (2 * u if i == 0 else 4 * u) + a
                if lm and i:
                    reads += 2 * u  # ctc and b
                writes = u if i == n_linear - 1 else 3 * u
                reset = lm and (i + 1) % RESET_PERIOD == 0
                extra = ops["apply"] if reset else 0
                calls.append(("pcg_iteration",
                              n * (reads + writes) * WORD + e_apply,
                              n * (it_ops + extra)
                              + e * (1 + reset) * eops["apply"]))
        calls.append(("update_cost", n * (u + u + c + u) * WORD + idx,
                      n * (ops["cost"] + u) + e * eops["cost"]))
        if lm:
            calls.append(("model_cost", n * (u + u + c) * WORD + idx,
                          n * ops["model_cost"] + e * eops["model_cost"]))
    return calls


def apply_call(point, n_points, edge=None, n_edges=0):
    """(label, bytes, operations) of one hat-space apply, A_hat p = S J^T J
    S p: it reads p, the scaling S and what J^T J p reads besides the
    vectors, and writes A_hat p."""
    u, a = point["unknowns"], point["apply_reads"]
    ea, e_apply = (edge["apply_reads"], edge["ops"]["apply"]) if edge else (
        0, 0)
    return ("apply", (n_points * (3 * u + a) + n_edges * ea) * WORD,
            n_points * point["ops"]["apply"] + n_edges * e_apply)


def applies(lm, n_outer, n_linear):
    """The applies of a solve's PCG loops: one an iteration, and LM's
    residual resets."""
    return n_outer * (n_linear + (n_linear // RESET_PERIOD if lm else 0))


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
