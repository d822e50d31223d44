"""The output check: solves that the timed window ran, held against the
plain reference (reference/) on the same numpy inputs.

Two numbers are compared, each the worst over the solves checked:

  cost_gap   |cost - cost_ref| / |cost_ref|, over every window solve of the
             sampled pool entries (the final cost that Plan.solve returned);
  x_gap      over the unknowns u, ||x_u - x_ref_u||_2 / ||x_ref_u - x0_u||_2:
             the gap of the unknowns that the entry's last window solve left,
             against how far the reference moved them.

The sample, drawn before the window: the run seed draws an order of the
pool's entries, and the first `check_entries` of them are checked.  The
window solves every entry at least once.
"""

from __future__ import annotations

import math

import numpy as np


def sample(seed, pool_size, k):
    """The first k entries of the seed's order of the pool."""
    order = np.random.default_rng(int(seed)).permutation(pool_size)
    return [int(e) for e in order[:k]]


def reference_solve(cell, inputs, device, dtype):
    """(final cost, {name: unknowns}, {name: starting unknowns}) of the
    plain reference, as float64 numpy arrays."""
    import torch

    from ..reference import solver

    en = cell.reference().build(inputs, dtype, device)
    cost, x = solver.solve(en, cell.lm, int(cell.config["nIterations"]),
                           int(cell.config["lIterations"]))

    def host(tree):
        return {k: v.to(torch.float64).cpu().numpy() for k, v in tree.items()}

    return cost, host(en.unknowns(x)), host(en.unknowns(en.x0))


def gaps(cost, x, ref_cost, ref_x, x0):
    """{"cost_gap", "x_gap"} of one solve against the reference."""
    out = {"cost_gap": abs(cost - ref_cost) / abs(ref_cost)}
    if x is not None:
        g = 0.0
        for name, want in ref_x.items():
            moved = float(np.linalg.norm(want - x0[name]))
            diff = float(np.linalg.norm(np.asarray(x[name], np.float64)
                                        - want))
            g = max(g, diff / max(moved, 1e-300))
        out["x_gap"] = g
    return out


def judge(numbers, limits):
    """True where every number is finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def worst(rows):
    """The largest of each number over rows (NaN wins)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            cur = out.get(k)
            if cur is None or (not math.isnan(cur)
                               and (math.isnan(v) or v > cur)):
                out[k] = v
    return out
