"""Gauss-Newton and Levenberg-Marquardt with a Jacobi-preconditioned PCG
loop, in plain torch on a GridEnergy (grid.py) or a GraphEnergy
(graph.py): a frozen copy of the numerics of opt_tpu_torch/solver/core.py
(Opt's solverGPUGaussNewton.t), with its defaults (guarded invert CERES,
Jacobi scaling once a solve, classic PCG) and nothing else:

  r = -J^T F, pre = 1 / (1 + sqrt(diag))^2 (GN) or 1 / (CtC + diag) (LM),
  the classic PCG loop with a fixed trip count; LM recomputes r = b - A
  delta every `residual_reset_period` iterations and stops on the Q/zeta
  test by freezing delta; the trust region accepts or rejects each step
  as Ceres' StepAccepted does; a `done` flag freezes the state.

Vectors are (*grid, U) or (N, U) tensors; scalars stay 0-d tensors.
"""

from __future__ import annotations

import torch

DEFAULTS = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 0.0001,
    "function_tolerance": 0.000001,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
}


def _safe_div(a, b):
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def _dot(a, b):
    return torch.sum(a * b)


def _pcg(en, pre, r, b, ctc, lm, n_linear, sp):
    def A(v):
        out = en.jtj(v)
        if ctc is not None:
            out = out + ctc * v
        return en.mask(out)

    period = int(sp["residual_reset_period"])
    q_tol = float(sp["q_tolerance"])
    p = en.mask(pre * r)
    an = _dot(r, p)
    delta = torch.zeros_like(r)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    Q0 = zero
    brk = torch.zeros((), dtype=torch.bool, device=r.device)
    for i in range(n_linear):
        ap = A(p)
        alpha = _safe_div(an, _dot(p, ap))
        if lm:
            alpha = torch.where(brk, zero, alpha)
        delta = delta + alpha * p
        if lm and (i + 1) % period == 0:
            r = b - A(delta)
        else:
            r = r - alpha * ap
        z = en.mask(pre * r)
        bn = _dot(z, r)
        beta = _safe_div(bn, an)
        p = z + beta * p
        an = bn
        if lm:
            q = 0.5 * _dot(delta, r + b)
            zeta = (i + 1) * _safe_div(q - Q0, q)
            brk = brk | (zeta < q_tol)
            Q0 = q
    return delta


def _step(en, state, lm, n_linear, sp):
    x = state["x"]
    en.linearize(x)
    jtf, diag = en.jtf(), en.diag()
    r = en.mask(-jtf)
    diag = en.mask(diag)
    pre = en.mask(1.0 / torch.square(1.0 + torch.sqrt(
        torch.clamp_min(diag, 0.0))))
    ctc = None
    ssq = state["ssq"]
    if lm:
        radius = state["radius"]
        ssq = torch.where(state["n_iter"] == 0, pre, ssq)
        inv_s_sq = _safe_div(torch.ones_like(ssq), ssq)
        ctc = torch.clamp(
            (1.0 / radius) * diag,
            min=float(sp["min_lm_diagonal"]) * inv_s_sq / radius,
            max=float(sp["max_lm_diagonal"]) * inv_s_sq / radius)
        pre = en.mask(_safe_div(torch.ones_like(ctc), ctc + diag))
    b = r
    delta = _pcg(en, pre, r, b, ctc, lm, n_linear, sp)
    x_new = x + en.mask(delta)
    new_cost = en.cost(x_new)
    if not lm:
        return {**state, "x": x_new, "prev_cost": new_cost,
                "n_iter": state["n_iter"] + 1}
    prev = state["prev_cost"]
    model_cost_change = prev - en.model_cost(delta)
    cost_change = prev - new_cost
    relative_decrease = _safe_div(cost_change, model_cost_change)
    accept = ((cost_change >= 0)
              & (relative_decrease > float(sp["min_relative_decrease"])))
    ftol_reached = cost_change <= prev * float(sp["function_tolerance"])
    tmp_base = 2.0 * relative_decrease - 1.0
    tmp_factor = 1.0 - tmp_base * tmp_base * tmp_base
    radius_acc = torch.clamp(
        radius / torch.clamp(tmp_factor, min=1.0 / 3.0),
        max=float(sp["max_trust_region_radius"]))
    radius_rej = radius / state["decrease_f"]
    radius_too_small = radius_rej <= float(sp["min_trust_region_radius"])
    take_acc = accept & ~ftol_reached
    return {
        "x": torch.where(accept, x_new, x),
        "prev_cost": torch.where(take_acc, new_cost, prev),
        "radius": torch.where(take_acc, radius_acc,
                              torch.where(accept, radius, radius_rej)),
        "decrease_f": torch.where(
            take_acc, 2.0,
            torch.where(accept, state["decrease_f"],
                        2.0 * state["decrease_f"])),
        "ssq": ssq,
        "n_iter": state["n_iter"] + 1,
        "done": state["done"] | torch.where(accept, ftol_reached,
                                            radius_too_small),
    }


def solve(en, lm, n_outer, n_linear, params=None):
    """(final cost as a float, x) after n_outer steps of n_linear PCG
    iterations from en.x0.  The final cost is the cost after the last
    accepted update, as Opt prints it."""
    sp = dict(DEFAULTS, **(params or {}))
    x = en.x0.clone()
    dt, dev = x.dtype, x.device
    state = {
        "x": x,
        "prev_cost": en.cost(x),
        "radius": torch.tensor(sp["trust_region_radius"], dtype=dt,
                               device=dev),
        "decrease_f": torch.tensor(sp["radius_decrease_factor"], dtype=dt,
                                   device=dev),
        "ssq": torch.ones_like(x) if lm else torch.zeros((), dtype=dt,
                                                         device=dev),
        "n_iter": torch.zeros((), dtype=torch.int32, device=dev),
        "done": torch.zeros((), dtype=torch.bool, device=dev),
    }
    for _ in range(n_outer):
        new = _step(en, state, lm, n_linear, sp)
        if lm:
            new = {k: torch.where(state["done"], state[k], v)
                   for k, v in new.items()}
        state = new
    return float(state["prev_cost"]), state["x"]
