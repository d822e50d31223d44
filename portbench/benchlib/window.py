"""The closed loop: one caller, back-to-back Plan.solve calls on one plan.

Each call binds the next input set of a pool made from the run's seed and
ends in the host read of its final cost, as a vision or geometry pipeline
hands each frame's data to the same plan and waits for the answer.  The
pool cycles, so no input set follows itself and every call pays its bind.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def entry_seed(seed, i, size):
    """The generator's seed of pool entry i: entry i of run seed s is
    (s * size + i) mod 2**32, so run seed 0 holds the generator's seeds
    0 .. size - 1."""
    return (int(seed) * size + i) % 2 ** 32


def make_pool(cell, seed):
    """The cell's input sets, as numpy arrays on the host."""
    energy = cell.energy()
    size = int(cell.traffic["pool"])
    return [energy.inputs(cell.config["dims"], entry_seed(seed, i, size))
            for i in range(size)]


def new_plan(cell, device):
    """A plan of opt_tpu_torch for the cell's energy, solver and sizes."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    state = opt_tpu_torch.NewState(device=device)
    plan = state.problem_plan(
        state.problem_define(getattr(energies, cell.config["energy"]),
                             cell.traffic["solver"]),
        list(cell.config["dims"]))
    plan.set_solver_parameter("nIterations", int(cell.config["nIterations"]))
    plan.set_solver_parameter("lIterations", int(cell.config["lIterations"]))
    return plan


@dataclass
class Solve:
    entry: int  # the pool entry it solved
    start_s: float  # from the window's start
    wall_s: float
    cost: float


@dataclass
class Loop:
    plan: object
    pool: list
    engine: str = "auto"
    keep: frozenset = frozenset()  # the entries whose unknowns are kept
    next: int = 0
    # kept entry -> (index in the window, name -> unknowns) of its last solve
    last: dict = field(default_factory=dict)

    def solve(self):
        """(entry, final cost) of the next solve."""
        e = self.next % len(self.pool)
        self.next += 1
        return e, self.plan.solve(self.pool[e], engine=self.engine)

    def window(self, seconds, min_solves=0):
        """([Solve], seconds from the window's start to the end of its last
        solve): solves back to back until `seconds` have passed and at
        least min_solves are done.  Keeps a reference to the last unknowns
        of each entry in `keep` (no copy)."""
        clock = time.perf_counter
        solves = []
        t0 = clock()
        while True:
            ts = clock()
            e, cost = self.solve()
            te = clock()
            if e in self.keep:
                self.last[e] = (len(solves), dict(self.plan.x))
            solves.append(Solve(e, ts - t0, te - ts, cost))
            if te - t0 >= seconds and len(solves) >= min_solves:
                return solves, te - t0
