"""The output check at a size a test run holds: sound runs pass, and
runs with the timed path broken underneath, or with the control in the
program's place, come out not correct."""

import time

import pytest
import torch

from portbench_testlib import bench, small_cell
from portbench.benchlib import check, window
from portbench.benchlib.runner import run_cell

WORKLOADS = [w["name"] for w in bench(held=True)["workloads"]]
SEED = 2 ** 31 + 2024


def _run(name, hook=None):
    cell, engine = small_cell(name)
    return run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                    engine=engine, plan_hook=hook)


def state_unchanged(plan):
    """A solve whose steps return their state unchanged."""
    init = plan._init_fn
    plan._full_solve_fn = lambda x, op, sp: init(x, op, sp)


def half_left_out(plan):
    """A solve whose update leaves half of the unknowns where they
    started."""
    solve = plan._full_solve_fn

    def broken(x, op, sp):
        state = solve(x, op, sp)
        n = x.numel() // 2
        state["x"] = torch.cat([x[:n], state["x"][n:]])
        return state

    plan._full_solve_fn = broken


def answer_altered(plan):
    """A solve whose final cost is altered by half where it is produced."""
    solve = plan._full_solve_fn

    def broken(x, op, sp):
        state = solve(x, op, sp)
        state["prev_cost"] = state["prev_cost"] * 1.5
        return state

    plan._full_solve_fn = broken


@pytest.mark.parametrize("name", WORKLOADS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) >= {"solve_ms", "setup_s"}


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
def test_fault_is_not_correct(name, fault):
    r = _run(name, fault)
    assert not r["correct"]
    assert r["failed"] > 0


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_is_not_correct(name):
    """The reference in bfloat16 put in the program's place, judged by the
    cell's limits."""
    cell, _ = small_cell(name)
    inputs = window.make_pool(cell, SEED)[0]
    ref_cost, ref_x, x0 = check.reference_solve(cell, inputs, "cpu",
                                                torch.float64)
    c, x, _ = check.reference_solve(cell, inputs, "cpu", torch.bfloat16)
    assert not check.judge(check.gaps(c, x, ref_cost, ref_x, x0),
                           cell.limits)


def test_sample_is_drawn_from_the_seed_alone():
    a = check.sample(SEED, 8, 3)
    assert a == check.sample(SEED, 8, 3) and len(set(a)) == 3
    assert sorted(check.sample(SEED, 8, 8)) == list(range(8))


@pytest.mark.parametrize("name", WORKLOADS)
def test_window_solves_and_keeps_every_checked_entry(name):
    """However short the window, it solves each pool entry, and keeps the
    unknowns of the sampled entries alone."""
    cell, engine = small_cell(name)
    pool = window.make_pool(cell, SEED)
    keep = frozenset(check.sample(SEED, len(pool), 1))
    loop = window.Loop(window.new_plan(cell, "cpu"), pool, engine, keep)
    solves, _ = loop.window(0, min_solves=len(pool))
    assert {s.entry for s in solves} == set(range(len(pool)))
    assert set(loop.last) == keep
