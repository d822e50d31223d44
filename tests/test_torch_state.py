"""The port's Plan lifecycle: init/step against solve, checkpoints from
the JAX package and from the port, the main path's inputs, and the solver
modes that are not ported yet (the materialized Jacobian)."""

import numpy as np
import pytest
import torch

import bench
import chip_smoke
import opt_tpu_torch
from opt_tpu_torch import energies
from tests.test_solver_dense import warp_inputs
from tests.test_torch_solve import ENGINES, jax_plan, port_plan

torch.set_num_threads(1)


@pytest.mark.parametrize("engine", ENGINES)
def test_init_step_matches_solve(engine):
    inputs = chip_smoke.warp_inputs(12, 10, seed=2)
    plan = port_plan(12, 10, 2, 10)
    want = plan.solve(inputs, engine=engine)
    plan.init(inputs, engine=engine)
    steps = 0
    while plan.step():
        steps += 1
    assert steps == 2
    assert plan.final_cost() == pytest.approx(want, rel=1e-6)
    assert plan.current_cost() == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_jax_checkpoint_resumes_in_port(tmp_path, engine):
    """opt_tpu save_state -> opt_tpu_torch load_state, then two more steps
    in each package from the same state."""
    inputs = warp_inputs(12, 10, seed=9)
    jplan = jax_plan(12, 10, 1, 10)
    jplan.init(inputs)
    while jplan.step():
        pass
    path = tmp_path / "state.npz"
    jplan.save_state(path)
    jplan.set_solver_parameter("nIterations", 3)
    while jplan.step():
        pass

    plan = port_plan(12, 10, 3, 10)
    plan.init(inputs, engine=engine)
    plan.load_state(path)
    assert int(plan._state["n_iter"]) == 1
    steps = 0
    while plan.step():
        steps += 1
    assert steps == 2
    assert plan.final_cost() == pytest.approx(jplan.final_cost(), rel=1e-4)
    for n, arr in plan.unknowns().items():
        np.testing.assert_allclose(arr, jplan.unknowns()[n], rtol=1e-3,
                                   atol=1e-5, err_msg=n)


def test_port_checkpoint_round_trip(tmp_path):
    inputs = warp_inputs(8, 6, seed=1)
    plan = port_plan(8, 6, 2, 5)
    plan.init(inputs)
    plan.step()
    path = tmp_path / "port.npz"
    plan.save_state(path)
    keys = set(np.load(path).files)
    assert {"x.Offset", "x.Angle", "prev_cost", "n_iter", "done"} <= keys
    want = plan.unknowns()
    other = port_plan(8, 6, 2, 5)
    other.init(inputs)
    other.load_state(path)
    assert other.final_cost() == plan.final_cost()
    for n, arr in other.unknowns().items():
        np.testing.assert_array_equal(arr, want[n])


@pytest.mark.parametrize("W,H", [(512, 512), (40, 24)])
def test_port_warp_inputs_equal_bench(W, H):
    want = bench.warp_inputs(W, H)
    got = chip_smoke.warp_inputs(W, H)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("kwargs,kind", [
    ({"use_materialized_jacobian": True}, "LMGPU"),
    ({"use_fused_jtj": True}, "gaussNewtonGPU"),
    ({"use_materialized_jacobian": True}, "gaussNewtonGPU"),
])
def test_unported_solver_modes_raise(kwargs, kind):
    st = opt_tpu_torch.NewState(device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.problem_plan(st.problem_define(energies.image_warping, kind),
                        [8, 6])


def test_bad_solver_settings_raise():
    for kwargs in ({"guarded_invert_type": "NOPE"},
                   {"jacobi_scaling": "SOMETIMES"},
                   {"pcg_variant": "fancy"}):
        st = opt_tpu_torch.NewState(device="cpu", **kwargs)
        with pytest.raises(ValueError, match="must be one of"):
            st.problem_plan(st.problem_define(energies.image_warping),
                            [8, 6])


def test_double_precision_and_phase_timing(capsys):
    """double_precision runs the plain engine in float64; the phase table
    prints the reference's TIMING line, its bind row first, when the
    stepped solve ends."""
    inputs = warp_inputs(8, 6, seed=3)
    costs = {}
    for dp in (False, True):
        st = opt_tpu_torch.NewState(device="cpu", double_precision=dp,
                                    collect_kernel_timing=dp)
        plan = st.problem_plan(st.problem_define(energies.image_warping),
                               [8, 6])
        plan.set_solver_parameter("nIterations", 1)
        plan.set_solver_parameter("lIterations", 8)
        if dp:  # the kernels hold f32 only
            with pytest.raises(ValueError, match="f32"):
                plan._pick_engine("cuda")
        plan.init(inputs, engine="torch")
        while plan.step():
            pass
        assert plan.x["Offset"].dtype == (torch.float64 if dp
                                          else torch.float32)
        costs[dp] = plan.final_cost()
    assert costs[True] == pytest.approx(costs[False], rel=1e-4)
    out = capsys.readouterr().out
    assert "TIMING bind=" in out and " init=" in out and "step_0=" in out


def test_new_state_defaults_to_the_card():
    """NewState() asks for the card: it raises where torch sees no CUDA
    device, and device="cpu" is how a caller (and every CPU test) asks for
    the CPU."""
    assert opt_tpu_torch.NewState(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert opt_tpu_torch.NewState().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt_tpu_torch.NewState()
