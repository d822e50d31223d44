"""The benchmark's files: found by name, seeded, counted as reckoned by
hand, free of JAX, and run.py refusing to run without a card."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench_testlib import ROOT, bench, small_cell, with_solver
from portbench.benchlib import window
from portbench.benchlib.spec import HERE, load_cell, reader
from portbench.benchlib.work import bound, cell_calls, peaks_for
from portbench.energies import image_warping, volumetric_mesh_deformation

WORKLOADS = [w["name"] for w in bench()["workloads"]]
METRICS = [m["name"] for m in bench()["end_to_end"] + bench()["per_layer"]]
H100 = peaks_for("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_loads_by_name(name, trace):
    cell = load_cell(bench(), name, trace)
    assert cell.chips == 1
    # the energy brings its generator, reference, work tables, test size
    # and PCG kernels as files of its own
    energy = cell.config["energy"]
    assert (HERE / "energies" / f"{energy}.py").is_file()
    assert (HERE / "reference" / f"{energy}.py").is_file()
    e = cell.energy()
    assert set(e.POINT) == {"unknowns", "consts", "apply_reads", "ops"}
    assert set(e.SMALL) == {"dims", "outer", "pcg", "engine"}
    assert e.PCG_KERNELS and all(isinstance(n, str) for n in e.PCG_KERNELS)
    assert cell.traffic["solver"] in ("gaussNewtonGPU", "LMGPU")
    assert set(cell.limits) == {"cost_gap", "x_gap"}
    assert cell.metrics and all(
        "workloads" not in m or name in m["workloads"] for m in cell.metrics)
    assert callable(cell.energy().inputs)
    assert callable(cell.reference().build)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(reader(name))


def test_every_cell_reports_setup_and_a_layer_metric():
    b = bench()
    for name in WORKLOADS:
        e2e = [m["name"] for m in load_cell(b, name, False).metrics]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert load_cell(b, name, True).metrics


def _flat(inputs, prefix=""):
    """name -> array, a graph's index arrays as "G.v0" and so on."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _digest(inputs):
    h = hashlib.sha256()
    flat = _flat(inputs)
    for k in sorted(flat):
        a = flat[k]
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# sha256 of bench.warp_inputs(512, 512, 0) and of the volume that
# bench.aux_volumetric builds at 128^3 from seed 0 (chip_smoke.py's copies)
SEED0 = {
    "image_warping":
        ("ec87831330d32fa5b645b6555b84c6caf00c115023ce7dca9b5590a4394b6a5c",
         [512, 512]),
    "volumetric_mesh_deformation":
        ("a045a3a034a0eeb605cfbea6d251820b3d69b0280d1e7b698014c141e4d9e16b",
         [128, 128, 128]),
}


@pytest.mark.parametrize("energy", [image_warping,
                                    volumetric_mesh_deformation])
def test_generator_seed0_is_the_repositorys_input(energy):
    want, dims = SEED0[energy.__name__.rsplit(".", 1)[1]]
    assert _digest(energy.inputs(dims, 0)) == want


@pytest.mark.parametrize("name", [w["name"]
                                  for w in bench(held=True)["workloads"]])
def test_pool_is_seeded_and_repeats(name):
    cell, _ = small_cell(name)
    big = 2 ** 31 + 12345
    a, b = window.make_pool(cell, big), window.make_pool(cell, big)
    assert len(a) == cell.traffic["pool"] >= 2
    for x, y in zip(a, b):
        assert _digest(x) == _digest(y)
    assert len({_digest(x) for x in a}) == len(a)  # no entry repeats
    c = window.make_pool(cell, big + 1)
    assert _digest(c[0]) != _digest(a[0])
    # the same sizes from every seed
    for x, y in zip(a, c):
        assert {k: v.shape for k, v in _flat(x).items()} == {
            k: v.shape for k, v in _flat(y).items()}


def test_entry_seeds_of_seed0_are_the_generators_first():
    assert [window.entry_seed(0, i, 8) for i in range(8)] == list(range(8))
    assert window.entry_seed(2 ** 33, 1, 4) == 1


def _bound(name, solver=None):
    cell = load_cell(bench(), name, False)
    if solver:
        with_solver(cell, solver)
    calls = cell_calls(cell, H100["l2_bytes"])
    return calls, bound(calls, H100)


def test_work_warp512_gn_by_hand():
    n = 512 * 512
    calls, b = _bound("warp512_gn")
    # the PCG loop fits the L2 (6 vectors of 3 words, x and 5 constants:
    # 26.2 MB), so each outer step is one loop call
    loops = [c for c in calls if c[0] == "pcg_loop"]
    assert len(loops) == 8 and len(calls) == 1 + 8 * 3
    # the loop reads x, consts, J^T F and diag, writes delta: 17 words
    assert loops[0][1] == n * 17 * 4 == 17_825_792
    # 400 iterations of 160 + 12 x 3 operations a pixel
    assert loops[0][2] == n * 400 * 196
    # its time is the operations': 20.55 GFLOP at 67 TFLOP/s = 306.7 us
    assert loops[0][2] / 67e12 == pytest.approx(306.7e-6, rel=1e-3)
    # linearize 56 B a pixel (4.38 us), update and cost 56 B (4.38 us), the
    # first cost 32 B (2.50 us)
    want = 8 * (306.7e-6 + 2 * n * 56 / 3.35e12) + n * 32 / 3.35e12
    assert b["seconds"] == pytest.approx(want, rel=1e-3)


def test_work_warp512_lm_by_hand():
    """LM on the 512^2 configuration (no cell today: its host loop's
    spread is wider than any bound allows)."""
    n = 512 * 512
    calls, b = _bound("warp512_gn", "LMGPU")
    loops = [c for c in calls if c[0] == "pcg_loop"]
    # LM's 8 vectors of 3 words still fit: 32.5 MB
    assert len(loops) == 8
    # 40 residual resets an outer step, one apply (160) each
    assert loops[0][2] == n * (400 * 196 + 40 * 160)
    model = [c for c in calls if c[0] == "model_cost"]
    assert len(model) == 8 and model[0][1] == n * 11 * 4


def test_work_vol128_gn_by_hand():
    n = 128 ** 3
    calls, b = _bound("vol128_gn")
    its = [c for c in calls if c[0] == "pcg_iteration"]
    assert len(its) == 800  # 411 MB an iteration: no loop fits the L2
    # an iteration reads p, r, delta, pre (24 words), the Angle, UrShape
    # and Constraints' channel 0 (7), writes delta, r, p (18): 196 B a node
    assert its[1][1] == n * 49 * 4 == 411_041_792
    assert its[1][2] == n * (860 + 72)
    # the first reads J^T F and diag instead (12 + 7), the last writes
    # delta alone (6)
    assert its[0][1] == n * (12 + 7 + 18) * 4
    assert its[99][1] == n * (24 + 7 + 6) * 4
    lin = [c for c in calls if c[0] == "linearize"]
    assert lin[0][1] == n * 24 * 4 == 201_326_592  # 60.1 us
    per_it = n * 49 * 4 / 3.35e12
    assert per_it == pytest.approx(122.7e-6, rel=1e-3)
    assert b["bytes_share"] > 0.99
    want = (8 * (98 * per_it + n * (37 + 37) * 4 / 3.35e12
                 + 2 * n * 24 * 4 / 3.35e12) + n * 12 * 4 / 3.35e12)
    assert b["seconds"] == pytest.approx(want, rel=1e-6)


def test_work_vol128_lm_by_hand():
    """LM on the 128^3 configuration (no cell today: its host-paced runs
    spread wider than its bound could hold)."""
    n = 128 ** 3
    calls, _ = _bound("vol128_gn", "LMGPU")
    its = [c for c in calls if c[0] == "pcg_iteration"]
    # LM also reads ctc and b: 61 words; every 10th iteration adds an apply
    assert its[1][1] == n * 61 * 4
    assert its[9][2] == n * (860 + 72 + 860)
    assert its[8][2] == n * (860 + 72)


CHECK_IMPORTS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import portbench.benchlib.runner, portbench.benchlib.profile
import portbench.benchlib.check, portbench.benchlib.spec
import portbench.benchlib.window, portbench.benchlib.work
from portbench.benchlib.spec import load_cell, read_json, reader
from pathlib import Path
b = read_json(Path(sys.argv[1]) / "BENCHMARK.json")
for w in b["workloads"]:
    for t in (False, True):
        cell = load_cell(b, w["name"], t)
        cell.energy(); cell.reference()
for m in b["end_to_end"] + b["per_layer"]:
    reader(m["name"])
import importlib, pkgutil, portbench.energies, portbench.reference
for pkg in (portbench.energies, portbench.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{m.name}")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code, *args):
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_reference_load_no_jax():
    mods = _modules(CHECK_IMPORTS)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "opt_tpu"}
    # the reference and the harness load nothing of the port either: the
    # port is imported by the timed side alone, when a plan is made
    assert "opt_tpu_torch" not in tops
    assert "portbench" in tops


def test_the_timed_side_loads_no_jax():
    code = CHECK_IMPORTS.replace(
        "print(json.dumps", "import opt_tpu_torch, opt_tpu_torch.energies\n"
        "print(json.dumps")
    tops = {m.split(".")[0] for m in _modules(code)}
    assert "opt_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "opt_tpu"}


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "warp512_gn",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "warp512_gn",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
