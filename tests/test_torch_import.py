"""opt_tpu_torch stands alone: it imports no JAX and nothing of opt_tpu,
and its kernel build is importable where there is no nvcc."""

import os
import subprocess
import sys

import pytest
import torch

from opt_tpu_torch.ops import build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    # a subprocess: this test process already imported jax (conftest.py)
    code = (
        "import sys, opt_tpu_torch\n"
        "import opt_tpu_torch.ops.warp_cuda, opt_tpu_torch.ops.build\n"
        "import opt_tpu_torch.ops.stream_cuda, opt_tpu_torch.ops.vol_cuda\n"
        "import opt_tpu_torch.ops.stream3d_cuda, chip_smoke\n"
        "import opt_tpu_torch.ops.graph_cuda\n"
        "import opt_tpu_torch.compile.evaluate\n"
        "import opt_tpu_torch.compile.plan_fns\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'opt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_key_covers_every_source():
    srcs = [s.name for s in build.sources()]
    assert "warp_kernels.cu" in srcs and "pcg_update.cu" in srcs
    assert "vol_kernels.cu" in srcs and "stream3d_kernels.cu" in srcs
    assert "vol_energy.cuh" in [h.name for h in build.headers()]
    assert "graph_kernels.cu" in srcs
    assert build._key() == build._key()
    assert "-gencode" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_library_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()
    assert not (tmp_path / "build").exists()  # nothing made before nvcc


def test_cuda_device_without_card_raises():
    import opt_tpu_torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_tpu_torch.NewState(device="cuda")


def test_graph_kernels_are_bound_and_registered():
    """K9-K11's C entry points have ctypes signatures, and K9 and K10 are
    torch custom ops (so torch.func.linearize's trace records them)."""
    import torch

    from opt_tpu_torch.ops import graph_cuda

    for name in ("opt_graph_gather", "opt_graph_scatter",
                 "opt_graph_blocks", "opt_graph_hat_apply"):
        assert name in build.SIGNATURES
    assert hasattr(torch.ops.opt_tpu_torch, "graph_gather")
    assert hasattr(torch.ops.opt_tpu_torch, "graph_scatter")
    for k in (graph_cuda.graph_gather, graph_cuda.graph_scatter,
              graph_cuda.graph_hat_apply):
        assert k.launches >= 0
