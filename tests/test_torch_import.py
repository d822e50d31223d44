"""opt_tpu_torch stands alone: it imports no JAX and nothing of opt_tpu,
and its kernel build is importable where there is no nvcc."""

import os
import subprocess
import sys

import pytest
import torch

from opt_tpu_torch.ops import build
from opt_tpu_torch.runtime.trace import LAUNCHES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    # a subprocess: this test process already imported jax (conftest.py)
    code = (
        "import sys, opt_tpu_torch\n"
        "import opt_tpu_torch.ops.warp_cuda, opt_tpu_torch.ops.build\n"
        "import opt_tpu_torch.ops.stream_cuda, opt_tpu_torch.ops.vol_cuda\n"
        "import opt_tpu_torch.ops.stream3d_cuda, chip_smoke, chip_compare\n"
        "import opt_tpu_torch.ops.graph_cuda\n"
        "import opt_tpu_torch.ops.poisson_cuda\n"
        "import opt_tpu_torch.ops.halo_stencil\n"
        "from opt_tpu_torch.ops.stream_cuda import StreamSolver\n"
        "import opt_tpu_torch.compile.evaluate\n"
        "import opt_tpu_torch.compile.plan_fns\n"
        "import opt_tpu_torch.ops.slab_cuda\n"
        "import opt_tpu_torch.parallel.mesh, opt_tpu_torch.parallel.halo\n"
        "import opt_tpu_torch.parallel.stream_shard\n"
        "import opt_tpu_torch.parallel.dispatch\n"
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
    for name in ("poisson_kernels.cu", "resident_kernels.cu",
                 "stencil_kernels.cu"):
        assert name in srcs
    for name in ("poisson_energy.cuh", "resident_pcg.cuh"):
        assert name in [h.name for h in build.headers()]
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
    for k in ("K9.graph_gather", "K10.graph_scatter", "K11.graph_hat_edge",
              "K11.graph_hat_vertex"):
        assert LAUNCHES[k] >= 0
    assert graph_cuda.graph_hat_apply.__name__ == "graph_hat_apply"


def test_slice5_kernels_are_bound():
    """K12-K14's C entry points have ctypes signatures, and their wrappers
    count launches; importing them needs no nvcc and no card."""
    from opt_tpu_torch.ops import halo_stencil, poisson_cuda, stream_cuda

    for name in ("opt_poisson_cg_blocks", "opt_poisson_cg",
                 "opt_resident_warp_blocks", "opt_resident_warp",
                 "opt_resident_poisson_blocks", "opt_resident_poisson",
                 "opt_stencil_apply"):
        assert name in build.SIGNATURES
    for k in ("K12.poisson_cg", "K13.resident_pcg", "K14.stencil_apply"):
        assert LAUNCHES[k] >= 0
    for k in (poisson_cuda.poisson_cg, stream_cuda.resident_pcg,
              halo_stencil.stencil_apply):
        assert callable(k)


def test_coop_blocks_raises_on_a_failed_query(monkeypatch):
    class Lib:
        def opt_cuda_error_string(self, code):
            return b"cooperative launch is too large"

    monkeypatch.setattr(build, "_lib", Lib())
    assert build.coop_blocks(264, "k") == 264
    with pytest.raises(RuntimeError, match="k: CUDA error 82"):
        build.coop_blocks(-82, "k")


def test_slice6_kernels_are_bound():
    """K15, K16 and the offset modes of K3 and K8 have ctypes signatures,
    and K15's and K16's wrappers count launches; importing them needs no
    nvcc and no card."""
    from opt_tpu_torch.ops import slab_cuda

    for name in ("opt_warp_linearize_blocks", "opt_warp_slab_linearize",
                 "opt_vol_linearize_blocks",
                 "opt_warp_slab_apply", "opt_vol_slab_linearize",
                 "opt_vol_slab_apply"):
        assert name in build.SIGNATURES
    for k in ("K15.warp_slab_apply", "K16.vol_slab_apply",
              "K3.warp_slab_linearize", "K8.vol_slab_linearize"):
        assert LAUNCHES[k] >= 0
    assert callable(slab_cuda.warp_slab_apply)
