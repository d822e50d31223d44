"""Build and load the port's CUDA kernels (opt_tpu_torch/csrc/*.cu).

At first use, nvcc compiles every source under csrc/ (the *.cu files,
which include the *.cuh headers there), one process per source, all
started together, and links the objects into one shared library with a
plain C interface, which ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c opt_tpu_torch/csrc/<name>.cu \
         -o build/opt_tpu_torch/<hash>/<name>.o        (each source)
    nvcc -shared -o build/opt_tpu_torch/<hash>/libopt_tpu_torch.so *.o

The output lives under build/ at the repository root, keyed by a hash of
the sources, headers and flags, so an edited source rebuilds and an
unchanged one loads the library it already built.  Importing this module
needs no nvcc and no card; library() raises when there is no nvcc.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); check() raises on a non-zero code.  The whole-loop
kernels (K12, K13) launch cooperatively on a grid that their *_blocks
entry sizes from the occupancy query; a refused launch
(cudaErrorCooperativeLaunchTooLarge or any other) comes back as its code,
and coop_blocks() raises on a failed query.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opt_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIB_NAME = "libopt_tpu_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types; every pointer and the stream are c_void_p, which
# takes a Python int (a data_ptr()) as it is
SIGNATURES = {
    "opt_warp_blocks": [_I, _I],
    "opt_warp_apply_blocks": [_I, _I],
    "opt_warp_jtj_apply": [_P] * 9 + [_I, _I, _P],
    "opt_warp_linearize_blocks": [_I] * 4,
    "opt_warp_linearize": [_P] * 9 + [_I, _I, _I, _P],
    "opt_warp_hat_apply_blocks": [_I, _I],
    "opt_warp_hat_apply": [_P] * 13 + [_I, _I, _P],
    "opt_warp_pipelined_sweep": [_P] * 20 + [_I, _I, _P],
    "opt_pcg_update_blocks": [_I],
    "opt_pcg_update": [_P] * 12 + [_I, _I, _P],
    "opt_vol_blocks": [_I, _I, _I],
    "opt_vol_linearize_blocks": [_I] * 5,
    "opt_vol_linearize": [_P] * 8 + [_I] * 4 + [_P],
    "opt_vol_hat_blocks": [_I, _I, _I],
    "opt_vol_hat_apply": [_P] * 12 + [_I] * 3 + [_P],
    "opt_vol_pipelined_sweep": [_P] * 19 + [_I] * 3 + [_P],
    "opt_graph_gather": [_P] * 3 + [_I] * 3 + [_P],
    "opt_graph_scatter": [_P] * 4 + [_I] * 3 + [_P],
    "opt_graph_blocks": [_I],
    "opt_graph_hat_edge": [_P] * 3 + [_I] + [_P] * 6,
    "opt_graph_hat_vertex": [_P] * 5 + [_I] + [_P] * 8 + [_I, _P],
    "opt_graph_hat_apply": [_P] * 6 + [_I] + [_P] * 9 + [_I, _P],
    "opt_poisson_cg_blocks": [_I],
    "opt_poisson_cg": [_P] * 8 + [_I] * 5 + [_P],
    "opt_resident_warp_blocks": [_I, _I],
    "opt_resident_poisson_blocks": [_I],
    "opt_resident_warp": [_P] * 13 + [_I] * 4 + [_P],
    "opt_resident_warp_onchip_blocks": [_I, _I],
    "opt_resident_warp_onchip": [_P] * 12 + [_I] * 4 + [_P],
    "opt_card_limits": [ctypes.POINTER(_I)] * 2,
    "opt_resident_poisson": [_P] * 8 + [_I] * 5 + [_P],
    "opt_stencil_apply": [_P, _P] + [_I] * 4 + [_P] * 4,
    "opt_warp_slab_linearize": [_P] * 9 + [_I] * 7 + [_P],
    "opt_warp_slab_apply": [_P] * 8 + [_I] * 6 + [_P],
    "opt_vol_slab_linearize": [_P] * 8 + [_I] * 8 + [_P],
    "opt_vol_slab_apply": [_P] * 7 + [_I] * 7 + [_P],
}

_lib = None
# what the last build did: seconds spent in nvcc (0.0 when the library was
# already built) and nvcc's output (ptxas register and spill report)
build_seconds = None
build_log = ""


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on a machine "
            "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def _key():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out = BUILD_DIR / _key() / LIB_NAME
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [out.with_name(f"{src.stem}.{tag}.o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [src.name for src, proc in zip(sources(), procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = out.with_name(f"{LIB_NAME}.{tag}")
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{build_log}")
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.opt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.opt_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc, name):
    if rc != 0:
        msg = _lib.opt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def coop_blocks(n, name):
    """The grid of a launch sized by the occupancy query (a cooperative
    launch, or a march: K1, K3, K8), from its *_blocks entry's value n: a
    block count, or minus the CUDA error of the query."""
    if n <= 0:
        check(-n, name)
    return n


_cards = {}


def card_limits():
    """(SMs, shared memory a block may take, opted in, in bytes) of the
    current CUDA device, read once a device."""
    import torch

    dev = torch._C._cuda_getDevice()
    if dev not in _cards:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        check(library().opt_card_limits(ctypes.byref(sms),
                                        ctypes.byref(smem)), "card_limits")
        _cards[dev] = (sms.value, smem.value)
    return _cards[dev]


def ptr(t):
    """A tensor's device address for ctypes (an int); None (a null
    pointer) for an operand that is absent."""
    return None if t is None else t.data_ptr()


def stream():
    """The current CUDA stream of the current device, as an int."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def all_on_cpu(*tensors):
    """True when every tensor lies on the CPU: the wrappers then run their
    plain versions.  A call that mixes devices goes to the kernel's checks,
    which refuse it."""
    for t in tensors:
        if t is not None and not t.is_cpu:
            return False
    return True


def present(**tensors):
    """The named tensors that are present (None marks an absent one)."""
    return {k: v for k, v in tensors.items() if v is not None}


def check_tensors(name, shapes, dtypes=None, **tensors):
    """Raise unless every tensor is a contiguous CUDA tensor of the shape
    given in ``shapes`` (name -> shape) and of the type given in ``dtypes``
    (name -> dtype; float32 where not named), all on one device.  One pass
    over the tensors, reading each property once."""
    import torch

    index = None
    for arg, t in tensors.items():
        if not t.is_cuda or (index is not None and t.get_device() != index):
            first = next(iter(tensors.values()))
            raise ValueError(
                f"{name}: {arg} is on {t.device}; every tensor must be on "
                f"one cuda device ({first.device})")
        if index is None:
            index = t.get_device()
        want_dtype = dtypes.get(arg, torch.float32) if dtypes else torch.float32
        if t.dtype != want_dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, not {want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        want = shapes.get(arg)
        if want is not None and t.shape != tuple(want):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(t.shape)}, want "
                f"{tuple(want)}")
