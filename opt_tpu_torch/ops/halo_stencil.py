"""Row-tiled weighted stencil sum on a hand-written CUDA kernel (port of
opt_tpu/ops/halo_stencil.py).

  K14 stencil_apply  out[p] = sum_k w_k img[p + o_k], zero outside the
                     H x W image; each block stages its row tile plus the
                     exact halo in shared memory (csrc/stencil_kernels.cu)

The JAX kernel was the prototype of the streamed solvers' window
mechanism: a manual DMA of a row tile plus halo into VMEM.  Its halo
rounded up to 8 rows and its width padded to 128 lanes are TPU scaffolding
and are not ported.  Offsets are (dx, dy) = (column, row), as in the JAX
package.
"""

from __future__ import annotations

import ctypes

from ..compile.evaluate import shift_read
from ..runtime.trace import LAUNCHES, kernel
from . import build

# the most taps K14 takes (kMaxTaps in csrc/stencil_kernels.cu)
MAX_TAPS = 32


def stencil_apply_plain(img, offsets, weights):
    """sum(w * shift_read(img, o)), as tests/test_halo_stencil.py states
    the JAX kernel's function."""
    return sum(w * shift_read(img, o) for o, w in zip(offsets, weights))


@kernel("K14.stencil_apply")
def stencil_apply(img, offsets, weights, tile=64):
    """K14: the weighted stencil sum of a (H, W) float32 image -- kernel on
    CUDA, plain on CPU.  tile: rows per block."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    weights = tuple(float(w) for w in weights)
    if not 1 <= len(offsets) <= MAX_TAPS or len(weights) != len(offsets):
        raise ValueError(f"stencil_apply: 1 to {MAX_TAPS} taps, each with "
                         f"a weight ({len(offsets)} offsets, {len(weights)} "
                         "weights)")
    if build.all_on_cpu(img):
        return stencil_apply_plain(img, offsets, weights)
    if img.ndim != 2:
        raise ValueError(f"stencil_apply: img must be (H, W), not "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    build.check_tensors("stencil_apply", {}, img=img)
    lib = build.library()
    out = img.new_empty((H, W))
    n = len(offsets)
    dx = (ctypes.c_int * n)(*(o[0] for o in offsets))
    dy = (ctypes.c_int * n)(*(o[1] for o in offsets))
    w = (ctypes.c_float * n)(*weights)
    rc = lib.opt_stencil_apply(
        build.ptr(img), build.ptr(out), H, W, int(tile), n,
        ctypes.cast(dx, ctypes.c_void_p), ctypes.cast(dy, ctypes.c_void_p),
        ctypes.cast(w, ctypes.c_void_p), build.stream())
    build.check(rc, "stencil_apply")
    LAUNCHES["K14.stencil_apply"] += 1
    return out


