"""K2: PCG Step2 in one pass over the flat unknown vectors (port of
opt_tpu/ops/pcg_pallas.py).

    delta' = delta + alpha p
    r'     = r - alpha Ap
    z'     = pre r'
    rz     = <z', r'>                  (the next beta numerator)
    q      = 0.5 <delta', r' + b>      (LM only, when b is given)

With pre None (hat mode, the streamed engine's Step2 in the Jacobi-scaled
space, where M = I) z' is r' itself: the kernel reads no pre and writes no
z', and the returned z' is r'.

The port keeps every PCG work vector in one contiguous flat buffer (with
per-unknown views for the evaluator), so the kernel runs on the solver's
own buffers.  The TPU version lost 88x to a per-iteration
flatten/concatenate/pad around the kernel (pcg_pallas.py:22-30); here there
is none.  Step3's p = z + beta p stays plain torch (solver/core.py).

pcg_update() launches csrc/pcg_update.cu for CUDA tensors and runs
pcg_update_plain() for CPU tensors.
"""

from __future__ import annotations

import torch

from ..runtime.trace import LAUNCHES, kernel
from . import build


def pcg_update_plain(alpha, p, ap, delta, r, pre, b=None, dot=torch.dot):
    """Plain torch Step2.  Returns (delta', r', z', rz, q); q is None for
    GN (no b), and z' is r' when pre is None.  dot takes the two sums (a
    sharded operator's sums over the mesh)."""
    delta = delta + alpha * p
    r = r - alpha * ap
    z = r if pre is None else pre * r
    rz = dot(z, r)
    q = None if b is None else 0.5 * dot(delta, r + b)
    return delta, r, z, rz, q


@kernel("K2.pcg_update")
def pcg_update(alpha, p, ap, delta, r, pre, b=None):
    """Step2 through the K2 kernel on CUDA tensors (plain on CPU tensors).

    alpha is a 0-d device tensor: the kernel reads it from device memory.
    Same returns as pcg_update_plain; the two sums are per-block partials
    summed here."""
    if build.all_on_cpu(alpha, p, ap, delta, r, pre, b):
        return pcg_update_plain(alpha, p, ap, delta, r, pre, b)
    n = p.shape[0]
    vecs = dict(p=p, ap=ap, delta=delta, r=r)
    for name, v in (("pre", pre), ("b", b)):
        if v is not None:
            vecs[name] = v
    build.check_tensors("pcg_update", {"alpha": (), **{k: (n,) for k in vecs}},
                        alpha=alpha, **vecs)
    lib = build.library()
    blocks = lib.opt_pcg_update_blocks(n)
    delta_out = torch.empty_like(delta)
    r_out = torch.empty_like(r)
    z_out = torch.empty_like(r) if pre is not None else None
    rz_parts = torch.empty(blocks, dtype=p.dtype, device=p.device)
    q_parts = (torch.empty(blocks, dtype=p.dtype, device=p.device)
               if b is not None else rz_parts)
    b_arg = b if b is not None else p  # never read when uses_lambda == 0
    rc = lib.opt_pcg_update(
        build.ptr(alpha), build.ptr(p), build.ptr(ap), build.ptr(delta),
        build.ptr(r), build.ptr(pre), build.ptr(b_arg), build.ptr(delta_out),
        build.ptr(r_out), build.ptr(z_out), build.ptr(rz_parts),
        build.ptr(q_parts), n, int(b is not None), build.stream())
    build.check(rc, "pcg_update")
    LAUNCHES["K2.pcg_update"] += 1
    q = torch.sum(q_parts) if b is not None else None
    return (delta_out, r_out, r_out if z_out is None else z_out,
            torch.sum(rz_parts), q)


