#!/usr/bin/env python3
"""Smoke run of opt_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from opt_tpu_torch/csrc (one nvcc per source,
     all started together) and print the seconds;
  3. hold K1 warp_jtj_apply (GN and with LM's ctc), K2 pcg_update and K3
     warp_linearize against their plain torch versions on the card at
     512x512, on seeded inputs with one excluded pixel and a constraint
     band, time both with CUDA events, print the profiler's device
     time per launch of K1 and K3 in both modes beside their bounds
     (the kernels line's K1 and K3 rows), and call K3 in both modes
     twice, bit for bit;
  4. run the first path: image_warping 512x512, Gauss-Newton 8 outer x
     400 PCG iterations, through NewState(device="cuda") ... plan.solve
     with engine="auto"; check that it picked the CUDA engine, that every
     kernel launched the expected number of times inside that solve (one
     K13 resident_pcg an outer step, each on its on-chip form, K3 for the
     outer steps, no K1 and no K2), and that the final cost matches the JAX
     package's CPU value, and
     the plain torch engine's on the same card at 2x100 the CUDA
     engine's;
  5. time warm solves of the CUDA engine (best of 3) beside the plain
     engine's one timed 2x100 solve of phase 4, and profile one
     CUDA-engine solve: device time by kernel and the device's busy
     share;
  6. hold the slice-2 kernels and modes against their plain versions at
     2048x2048: K4 warp_hat_apply (GN, and LM with scs), K5
     warp_pipelined_sweep (GN, and its LM mode), K1 (GN and with LM's
     ctc, and the profiler's device time per launch of both beside its
     bound), K3 in each mode (J^T F and diag, cost only, model cost: each
     twice, bit for bit, and its device time per launch beside its bound),
     K2's hat mode (GN and LM);
  7. run the slice-2 paths through engine="auto", each with its own
     launch counts zeroed just before it and read just after, its final
     cost held against the JAX package's CPU value:
       2048x2048 GN 8x100  -> "stream", classic (K4 + K2 hat, K3),
       2048x2048 LM 8x100  -> "stream", classic (K4 + K2 hat, K3),
       2048x2048 GN 8x100 with stream_variant pipelined
                           -> "stream", pipelined (K4 + K5, K3),
       512x512   LM 8x400  -> "cuda" (K1 + ctc, K2 with q, K3);
     and time each path's warm solve (best of 3);
  8. the card's own crossover, GN and LM 8x100 at 1024x1024 and
     2048x2048: warm solves of engine="stream" and engine="cuda" (best of
     3 each), and one profiled solve of each engine and kind at
     2048x2048;
  9. hold the slice-3 kernels and modes against their plain versions at
     37x23x11 and 128^3: K6 vol_hat_apply (GN and LM, with and without
     p_prev), K7 vol_pipelined_sweep (GN and LM), K8 vol_linearize (J^T F
     and diag, cost only, model cost; each twice, bit for bit); and at
     128^3 the profiler's device time per launch of K6 and K8 in each mode
     beside its bound;
 10. run the slice-3 paths, volumetric ARAP at 128^3, 8x100, on
     bench.aux_volumetric's inputs, each with its own launch counts, its
     final cost against the JAX package's CPU value and its warm solve
     (best of 3):
       GN through engine="auto"          -> "stream3d", classic (K6 + K2 hat),
       GN with stream_variant pipelined  -> "stream3d", pipelined (K6 + K7),
       LM through engine="auto"          -> "stream3d", classic (K6 + K2 hat),
       LM with stream_variant pipelined  -> "stream3d", pipelined (K6 + K7),
     all with K8 for the outer step; and profile each of the four;
 11. hold the slice-4 kernels against their plain versions on arap's
     partials at the path's 102x102 triangulated mesh (10,404 vertices,
     61,610 edges) and on a 512x512 one (262,144 vertices, 1,568,770
     edges): K9 graph_gather (f32 and f64), K10 graph_scatter (f32 and
     f64), K11 graph_hat_apply's edge pass (with and without p_prev), its
     vertex pass on the edge pass's rows and the whole apply (GN and LM,
     with and without p_prev), the bytes K11's two passes move beside its
     bound and each pass's device time per launch, with
     the one PyTorch call that computes K9's and K10's function
     (index_select, index_add_) timed beside them and each kernel's share
     of its bound; K9 bit for bit its plain version and K10 bit for bit
     the edge-order sum on the CPU (and itself on a second call) at
     C = 1-8 and 11, f32 and f64, aligned and unaligned bases; the
     profiler's device time per launch of K9, K10,
     index_select and index_add_; and at 10k the host microseconds per
     call of each layer (the C entry, the wrapper, the torch.library
     operator, gather() alone and under torch.func.vjp, its transpose)
     beside the library calls', with the profiler's CPU rows of one call;
 12. run the slice-4 paths, arap_mesh_deformation 8x100 on bench.aux_arap's
     mesh (10,404 vertices) with non-rigid constraint offsets
     (arap_inputs), each with its own launch counts, its final cost
     against the JAX package's float64 CPU value, its warm solve (best of
     3) and a profile:
       10k GN through engine="auto"   -> "graph" (K11 + K2 hat, K9, K10),
       10k LM through engine="auto"   -> "graph",
       262k GN through engine="auto"  -> "graph" (the 512x512 mesh);
     then the 10k GN on engine="torch" (K9 and K10 inside the evaluator's
     gathers), and bench.aux_arap's own inputs, whose optimum is a rigid
     motion, on "auto" (final cost below 1e-6);
 13. hold the slice-5 kernels against their plain versions, at a ragged
     37x23 with excluded pixels and at the paths' sizes, agreement after
     RESIDENT_CHECK_ITERS iterations at every size (float32 rounding of
     two loops that sum in different orders grows with the iterations,
     so one tolerance holds at one count), times at the paths' iteration
     counts (the plain loop once, after the check has warmed it):
     K12 poisson_cg (C = 1 and C = 4 with an all-zero channel), K13
     resident_pcg (the image_warping and the poisson hat applies; warp also
     at 2048x2048, the cuda engine's GN there, on the L2 form; warp at
     512x512 on both forms, the on-chip one its grid takes and the L2 one,
     each with its us an iteration, its share of the bound and ptxas's
     registers, shared memory and spills), each with the profiler's
     device time a launch and an iteration beside its bound and its grid
     syncs (2 an iteration), K14
     stencil_apply (the JAX test's shapes and taps, radius 2, 4096x4096,
     with torch.nn.functional.conv2d timed beside it, TF32 off);
 14. run the slice-5 paths, each with its own launch counts, its final
     cost against the JAX package's CPU value and its warm solve (best of
     3):
       poisson 512x512, 400 CG iterations  -> PoissonCudaSolver (1 K12),
       poisson 2048x2048, 100 iterations   -> PoissonCudaSolver (1 K12),
       image_warping 512x512 GN 8x400      -> StreamSolver (8 K13 on the
                                              on-chip form, K3),
                                              beside the cuda engine (8
                                              K13, K3 too),
       poisson 512x512 GN 8x100            -> StreamSolver (8 K13),
       a 4096x4096 stencil                 -> stencil_apply (1 K14);
     and profile each of them;
 15. hold the slice-6 kernels against their plain versions at the sharded
     paths' slab shapes, 2048x2048 and 128^3 on 4 slabs (the first, two
     interior and the last slab each held on its own): K15
     warp_slab_apply, K3's global-offset mode (J^T F and diag, cost only,
     model cost), K16 vol_slab_apply, K8's global-offset mode, K3's and
     K8's modes each twice, bit for bit, and the profiler's device time per
     launch of K15, K16 and each mode of K3 and K8 beside their bounds;
 16. run the slice-6 paths through Plan.solve(inputs, mesh=make_mesh(4)),
     the slab form of a mesh on the one card, each with its own launch
     counts (K15 or K16 against the count its loops make), its final cost
     against the single-card engine's in the same run and the JAX
     package's CPU value, its warm solve (best of 3) beside the
     single-card engine's, and a profile:
       2048x2048 GN 8x100, "stream" pipelined and classic (K15, K3),
       2048x2048 LM 8x100, "stream" (K15, K3),
       128^3 GN 8x100, "stream3d" classic and pipelined (K16, K8),
       256x256 GN 2x20, "halo" (the plain evaluator, against "torch");
 17. print {"kernels": [...]} (K1-K16: launches over the paths, agreement,
     times, and the bound: the least time the card could take for each
     kernel's bytes and operations) and, last, {"ok": true, "device":
     {...}}.

Exits non-zero, printing no result, where torch sees no CUDA device.
"""

import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
W = H = 512
N_OUTER, N_LINEAR = 8, 400
# the plain engine's check on the main path, at a cut depth
TORCH_OUTER, TORCH_LINEAR = 2, 100
# opt_tpu (JAX, CPU) final cost of the same solve: warp_inputs(512, 512),
# image_warping, gaussNewtonGPU 8x400, plan.solve(..., engine="xla").
# Regenerate with
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu'); \
#     import opt_tpu, bench; from opt_tpu import energies; \
#     s = opt_tpu.NewState(); p = s.problem_plan(s.problem_define( \
#     energies.image_warping, 'gaussNewtonGPU'), [512, 512]); \
#     p.set_solver_parameter('nIterations', 8); \
#     p.set_solver_parameter('lIterations', 400); \
#     print(repr(p.solve(bench.warp_inputs(512, 512), engine='xla')))"
JAX_CPU_FINAL_COST = 8170.7724609375
# The slice-2 paths: (label, solver kind, size, outer, PCG iterations,
# Plan.stream_variant, the engine and stream variant engine="auto" must
# pick, the opt_tpu (JAX, CPU) final cost).  Each cost is the command above with the kind, size and
# iteration counts changed ('LMGPU' for LM; 2048 and 100 for the large
# grid); they took 24 s, 140 s and 153 s on a CPU.
PATHS = (
    ("2048 GN", "gaussNewtonGPU", 2048, 8, 100, None, "stream", "classic",
     129813.453125),
    ("2048 LM", "LMGPU", 2048, 8, 100, None, "stream", "classic",
     129824.890625),
    ("512 LM", "LMGPU", 512, 8, 400, None, "cuda", None, 8171.9326171875),
    ("2048 GN pipelined", "gaussNewtonGPU", 2048, 8, 100, "pipelined",
     "stream", "pipelined", 129813.453125),
)
BIG = 2048
# the whole-solve kernel's own parity bound (docs/GUIDE.md:204-207)
COST_RTOL = 2e-4
# kernel vs plain torch on the same inputs, as max|a - b| / max|b| over
# each output: f32 sums taken in another order (per-block trees vs torch's
# reductions) and FMA contraction differ by a few ulp of the largest term
KERNEL_RTOL = 1e-5
TIMING_REPS = 200
BIG_TIMING_REPS = 20
# The slice-3 paths: volumetric ARAP at VOL^3 on volume_inputs(VOL), 8 outer
# x 100 PCG.  (label, solver kind, Plan.stream_variant, the variant that
# engine="auto" must run, the opt_tpu (JAX, CPU) final cost).  The costs
# are the JAX package's solves in double precision: its float32 solves on
# the CPU end 3.0e-4 (GN, 52.11311340332031) and 3.1e-4 (LM,
# 52.15800476074219) away from them, more than COST_RTOL, where the TPU's
# float32 XLA solve of the same GN problem ends at 52.1288
# (BENCH_r05.json) and the port's on an H100, whose sums are per-block
# trees, within 7e-6.  Each cost is
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu'); \
#     import opt_tpu, chip_smoke; from opt_tpu import energies; \
#     s = opt_tpu.NewState(double_precision=True); \
#     p = s.problem_plan(s.problem_define( \
#     energies.volumetric_mesh_deformation, 'gaussNewtonGPU'), \
#     [128, 128, 128]); p.set_solver_parameter('nIterations', 8); \
#     p.set_solver_parameter('lIterations', 100); \
#     print(repr(p.solve(chip_smoke.volume_inputs(128), engine='xla')))"
# with 'LMGPU' for LM; they took 685 s and 709 s on a CPU.
VOL = 128
VOL_OUTER, VOL_LINEAR = 8, 100
VOL_PATHS = (
    ("128^3 GN", "gaussNewtonGPU", None, "classic", 52.12877722531129),
    ("128^3 GN pipelined", "gaussNewtonGPU", "pipelined", "pipelined",
     52.12877722531129),
    ("128^3 LM", "LMGPU", None, "classic", 52.1739656981525),
    ("128^3 LM pipelined", "LMGPU", "pipelined", "pipelined",
     52.1739656981525),
)
# the odd-sized volume of the slice-3 kernel checks: ragged 32x8 blocks
SMALL_VOL = (37, 23, 11)
# The slice-6 paths: Plan.solve(inputs, mesh=make_mesh(SHARD_SLABS)), the
# slab form of a mesh on the one card.  (label, energy, solver kind, size
# (a side), outer, PCG iterations, engine, Plan.stream_variant, the variant
# it must run, the single-card engine it is held against, that rtol, and
# the JAX package's CPU constant, or None.)  The streamed paths are the
# slice-2 and slice-3 paths cut into slabs (bench.py's aux_large_grid and
# aux_volumetric), held to the reference's sharded tolerances
# (docs/GUIDE.md:204-207); the halo path shows that the plain evaluator
# runs over the slabs on the card, against the torch engine.
SHARD_SLABS = 4
SHARD_PATHS = (
    ("2048 GN pipelined", "image_warping", "gaussNewtonGPU", BIG, 8, 100,
     "stream", "pipelined", "pipelined", "stream", 2e-5, PATHS[0][-1]),
    ("2048 GN classic", "image_warping", "gaussNewtonGPU", BIG, 8, 100,
     "stream", None, "classic", "stream", 2e-5, PATHS[0][-1]),
    ("2048 LM", "image_warping", "LMGPU", BIG, 8, 100, "stream", None,
     "classic", "stream", 2e-5, PATHS[1][-1]),
    ("128^3 GN", "volumetric_mesh_deformation", "gaussNewtonGPU", VOL, 8,
     100, "stream3d", None, "classic", "stream3d", 5e-4,
     VOL_PATHS[0][-1]),
    ("128^3 GN pipelined", "volumetric_mesh_deformation", "gaussNewtonGPU",
     VOL, 8, 100, "stream3d", "pipelined", "pipelined", "stream3d", 5e-4,
     VOL_PATHS[1][-1]),
    ("256 GN halo", "image_warping", "gaussNewtonGPU", 256, 2, 20, "halo",
     None, None, "torch", 2e-5, None),
)
# The slice-4 paths: arap_mesh_deformation on bench.aux_arap's mesh
# (MESH x MESH triangulated grid, 10,404 vertices, 61,610 edges) and on a
# BIG_MESH x BIG_MESH one (262,144 vertices, 1,568,770 edges), with
# arap_inputs's non-rigid constraints, 8 outer x 100 PCG.  (label, solver
# kind, mesh side, the opt_tpu (JAX, CPU) final cost.)  The costs are the
# JAX package's float64 take-mode solves; its float32 ones end at
# 4.510349273681641 (GN) and 4.510351181030273 (LM) on the 10k mesh.
# Each cost is
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu'); \
#     import opt_tpu, chip_smoke; from opt_tpu import energies; \
#     s = opt_tpu.NewState(double_precision=True, graph_mode='take'); \
#     n, e = chip_smoke.MESH ** 2, len(chip_smoke.tri_grid_graph( \
#     chip_smoke.MESH, chip_smoke.MESH)[0]); \
#     p = s.problem_plan(s.problem_define( \
#     energies.arap_mesh_deformation, 'gaussNewtonGPU'), [n, e]); \
#     p.set_solver_parameter('nIterations', 8); \
#     p.set_solver_parameter('lIterations', 100); \
#     print(repr(p.solve(chip_smoke.arap_inputs(chip_smoke.MESH))))"
# with 'LMGPU' for LM, and with 512 for MESH on the large mesh; they took
# 5 s, 4 s and 93 s on a CPU.
MESH = 102
BIG_MESH = 512
GRAPH_OUTER, GRAPH_LINEAR = 8, 100
GRAPH_PATHS = (
    ("arap 10k GN", "gaussNewtonGPU", MESH, 4.51035004886643),
    ("arap 10k LM", "LMGPU", MESH, 4.51035118484883),
    ("arap 262k GN", "gaussNewtonGPU", BIG_MESH, 3.6967314268856386),
)
# bench.aux_arap's own constraints move the mesh rigidly: the optimum's
# cost is zero, so the check is absolute
RIGID_COST_MAX = 1e-6
# The H100 SXM's published peaks (NVIDIA's data sheet): device memory
# and float32 outside the tensor cores, for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per pixel, voxel or element of each kernel and mode, counted
# from its source with a sincosf taken as 40: K4 and K5 evaluate five
# rotations a pixel, K7 seven rotations (21 sincosf) and twelve derivative
# products a voxel, K2 a few per element.  K1, K3, K15, K6, K8 and K16
# count the function's work, which their march and tile cores do.  K1:
# one rotation a pixel (40) and four residuals (each G = R'(a) e, jp and
# both halves, about 26), the fit, LM's ctc and the dot (16); K15 the
# same, with sq . p in and sq . a out and no dot.  K3: one rotation a
# pixel and four residuals (the value, 12; G, J^T F's and diag's halves
# and r^2, about 24 more in full mode, 12 for the model cost's J delta),
# the fit and the output.  K6 and K16: one rotation a voxel (3 sincosf and
# its derivatives, 155) and six residuals (each G = dR/da e, jv and both
# halves, about 110), the fit and the output (45).  K8: one rotation a
# voxel and six residuals (the value, 33; in full mode G, J^T F's and
# diag's halves, about 72 more; the model cost's J delta, 45 more), the
# fit and the output.
OPS = {"warp_jtj_apply": 160, "warp_slab_apply": 166,
       "warp_linearize": 200, "warp_linearize(cost)": 100,
       "warp_linearize(model_cost)": 150, "warp_hat_apply": 300,
       "warp_pipelined_sweep": 320, "pcg_update": 12, "vol_hat_apply": 860,
       "vol_pipelined_sweep": 1650, "vol_linearize": 820,
       "vol_linearize(cost)": 370, "vol_linearize(model_cost)": 640,
       # per element (K12, K13 poisson) or pixel (K13 warp) an iteration:
       # the apply, the two dots (4) and the three vector updates (6).
       # Poisson's apply counts what the function needs: J^T J p as
       # 2 (deg p - the sum of the in-domain neighbours), 6, times keep
       # (K12, 1) or sq on the way in and out (K13, 2).  K13 warp: K15's
       # apply (166) and, for its three components, the two dots and the
       # three updates (30): the function's work, not the five rotations a
       # pixel of the gather form it once ran
       "poisson_cg": 17, "resident_pcg(poisson)": 18,
       "resident_pcg(warp)": 196}
# The slice-5 paths, on poisson_inputs (a copy of
# tests/test_stream_solver._poisson_inputs; a test holds the two equal).
# PoissonCudaSolver: (label, size, CG iterations, the JAX package's
# PoissonPallasSolver final cost in interpret mode on a CPU, float32;
# its float64 values, 275.2935260754403 and 1114.6071093992073, lie
# 1.9e-5 and 2.0e-5 away).  Each is
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu'); \
#     import opt_tpu, chip_smoke; from opt_tpu import energies; \
#     from opt_tpu.ops.poisson_pallas import PoissonPallasSolver; \
#     s = opt_tpu.NewState(); p = s.problem_plan(s.problem_define( \
#     energies.poisson_image_editing, 'gaussNewtonGPU'), [512, 512]); \
#     print(repr(PoissonPallasSolver(p).solve( \
#     chip_smoke.poisson_inputs(512, 512), n_iters=400)['final_cost']))"
# with 2048 and 100 for the large grid; they took 6 s and 17 s.
POISSON_CG_PATHS = (
    ("poisson 512 CG", 512, 400, 275.2882385253906),
    ("poisson 2048 CG", 2048, 100, 1114.584716796875),
)
# StreamSolver: (label, energy, size, outer, PCG iterations, the JAX
# package's final cost).  image_warping's is JAX_CPU_FINAL_COST; poisson's
# is its float64 plan.solve(engine='xla') at 8x100 (33 s on a CPU; the
# float32 one ends at 275.288330078125, 1.9e-5 away).
RESIDENT_PATHS = (
    ("warp 512 GN resident", "image_warping", W, N_OUTER, N_LINEAR,
     JAX_CPU_FINAL_COST),
    ("poisson 512 GN resident", "poisson_image_editing", W, 8, 100,
     275.29355245957834),
)
# the slice-5 kernel checks: a ragged (W, H) with excluded pixels, and
# the iterations after which K12 and K13 are held against their plain
# loops (past where a stale neighbour read across a grid sync shows)
SMALL_POISSON = (37, 23)
RESIDENT_CHECK_ITERS = 50
# K14's taps: tests/test_halo_stencil.py's, and a radius-2 set
STENCIL_TAPS = {
    "radius1": (((1, 0), (-1, 0), (0, 1), (0, -1), (0, 0)),
                (1.0, 2.0, -1.0, 0.5, 4.0)),
    "radius2": (((2, 0), (-2, 1), (0, 2), (1, -2), (0, 0), (-1, -1)),
                (0.25, -1.5, 3.0, 0.75, -2.0, 1.25)),
}
STENCIL_SHAPES = ((64, 128), (100, 200), (33, 450))
BIG_STENCIL = 4096
STENCIL_REPS = 20
# the port's kernels as the profiler names them
KERNEL_SYMBOLS = (
    "warp_jtj_apply_kernel", "warp_linearize_kernel", "pcg_update_kernel",
    "warp_hat_apply_kernel", "warp_pipelined_sweep_kernel",
    "vol_hat_apply_kernel", "vol_pipelined_sweep_kernel",
    "vol_linearize_kernel", "graph_gather_", "graph_scatter_",
    "graph_hat_edge_kernel", "graph_hat_vertex_kernel", "pcg_kernel<",
    "warp_pcg_kernel",
    "stencil_kernel",
    "warp_slab_apply_kernel", "vol_slab_apply_kernel")


def warp_inputs(W, H, seed=0):
    """The main path's inputs: a copy of bench.warp_inputs (a test holds
    the two equal)."""
    rng = np.random.RandomState(seed)
    ur = rng.randn(H, W, 2).astype(np.float32)
    cons = np.full((H, W, 2), -1.0, np.float32)
    # constraint band: ~5% of pixels pinned to mutually inconsistent targets
    # (keeps the optimum nonzero so divergence would be visible in the cost)
    cons[::20, :] = np.abs(rng.randn(H, W, 2).astype(np.float32))[::20, :]
    mask = np.zeros((H, W, 1), np.float32)
    return {
        "Offset": np.zeros((H, W, 2), np.float32),
        "Angle": np.zeros((H, W, 1), np.float32),
        "UrShape": ur,
        "Constraints": cons,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(0.5),
        "w_regSqrt": np.sqrt(2.0),
    }


def volume_inputs(n, seed=0):
    """The volumetric paths' inputs at n^3: a copy of the ones
    bench.aux_volumetric builds inline (a test holds the two equal).  A
    regular grid, the H = 0 plane pinned where it is and the H = n - 1
    plane pulled by (2.5, -2.5, 0); every other voxel unconstrained
    (-inf)."""
    rng = np.random.RandomState(seed)
    ii, jj, kk = np.meshgrid(
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        indexing="ij",
    )
    grid = np.stack([ii, jj, kk], axis=-1)
    cons = np.full_like(grid, -np.inf)
    cons[:, 0] = grid[:, 0]
    cons[:, n - 1] = grid[:, n - 1] + np.array([2.5, -2.5, 0.0],
                                               np.float32)
    return {
        "Offset": grid + 0.01 * rng.randn(*grid.shape).astype(np.float32),
        "UrShape": grid.copy(),
        "Angle": np.zeros_like(grid),
        "Constraints": cons.astype(np.float32),
        "w_fitSqrt": np.sqrt(1.0),
        "w_regSqrt": np.sqrt(0.05),
    }


def tri_grid_graph(w, h):
    """Triangulated-grid mesh edges, both orientations: a copy of
    bench.tri_grid_graph (a test holds the two equal)."""
    vid = np.arange(w * h).reshape(h, w)
    pairs = [
        (vid[:, :-1].ravel(), vid[:, 1:].ravel()),
        (vid[:-1, :].ravel(), vid[1:, :].ravel()),
        (vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()),
    ]
    v0 = np.concatenate([a for a, b in pairs] + [b for a, b in pairs])
    v1 = np.concatenate([b for a, b in pairs] + [a for a, b in pairs])
    return v0.astype(np.int32), v1.astype(np.int32)


def arap_inputs(w, seed=0, rigid=False):
    """bench.aux_arap's inputs on a w x w mesh (a test holds the two equal
    at rigid=True): 200 vertices constrained, the rest free (-1e7).  There
    every constraint is its vertex moved by (0.1, 0.1, 0.1), a rigid
    motion whose cost is zero; by default each gets its own offset,
    0.1 * randn drawn after bench's draws, so the optimum is non-rigid."""
    v0, v1 = tri_grid_graph(w, w)
    n = w * w
    rng = np.random.RandomState(seed)
    ur = rng.randn(n, 3).astype(np.float32)
    cons = np.full((n, 3), -1e7, np.float32)
    sel = rng.choice(n, 200, replace=False)
    if rigid:
        cons[sel] = ur[sel] + 0.1
    else:
        cons[sel] = ur[sel] + 0.1 * rng.randn(200, 3).astype(np.float32)
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, 3), np.float32),
        "UrShape": ur, "Constraints": cons,
        "w_fitSqrt": 2.0, "w_regSqrt": 1.0,
        "G": {"v0": v0, "v1": v1},
    }


def kernel_inputs(W, H, seed=1):
    """Seeded operands for the kernel checks: a non-zero linearization
    point, one excluded pixel and a constraint band."""
    rng = np.random.RandomState(seed)
    inp = warp_inputs(W, H, seed)
    inp["Offset"] = (0.1 * rng.randn(H, W, 2)).astype(np.float32)
    inp["Angle"] = (0.3 * rng.randn(H, W, 1)).astype(np.float32)
    inp["Mask"][H // 2, W // 3] = 1.0
    vecs = {k: rng.randn(3 * H * W).astype(np.float32)
            for k in ("p", "ap", "delta", "r", "b")}
    vecs["pre"] = rng.rand(3 * H * W).astype(np.float32)
    return inp, vecs


def kernel_operands(torch, W, H, dev, seed=1):
    """kernel_inputs on the device: (x, ur, cons, mask, params, vectors).
    p is masked, as the solver's search directions are; sq = sqrt(pre) is
    zero at the excluded pixel and scs = sq^2 ctc, as the LM solver forms
    them for the hat space; ctc > 0 is LM's CtC diagonal."""
    from opt_tpu_torch.ops import warp_cuda

    inp, vecs = kernel_inputs(W, H, seed)
    t = {k: torch.as_tensor(v, device=dev) for k, v in vecs.items()}
    x = torch.cat([torch.as_tensor(inp[n], device=dev).reshape(-1)
                   for n in ("Offset", "Angle")])
    ur, cons, mask = (torch.as_tensor(inp[n], device=dev)
                      for n in ("UrShape", "Constraints", "Mask"))
    params = torch.tensor([inp["w_fitSqrt"], inp["w_regSqrt"]],
                          dtype=torch.float32, device=dev)
    keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
    zero = torch.zeros((), device=dev)
    t["p"] = torch.where(keep, t["p"], zero)
    t["ctc"] = 0.5 + t["pre"]
    t["sq"] = torch.where(keep, torch.sqrt(t["pre"]), zero)
    t["scs"] = t["sq"] * t["sq"] * t["ctc"]
    return x, ur, cons, mask, params, t


def rel_err(got, want):
    """(max|got - want| / max|want|, max|got - want|) over paired outputs."""
    rel = absmax = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        d = float((g - w).abs().max())
        rel = max(rel, d / max(float(w.abs().max()), 1e-30))
        absmax = max(absmax, d)
    return rel, absmax


def cuda_ms(torch, fn, reps=TIMING_REPS, warmup=3):
    """Mean device milliseconds per call of fn, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*tensors):
    """Bytes of the given tensors (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take for a
    kernel that moves n_bytes (each input read once, each output written
    once) and does n_ops float32 operations, at the published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_cases(torch, cases, reps):
    """Each case (kernel, plain, bytes, operations) on the same inputs:
    agreement within KERNEL_RTOL, both timed, and the kernel's bound.
    name -> {max_abs_err, ms, plain_ms, bound_ms, bound_by}."""
    out = {}
    for name, (kern, plain, n_bytes, n_ops) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        rel, absmax = rel_err(got, want)
        ok = rel <= KERNEL_RTOL
        ms, plain_ms = cuda_ms(torch, kern, reps), cuda_ms(torch, plain, reps)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"kernel {name}: max rel err {rel:.3e} (tol {KERNEL_RTOL:.0e})"
              f" max abs err {absmax:.3e}  {ms * 1e3:.1f} us vs plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}, {n_bytes / 1e6:.1f} MB)  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        out[name] = {"max_abs_err": absmax, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def check_kernels(torch, dev):
    """Phase 3: each slice-1 kernel vs its plain version at 512x512."""
    from opt_tpu_torch.ops import pcg_update as k2
    from opt_tpu_torch.ops import warp_cuda

    x, ur, cons, mask, params, t = kernel_operands(torch, W, H, dev)
    p = t["p"]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    consts = nbytes(ur, cons, mask, params)
    angle = x[2 * W * H:]
    px, n = W * H, p.numel()
    cases = {
        **jtj_apply_cases(warp_cuda, x, ur, cons, mask, params, t,
                          ("warp_jtj_apply", "warp_jtj_apply(ctc, 512)")),
        "warp_linearize": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask,
                                                   params),
            consts + nbytes(x, x, x), OPS["warp_linearize"] * px),
        "warp_linearize(cost_only)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                             cost_only=True),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                                   cost_only=True),
            consts + nbytes(x), OPS["warp_linearize(cost)"] * px),
        "pcg_update": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  t["pre"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], t["pre"]),
            8 * nbytes(p), OPS["pcg_update"] * n),
        "pcg_update(lm)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  t["pre"], t["b"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], t["pre"], t["b"]),
            9 * nbytes(p), OPS["pcg_update"] * n),
    }
    out = check_cases(torch, cases, TIMING_REPS)
    device_vs_bound(torch, out, {k: cases[k][0] for k in cases
                                 if k.startswith("warp_jtj_apply")},
                    "warp_jtj_apply_kernel", f"{W}x{H}")
    outer = [k for k in cases if k.startswith("warp_linearize")]
    check_repeats(torch, cases, outer)
    # K3 at the main path's grid: the kernels line's row
    device_vs_bound(torch, out, {k: cases[k][0] for k in outer},
                    "warp_linearize_kernel", f"{W}x{H}")
    return out


def jtj_apply_cases(warp_cuda, x, ur, cons, mask, params, t, names):
    """K1's check cases, GN and with LM's ctc, under the two names:
    (kernel, plain, bytes, operations)."""
    H, W = mask.shape[:2]
    p, angle = t["p"], x[2 * H * W:]
    cases = {}
    for name, ctc in zip(names, (None, t["ctc"])):
        cases[name] = (
            lambda ctc=ctc: warp_cuda.warp_jtj_apply(x, p, ur, cons, mask,
                                                     params, ctc),
            lambda ctc=ctc: warp_cuda.warp_jtj_apply_plain(
                x, p, ur, cons, mask, params, ctc),
            nbytes(ur, cons, mask, params, angle, p, ctc, p),
            OPS["warp_jtj_apply"] * H * W)
    return cases


def sweep_case(torch, fn, consts, t, alpha, beta, b_hat=None):
    """A pipelined sweep (K5 or K7, or its plain version) as a callable
    that runs one sweep in place on its own copy of the state (so a kernel
    and its plain version agree on their first calls; the timing's later
    calls carry that state on).  consts: the operands before w_in."""
    z, s, p, d, r = (t[k].clone() for k in ("ap", "b", "p", "delta", "r"))
    w_out = torch.empty_like(r)

    def call():
        g, dd, q = fn(*consts, t["pre"], w_out, z, s, p, d, r, alpha, beta,
                      b_hat=b_hat)
        return g, dd, q, w_out, z, s, p, d, r
    return call


def check_big_kernels(torch, dev):
    """Phase 6: the slice-2 kernels and modes vs their plain versions at
    2048x2048."""
    from opt_tpu_torch.ops import pcg_update as k2
    from opt_tpu_torch.ops import stream_cuda, warp_cuda

    x, ur, cons, mask, params, t = kernel_operands(torch, BIG, BIG, dev)
    p, sq, scs = t["p"], t["sq"], t["scs"]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    hat = stream_cuda.warp_hat_apply
    hat_plain = stream_cuda.warp_hat_apply_plain
    consts = nbytes(ur, cons, mask, params)
    angle = x[2 * BIG * BIG:]
    px, vec = BIG * BIG, nbytes(p)
    hat_ops = OPS["warp_hat_apply"] * px
    sweep_ops = OPS["warp_pipelined_sweep"] * px

    def sweeps(lm):
        consts_m = (x, ur, cons, mask, params, sq, scs if lm else None)
        return tuple(sweep_case(torch, fn, consts_m, t, alpha, beta,
                                t["b"] if lm else None)
                     for fn in (stream_cuda.warp_pipelined_sweep,
                                stream_cuda.warp_pipelined_sweep_plain))

    cases = {
        "warp_hat_apply(gn)": (
            lambda: hat(x, ur, cons, mask, params, sq, None, t["r"], p, beta),
            lambda: hat_plain(x, ur, cons, mask, params, sq, None, t["r"], p,
                              beta),
            consts + nbytes(angle) + 5 * vec, hat_ops),
        "warp_hat_apply(lm)": (
            lambda: hat(x, ur, cons, mask, params, sq, scs, t["r"], p, beta),
            lambda: hat_plain(x, ur, cons, mask, params, sq, scs, t["r"], p,
                              beta),
            consts + nbytes(angle) + 6 * vec, hat_ops),
        "warp_pipelined_sweep": (
            *sweeps(False), consts + nbytes(angle) + 13 * vec, sweep_ops),
        "warp_pipelined_sweep(lm)": (
            *sweeps(True), consts + nbytes(angle) + 15 * vec, sweep_ops),
        **jtj_apply_cases(warp_cuda, x, ur, cons, mask, params, t,
                          ("warp_jtj_apply(2048)",
                           "warp_jtj_apply(ctc, 2048)")),
        "warp_linearize(2048)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask,
                                                   params),
            consts + nbytes(x, x, x), OPS["warp_linearize"] * px),
        "warp_linearize(cost_only, 2048)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                             cost_only=True),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                                   cost_only=True),
            consts + nbytes(x), OPS["warp_linearize(cost)"] * px),
        "warp_linearize(model_cost)": (
            lambda: warp_cuda.warp_linearize(x, ur, cons, mask, params,
                                             delta=t["delta"]),
            lambda: warp_cuda.warp_linearize_plain(x, ur, cons, mask, params,
                                                   delta=t["delta"]),
            consts + nbytes(x) + vec, OPS["warp_linearize(model_cost)"] * px),
        "pcg_update(hat)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  None),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], None),
            6 * vec, OPS["pcg_update"] * p.numel()),
        "pcg_update(hat, lm)": (
            lambda: k2.pcg_update(alpha, p, t["ap"], t["delta"], t["r"],
                                  None, t["b"]),
            lambda: k2.pcg_update_plain(alpha, p, t["ap"], t["delta"],
                                        t["r"], None, t["b"]),
            7 * vec, OPS["pcg_update"] * p.numel()),
    }
    out = check_cases(torch, cases, BIG_TIMING_REPS)
    device_vs_bound(torch, out, {k: cases[k][0] for k in cases
                                 if k.startswith("warp_jtj_apply")},
                    "warp_jtj_apply_kernel", f"{BIG}x{BIG}")
    outer = [k for k in cases if k.startswith("warp_linearize")]
    check_repeats(torch, cases, outer)
    device_vs_bound(torch, out, {k: cases[k][0] for k in outer},
                    "warp_linearize_kernel", f"{BIG}x{BIG}")
    return out


def check_repeats(torch, cases, names):
    """Each named case's kernel twice on the same inputs: every output the
    same bit for bit (fixed-tree partials, no atomics)."""
    for name in names:
        a, b = cases[name][0](), cases[name][0]()
        both = zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b)))
        same = all((u is None and v is None) or (
            u is not None and v is not None and torch.equal(u, v))
            for u, v in both)
        print(f"kernel {name}: two calls "
              f"{'bit for bit' if same else 'DIFFER: FAIL'}")
        if not same:
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 "differ")


def volume_kernel_operands(torch, W, H, D, dev, seed=1):
    """Seeded operands for the volume kernel checks, on the device:
    (x, ur, cons, params, vectors).  Angles ~0.3 rad, about a third of the
    voxels fit-constrained (the rest -inf), sq = sqrt(pre) > 0 and
    scs = sq^2 ctc as the LM solver forms them for the hat space."""
    rng = np.random.RandomState(seed)
    shape = (D, H, W, 3)
    cons = np.full(shape, -np.inf, np.float32)
    pinned = rng.rand(D, H, W) < 0.3
    cons[pinned] = rng.randn(int(pinned.sum()), 3).astype(np.float32)
    x = np.concatenate((rng.randn(*shape).reshape(-1),
                        0.3 * rng.randn(*shape).reshape(-1)))
    n = x.size
    vecs = {k: rng.randn(n) for k in ("p", "ap", "delta", "r", "b")}
    vecs["pre"] = rng.rand(n)
    vecs["ctc"] = 0.5 + rng.rand(n)
    t = {k: torch.as_tensor(v.astype(np.float32), device=dev)
         for k, v in vecs.items()}
    t["sq"] = torch.sqrt(t["pre"])
    t["scs"] = t["sq"] * t["sq"] * t["ctc"]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (as_dev(x), as_dev(rng.randn(*shape)), as_dev(cons),
            as_dev([0.8, 1.3]), t)


def slab_operands(torch, W, H, n_slabs, dev, seed=1):
    """kernel_operands' image_warping grid cut into n_slabs extended slabs
    (the stream engine's halo, 2 rows), as the sharded engine hands them to
    K15 and K3's offset mode: (x, ur, cons, mask, params, vectors,
    geometry), x and every vector (S, 3 (n + 4) W), each slab's flat
    unknown layout over its rows."""
    from opt_tpu_torch.parallel.mesh import make_mesh

    x, ur, cons, mask, params, t = kernel_operands(torch, W, H, dev, seed)
    mesh, he, n = make_mesh(n_slabs, device=dev), 2, H // n_slabs

    def slabs(v):
        parts = (v[:2 * H * W].view(n_slabs, n, W, 2),
                 v[2 * H * W:].view(n_slabs, n, W, 1))
        return torch.cat([mesh.ext(a, he).reshape(n_slabs, -1)
                          for a in parts], dim=1)

    ext = lambda a: mesh.ext(mesh.shard(a), he).contiguous()
    return (slabs(x), ext(ur), ext(cons), ext(mask), params,
            {k: slabs(v) for k, v in t.items()}, (n, he, -he, H))


def vol_slab_operands(torch, W, H, D, n_slabs, dev, seed=1):
    """volume_kernel_operands' volume cut into n_slabs extended D slabs
    (halo 2 planes), as the sharded engine hands them to K16 and K8's
    offset mode: (x, ur, cons, params, vectors, geometry)."""
    from opt_tpu_torch.parallel.mesh import make_mesh

    x, ur, cons, params, t = volume_kernel_operands(torch, W, H, D, dev,
                                                    seed)
    mesh, he, n = make_mesh(n_slabs, device=dev), 2, D // n_slabs
    half = 3 * D * H * W

    def slabs(v):
        return torch.cat([mesh.ext(a.view(n_slabs, n, H, W, 3), he)
                          .reshape(n_slabs, -1)
                          for a in (v[:half], v[half:])], dim=1)

    ext = lambda a: mesh.ext(mesh.shard(a), he).contiguous()
    return (slabs(x), ext(ur), ext(cons), params,
            {k: slabs(v) for k, v in t.items()}, (n, he, -he, D))


def per_slab(v, S, shapes):
    """A local flat vector (every unknown's (S, ...) slabs in turn) as the
    tuple of each slab's parts, for per-slab agreement; a (S,) vector of
    per-slab costs as its S entries."""
    if v is None or v.numel() == S:
        return () if v is None else tuple(v)
    parts, o = [], 0
    for shape in shapes:
        size = S * int(np.prod(shape))
        parts.append(v[o:o + size].view(S, -1))
        o += size
    return tuple(p[s] for s in range(S) for p in parts)


def check_slab_kernels(torch, dev, reps):
    """Phase 15: K15 and K16 and the offset modes of K3 and K8 against
    their plain versions at the sharded paths' slab shapes (2048^2 and
    128^3 on SHARD_SLABS slabs), every slab held on its own (the first,
    the interior ones, the last)."""
    from opt_tpu_torch.ops import slab_cuda as sc

    S = SHARD_SLABS
    x, ur, cons, mask, params, t, g = slab_operands(torch, BIG, BIG, S, dev)
    n, he = g[:2]
    warp = [(n, BIG, 2), (n, BIG, 1)]
    split = lambda out: sum((per_slab(v, S, warp) for v in (
        out if isinstance(out, tuple) else (out,))), ())
    angle = x.view(S, 3, -1)[:, 2]  # each slab's Angle rows
    own_px, own_vec = S * n * BIG, 3 * S * n * BIG * 4
    # K15 reads one halo row a side of each extended slab (which holds he
    # a side) and Constraints at the own pixels alone
    ring = (n + 2) / (n + 2 * he)
    slab_apply_bytes = (int(ring * nbytes(ur, mask, angle, t["sq"], t["p"]))
                        + 8 * own_px + nbytes(params) + own_vec)

    def lin_bytes(own, face, out=0):
        """K3's offset mode reads `own` floats at each own pixel (Offset,
        Angle, UrShape, Mask, Constraints; delta in the model cost) and
        `face` on the one face row a side of each slab (Offset, UrShape,
        Mask; the Angle in full mode, delta's Offset in the model cost),
        and writes `out` bytes."""
        return (4 * (own * own_px + face * 2 * S * BIG) + nbytes(params)
                + out)

    cases = {
        "warp_slab_apply": (
            lambda: split(sc.warp_slab_apply(x, ur, cons, mask, params,
                                             t["sq"], t["p"], g)),
            lambda: split(sc.warp_slab_apply_plain(
                x, ur, cons, mask, params, t["sq"], t["p"], g)),
            slab_apply_bytes, OPS["warp_slab_apply"] * own_px),
        "warp_linearize(slab)": (
            lambda: split(sc.warp_slab_linearize(x, ur, cons, mask, params,
                                                 g)),
            lambda: split(sc.warp_slab_linearize_plain(
                x, ur, cons, mask, params, g)),
            lin_bytes(8, 6, 2 * own_vec), OPS["warp_linearize"] * own_px),
        "warp_linearize(slab, cost_only)": (
            lambda: split(sc.warp_slab_linearize(x, ur, cons, mask, params,
                                                 g, cost_only=True)),
            lambda: split(sc.warp_slab_linearize_plain(
                x, ur, cons, mask, params, g, cost_only=True)),
            lin_bytes(8, 5), OPS["warp_linearize(cost)"] * own_px),
        "warp_linearize(slab, model_cost)": (
            lambda: split(sc.warp_slab_linearize(
                x, ur, cons, mask, params, g, delta=t["delta"])),
            lambda: split(sc.warp_slab_linearize_plain(
                x, ur, cons, mask, params, g, delta=t["delta"])),
            lin_bytes(11, 7), OPS["warp_linearize(model_cost)"] * own_px),
    }
    print(f"slab kernels at {BIG}x{BIG} on {S} slabs of {n} rows "
          f"(halo {he}):")
    out = check_cases(torch, cases, reps)
    device_vs_bound(torch, out,
                    {"warp_slab_apply": cases["warp_slab_apply"][0]},
                    "warp_slab_apply_kernel", f"{BIG}x{BIG} on {S} slabs")
    outer = [k for k in cases if k.startswith("warp_linearize")]
    check_repeats(torch, cases, outer)
    device_vs_bound(torch, out, {k: cases[k][0] for k in outer},
                    "warp_linearize_kernel", f"{BIG}x{BIG} on {S} slabs")

    xv, urv, consv, paramsv, tv, gv = vol_slab_operands(
        torch, VOL, VOL, VOL, S, dev)
    n = gv[0]
    vol = [(n, VOL, VOL, 3)] * 2
    split = lambda out: sum((per_slab(v, S, vol) for v in (
        out if isinstance(out, tuple) else (out,))), ())
    angle = xv.view(S, 2, -1)[:, 1]
    own_vox, own_vec = S * n * VOL * VOL, 6 * S * n * VOL * VOL * 4
    # K16 reads one halo plane a side of each extended slab (which holds
    # gv[1] a side) and Constraints' channel 0 (its kFitValid test) on the
    # own planes alone
    ring = (n + 2) / (n + 2 * gv[1])
    slab_apply_bytes = (int(ring * nbytes(urv, angle, tv["sq"], tv["p"]))
                        + 4 * own_vox + nbytes(paramsv) + own_vec)

    def lin_bytes(own, face, out=0):
        """K8's offset mode reads `own` floats at each own voxel (Offset,
        Angle, UrShape, Constraints; delta in the model cost) and `face` on
        the one face plane a side of each slab (Offset, UrShape; the Angle
        in full mode, delta's Offset in the model cost), and writes `out`
        bytes."""
        return (4 * (own * own_vox + face * 2 * S * VOL * VOL)
                + nbytes(paramsv) + out)

    cases = {
        "vol_slab_apply": (
            lambda: split(sc.vol_slab_apply(xv, urv, consv, paramsv,
                                            tv["sq"], tv["p"], gv)),
            lambda: split(sc.vol_slab_apply_plain(
                xv, urv, consv, paramsv, tv["sq"], tv["p"], gv)),
            slab_apply_bytes, OPS["vol_hat_apply"] * own_vox),
        "vol_linearize(slab)": (
            lambda: split(sc.vol_slab_linearize(xv, urv, consv, paramsv,
                                                gv)),
            lambda: split(sc.vol_slab_linearize_plain(xv, urv, consv,
                                                      paramsv, gv)),
            lin_bytes(12, 9, 2 * own_vec), OPS["vol_linearize"] * own_vox),
        "vol_linearize(slab, cost_only)": (
            lambda: split(sc.vol_slab_linearize(
                xv, urv, consv, paramsv, gv, cost_only=True)),
            lambda: split(sc.vol_slab_linearize_plain(
                xv, urv, consv, paramsv, gv, cost_only=True)),
            lin_bytes(12, 6), OPS["vol_linearize(cost)"] * own_vox),
        "vol_linearize(slab, model_cost)": (
            lambda: split(sc.vol_slab_linearize(
                xv, urv, consv, paramsv, gv, delta=tv["delta"])),
            lambda: split(sc.vol_slab_linearize_plain(
                xv, urv, consv, paramsv, gv, delta=tv["delta"])),
            lin_bytes(18, 9), OPS["vol_linearize(model_cost)"] * own_vox),
    }
    print(f"slab kernels at {VOL}^3 on {S} slabs of {n} planes "
          f"(halo {gv[1]}):")
    out.update(check_cases(torch, cases, reps))
    device_vs_bound(torch, out, {"vol_slab_apply": cases["vol_slab_apply"][0]},
                    "vol_slab_apply_kernel", f"{VOL}^3 on {S} slabs")
    outer = [k for k in cases if k.startswith("vol_linearize")]
    check_repeats(torch, cases, outer)
    device_vs_bound(torch, out, {k: cases[k][0] for k in outer},
                    "vol_linearize_kernel", f"{VOL}^3 on {S} slabs")
    return out


def check_vol_kernels(torch, dev, dims, reps):
    """Phase 9: the slice-3 kernels and modes vs their plain versions on a
    (W, H, D) volume."""
    from opt_tpu_torch.ops import stream3d_cuda as s3, vol_cuda

    Wv, Hv, Dv = dims
    x, ur, cons, params, t = volume_kernel_operands(torch, Wv, Hv, Dv, dev)
    p, sq, scs = t["p"], t["sq"], t["scs"]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    voxels, vec = Wv * Hv * Dv, nbytes(p)
    consts = nbytes(ur, cons, params)
    # K6 and K7 read Constraints' channel 0 alone (its kFitValid test); K8
    # reads all three
    fit_consts = nbytes(ur, params) + nbytes(cons) // 3
    angle = x[x.numel() // 2:]
    hat_ops = OPS["vol_hat_apply"] * voxels
    sweep_ops = OPS["vol_pipelined_sweep"] * voxels
    lin_ops = OPS["vol_linearize"] * voxels
    cases = {}
    for lm in (False, True):
        mode = "lm" if lm else "gn"
        scs_m = scs if lm else None
        for prev in (True, False):
            extra = (p, beta) if prev else ()
            cases[f"vol_hat_apply({mode}{', p_prev' if prev else ''})"] = (
                lambda scs_m=scs_m, extra=extra: s3.vol_hat_apply(
                    x, ur, cons, params, sq, scs_m, t["r"], *extra),
                lambda scs_m=scs_m, extra=extra: s3.vol_hat_apply_plain(
                    x, ur, cons, params, sq, scs_m, t["r"], *extra),
                fit_consts + nbytes(angle) + (3 + 2 * prev + lm) * vec,
                hat_ops)
        consts_m = (x, ur, cons, params, sq, scs_m)
        b_hat = t["b"] if lm else None
        cases[f"vol_pipelined_sweep({mode})"] = (
            sweep_case(torch, s3.vol_pipelined_sweep, consts_m, t, alpha,
                       beta, b_hat),
            sweep_case(torch, s3.vol_pipelined_sweep_plain, consts_m, t,
                       alpha, beta, b_hat),
            fit_consts + nbytes(angle) + (13 + 2 * lm) * vec, sweep_ops)
    cases["vol_linearize"] = (
        lambda: vol_cuda.vol_linearize(x, ur, cons, params),
        lambda: vol_cuda.vol_linearize_plain(x, ur, cons, params),
        consts + 3 * vec, lin_ops)
    cases["vol_linearize(cost_only)"] = (
        lambda: vol_cuda.vol_linearize(x, ur, cons, params, cost_only=True),
        lambda: vol_cuda.vol_linearize_plain(x, ur, cons, params,
                                             cost_only=True),
        consts + vec, OPS["vol_linearize(cost)"] * voxels)
    cases["vol_linearize(model_cost)"] = (
        lambda: vol_cuda.vol_linearize(x, ur, cons, params, delta=t["delta"]),
        lambda: vol_cuda.vol_linearize_plain(x, ur, cons, params,
                                             delta=t["delta"]),
        consts + 2 * vec, OPS["vol_linearize(model_cost)"] * voxels)
    print(f"slice-3 kernels at {Wv}x{Hv}x{Dv}:")
    out = check_cases(torch, cases, reps)
    outer = [k for k in cases if k.startswith("vol_linearize")]
    check_repeats(torch, cases, outer)
    if dims == (VOL,) * 3:  # K6 and K8 in every mode, as the paths launch
        device_vs_bound(torch, out, {
            name: case[0] for name, case in cases.items()
            if name.startswith("vol_hat_apply")}, "vol_hat_apply_kernel",
            f"{Wv}x{Hv}x{Dv}")
        device_vs_bound(torch, out, {k: cases[k][0] for k in outer},
                        "vol_linearize_kernel", f"{Wv}x{Hv}x{Dv}")
    return out


def new_graph_plan(opt_tpu_torch, energies, kind, w, device=DEVICE,
                   n_outer=GRAPH_OUTER, n_linear=GRAPH_LINEAR):
    state = opt_tpu_torch.NewState(device=device)
    plan = state.problem_plan(
        state.problem_define(energies.arap_mesh_deformation, kind),
        [w * w, len(tri_grid_graph(w, w)[0])])
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


def graph_kernel_operands(torch, w, dev, seed=1):
    """Seeded operands for the graph kernel checks on a w x w mesh: the
    graph engine's tables with arap's own partials D at a point with
    angles of about 0.3 rad (arap_inputs, LM), and flat vectors r, p_prev,
    sq > 0 and scs = sq^2 ctc as the LM solver forms them."""
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import graph_cuda

    rng = np.random.RandomState(seed)
    inputs = arap_inputs(w, seed)
    inputs["Angle"] = (0.3 * rng.randn(w * w, 3)).astype(np.float32)
    plan = new_graph_plan(opt_tpu_torch, energies, "LMGPU", w, dev)
    x, data = plan.bind(inputs)
    op = graph_cuda.GraphOperator(plan.funcs, data, plan.layout, True,
                                  graph_cuda.plan_meta(plan))
    op.outer(x)
    n = x.numel()
    t = {k: torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
         for k in ("r", "p")}
    t["sq"] = torch.as_tensor(rng.rand(n).astype(np.float32), device=dev)
    ctc = torch.as_tensor((0.5 + rng.rand(n)).astype(np.float32),
                          device=dev)
    t["scs"] = t["sq"] * t["sq"] * ctc
    return op.tables, data, t


def scatter_in_edge_order(torch, x, order, rowptr):
    """K10's function as K10 sums it, on the CPU: out[w] = ((0 + x[e_1]) +
    x[e_2]) + ... over vertex w's run e_1, e_2, ... of the CSR incidence
    (order, rowptr), one rank of every run at a time."""
    x, order, rowptr = (t.cpu().long() if t.dtype == torch.int32 else t.cpu()
                        for t in (x, order, rowptr))
    deg = rowptr[1:] - rowptr[:-1]
    out = torch.zeros((deg.numel(),) + tuple(x.shape[1:]), dtype=x.dtype)
    for k in range(int(deg.max()) if deg.numel() else 0):
        w = torch.nonzero(deg > k).squeeze(1)
        out[w] += x[order[rowptr[w] + k]]
    return out


def check_graph_kernels(torch, dev, w, reps):
    """Phase 11: the slice-4 kernels and modes vs their plain versions on
    a w x w mesh.  name -> timings (check_cases), with library_ms for K9
    and K10."""
    from opt_tpu_torch.ops import graph_cuda as gc

    tab, data, t = graph_kernel_operands(torch, w, dev)
    beta = torch.tensor(0.61, dtype=torch.float32, device=dev)
    idx = tab.idx.view(2, -1)
    v0 = data["graph_indices"]["G"]["v0"]
    order, rowptr = data["graph_incidence"]["G"]["v0"]
    n_verts, n_edges = w * w, v0.numel()
    rng = np.random.RandomState(2)
    vec = nbytes(t["r"])
    n_leaves_res = sum(D.shape[0] for _, _, _, D, _ in tab.graph)
    fit_rows = tab.fit[3].shape[0]
    # two flops a multiply-add: each edge's tangent and its cotangent once,
    # each vertex's fit rows twice
    edge_ops = 4 * n_leaves_res * n_edges
    vertex_ops = tab.c.numel() + 4 * fit_rows * n_verts + 6 * t["r"].numel()
    hat_ops = edge_ops + vertex_ops
    # the function's least bytes (the bound): D, the edges' endpoints, the
    # group table and the vectors; the CSR incidence (order, rowptr) and
    # the c rows are what the two passes' design adds
    tables = nbytes(tab.D, tab.idx, tab.meta)
    graph_d = sum(nbytes(D) for _, _, _, D, _ in tab.graph)
    cases, library = {}, {}
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        v = torch.as_tensor(rng.randn(n_verts, 6), device=dev).to(dt)
        e = torch.as_tensor(rng.randn(n_edges, 6), device=dev).to(dt)
        out_g = torch.empty(2, n_edges, 6, dtype=dt, device=dev)
        cases[f"graph_gather({tag})"] = (
            lambda v=v: gc.graph_gather(v, idx),
            lambda v=v: gc.graph_gather_plain(v, idx),
            nbytes(v, idx, out_g), 0)
        library[f"graph_gather({tag})"] = (
            lambda v=v: torch.index_select(v, 0, idx.reshape(-1)))
        cases[f"graph_scatter({tag})"] = (
            lambda e=e: gc.graph_scatter(e, v0, order, rowptr),
            lambda e=e: gc.graph_scatter_plain(e, v0, n_verts),
            nbytes(e, order, rowptr, v), n_edges * 6)
        library[f"graph_scatter({tag})"] = (
            lambda e=e, v=v: torch.zeros_like(v).index_add_(0, v0, e))
    # K11's two passes, each against its plain version: the vertex pass
    # (kernel and plain) reads the rows in the tables' c buffer, as the
    # last edge pass left them
    for prev in (True, False):
        extra = (t["p"], beta) if prev else ()
        cases[f"graph_hat_apply(edge{', p_prev' if prev else ''})"] = (
            lambda extra=extra: [c for rows in gc.graph_hat_edge(
                tab, t["sq"], t["r"], *extra) for c in rows],
            lambda extra=extra: [c for rows in gc.graph_hat_edge_plain(
                tab, t["sq"], t["r"], *extra) for c in rows],
            graph_d + nbytes(tab.idx, tab.c) + (2 + prev) * vec, edge_ops)
    for lm in (False, True):
        mode = "lm" if lm else "gn"
        scs = t["scs"] if lm else None
        for prev in (True, False):
            extra = (t["p"], beta) if prev else ()
            cases[f"graph_hat_apply(vertex {mode}"
                  f"{', p_prev' if prev else ''})"] = (
                lambda scs=scs, extra=extra: gc.graph_hat_vertex(
                    tab, tab.c_rows, t["sq"], scs, t["r"], *extra),
                lambda scs=scs, extra=extra: gc.graph_hat_vertex_plain(
                    tab, tab.c_rows, t["sq"], scs, t["r"], *extra),
                nbytes(tab.D, tab.order, tab.rowptr, tab.meta, tab.c,
                       tab.partials) - graph_d + (3 + 2 * prev + lm) * vec,
                vertex_ops)
    for lm in (False, True):
        mode = "lm" if lm else "gn"
        scs = t["scs"] if lm else None
        for prev in (True, False):
            extra = (t["p"], beta) if prev else ()
            cases[f"graph_hat_apply({mode}{', p_prev' if prev else ''})"] = (
                lambda scs=scs, extra=extra: gc.graph_hat_apply(
                    tab, t["sq"], scs, t["r"], *extra),
                lambda scs=scs, extra=extra: gc.graph_hat_apply_plain(
                    tab, t["sq"], scs, t["r"], *extra),
                tables + (3 + 2 * prev + lm) * vec, hat_ops)
    print(f"slice-4 kernels at a {w}x{w} mesh ({n_verts} vertices, "
          f"{n_edges} edges, D {nbytes(tab.D) / 1e6:.1f} MB):")
    out = check_cases(torch, cases, reps)
    for name, fn in library.items():
        out[name]["library_ms"] = cuda_ms(torch, fn, reps)
        print(f"  library {name}: {out[name]['library_ms'] * 1e3:.1f} us")
    for name in library:
        print(f"  {name}: {100 * out[name]['bound_ms'] / out[name]['ms']:.1f}"
              f"% of its bound ({out[name]['ms'] * 1e3:.1f} us against "
              f"{out[name]['bound_ms'] * 1e3:.1f} us)")
    # K11 (GN, p_prev, as on the path): the bytes its two passes move
    # beside the function's bound, and each launch's device time
    apply = "graph_hat_apply(gn, p_prev)"
    design = (nbytes(tab.D, tab.idx, tab.order, tab.rowptr, tab.meta,
                     tab.partials) + 2 * nbytes(tab.c) + 5 * vec)
    print(f"  graph_hat_apply's two passes move {design / 1e6:.1f} MB "
          f"(the c rows {nbytes(tab.c) / 1e6:.1f} MB written and read), "
          f"{design / HBM_BYTES_PER_S * 1e6:.1f} us at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, beside the function's bound "
          f"{out[apply]['bound_ms'] * 1e3:.1f} us "
          f"({(tables + 5 * vec) / 1e6:.1f} MB)")
    rows = device_us_per_launch(torch, {
        apply: lambda: gc.graph_hat_apply(tab, t["sq"], None, t["r"],
                                          t["p"], beta)}, f"{w}x{w} mesh")
    passes = [(key, count, us) for key, count, us in rows[apply]
              if "graph_hat_" in key]
    if len(passes) == 2:
        dev_us = sum(us / count for _, count, us in passes)
        out[apply]["device_ms"] = dev_us / 1e3
        of_bound = out[apply]["bound_ms"] * 1e3 / dev_us
        of_bytes = design / HBM_BYTES_PER_S * 1e6 / dev_us
        print(f"  device {apply} ({w}x{w} mesh): {dev_us:.2f} us an apply "
              f"(edge + vertex pass), {100 * of_bound:.1f}% of its bound, "
              f"{100 * of_bytes:.1f}% of its passes' bytes at the peak")
    v32 = torch.as_tensor(rng.randn(n_verts, 6).astype(np.float32),
                          device=dev)
    e32 = torch.as_tensor(rng.randn(n_edges, 6).astype(np.float32),
                          device=dev)
    if w == MESH:  # every width, aligned and not
        check_graph_exact(torch, dev, v0, order, rowptr, n_verts,
                          (1, 2, 3, 4, 5, 6, 7, 8, 11), (0, 1))
    else:  # the widths the 262k path runs
        check_graph_exact(torch, dev, v0, order, rowptr, n_verts, (3, 6),
                          (0,))
    idx0 = idx[0].contiguous()
    out_v = torch.zeros_like(v32)
    device_us_per_launch(torch, {
        "graph_gather(f32)": lambda: gc.graph_gather(v32, idx),
        "graph_gather(f32) one slot, as on the path": lambda: gc.graph_gather(
            v32, idx0),
        "index_select": lambda: torch.index_select(v32, 0, idx.reshape(-1)),
        "graph_scatter(f32)": lambda: gc.graph_scatter(e32, v0, order,
                                                       rowptr),
        "index_add_": lambda: out_v.index_add_(0, v0, e32),
    }, f"{w}x{w} mesh")
    if w == MESH:
        graph_host_times(torch, gc, v32, e32, idx, idx0, v0, order, rowptr)
    return out


def check_graph_exact(torch, dev, v0, order, rowptr, n_verts, channels,
                      offsets):
    """K9 bit for bit its plain version and K10 bit for bit the edge-order
    sum on the CPU, at each channel count C, f32 and f64, with the blocks' bases at each element offset (1: not aligned to a
    row's vector, the generic kernels); K10 equal to itself on a second
    call."""
    from opt_tpu_torch.ops import graph_cuda as gc

    rng = np.random.RandomState(5)
    idx = torch.stack([v0, v0.flip(0)])
    n_edges = v0.numel()
    checked = 0
    for dt in (torch.float32, torch.float64):
        for c in channels:
            v = torch.as_tensor(rng.randn(n_verts * c + 1), device=dev).to(dt)
            x = torch.as_tensor(rng.randn(n_edges * c + 1), device=dev).to(dt)
            for off in offsets:
                vv = v[off:off + n_verts * c].view(n_verts, c)
                xx = x[off:off + n_edges * c].view(n_edges, c)
                want = gc.graph_gather_plain(vv, idx)
                if not torch.equal(gc.graph_gather(vv, idx), want):
                    raise AssertionError(f"graph_gather C={c} {dt} offset "
                                         f"{off} differs from its plain "
                                         "version")
                got = gc.graph_scatter(xx, v0, order, rowptr)
                want = scatter_in_edge_order(torch, xx, order, rowptr)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(
                        f"graph_scatter C={c} {dt} offset {off} differs "
                        "from the edge-order sum")
                if not torch.equal(got, gc.graph_scatter(xx, v0, order,
                                                         rowptr)):
                    raise AssertionError(f"graph_scatter C={c} {dt} offset "
                                         f"{off} differs between calls")
                checked += 1
    print(f"  graph_gather and graph_scatter exact: {checked} cases (C in "
          f"{channels}, f32 and f64, base offsets {offsets})")


def device_us_per_launch(torch, fns, label, n=20):
    """Device microseconds per launch of each kernel that each fn
    launches, from torch.profiler over n calls, after n calls in the
    profiler's warm-up step.  name -> device_rows."""

    def calls(fn):
        for _ in range(n):
            fn()

    out = {}
    for name, fn in fns.items():
        rows = out[name] = device_rows(torch, lambda: calls(fn), warmup=True)
        if not rows:
            print(f"  device {name} ({label}): the profiler saw no device "
                  "time (not measured)")
        for key, count, us in rows:
            print(f"  device {name} ({label}): {us / count:.2f} us per "
                  f"launch, {count} of {n} launches  {key[:70]}")
    return out


def device_vs_bound(torch, out, fns, symbol, label, tries=3):
    """Device us per launch of each case's kernel (the profiler's row that
    names symbol) beside the case's bound, kept as the case's device_ms.
    A window in which the profiler saw no launch of the kernel is taken
    again, up to tries windows; after that the case keeps no device_ms,
    and says so."""
    for name, fn in fns.items():
        for _ in range(tries):
            rows = device_us_per_launch(torch, {name: fn}, label)[name]
            mine = [(count, us) for key, count, us in rows if symbol in key]
            if mine:
                break
        if not mine:
            print(f"  device {name} ({label}): the profiler saw no launch of "
                  f"{symbol} in {tries} windows (not measured; the kernels "
                  "line gives its CUDA events' time)")
            continue
        dev_us = mine[0][1] / mine[0][0]
        out[name]["device_ms"] = dev_us / 1e3
        bound_us = out[name]["bound_ms"] * 1e3
        print(f"  device {name} ({label}): {dev_us:.2f} us a launch beside "
              f"its bound {bound_us:.1f} us ({out[name]['bound_by']}), "
              f"{100 * bound_us / dev_us:.1f}% of it")


def host_us(torch, fn, n=1000):
    """Host microseconds per call of fn, from time.perf_counter over n
    calls (the device keeps up where the host is slower; the closing
    synchronize counts)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def graph_host_times(torch, gc, v, e, idx, idx0, v0, order, rowptr):
    """Host microseconds per call of K9 and K10 and their library calls at
    the path's shapes, layer by layer: the C entry alone (pointers ready),
    the wrapper's own steps, the wrapper, the torch.library operator, and
    gather() on the solve path, alone and under torch.func.vjp (its
    forward, then its transpose) beside index_select under the same
    transform; then the profiler's CPU rows of the wrapper and of gather()
    under vjp, per call over 100 calls."""
    from opt_tpu_torch.ops import build
    from torch.profiler import ProfilerActivity, profile

    lib = build.library()
    out_g = v.new_empty((*idx.shape, v.shape[1]))
    out_s = torch.empty_like(v)
    raw = (v.data_ptr(), idx.data_ptr(), out_g.data_ptr(), idx.numel(),
           v.shape[1], 0, build.stream())
    raw_s = (e.data_ptr(), order.data_ptr(), rowptr.data_ptr(),
             out_s.data_ptr(), v.shape[0], v.shape[1], 0, build.stream())
    dtypes = {"v": torch.float32, "idx": torch.int32}

    def take(u):
        return gc.gather(u, idx0, order, rowptr)

    def select(u):
        return torch.index_select(u, 0, idx0)

    _, take_t = torch.func.vjp(take, v)
    fwd, select_t = torch.func.vjp(select, v)
    ct = torch.randn_like(fwd)
    out_v = torch.zeros_like(v)
    rows = {
        "graph_gather C entry": lambda: lib.opt_graph_gather(*raw),
        "build.all_on_cpu": lambda: build.all_on_cpu(v, idx),
        "build.check_tensors": lambda: build.check_tensors(
            "graph_gather", {}, dtypes, v=v, idx=idx),
        "new_empty": lambda: v.new_empty((*idx.shape, v.shape[1])),
        "build.stream": build.stream,
        "graph_gather wrapper": lambda: gc.graph_gather(v, idx),
        "graph_gather operator": lambda: gc._gather_op(v, idx),
        "gather() forward": lambda: take(v),
        "index_select": lambda: torch.index_select(v, 0, idx.reshape(-1)),
        "vjp of gather() (forward)": lambda: torch.func.vjp(take, v),
        "vjp of index_select (forward)": lambda: torch.func.vjp(select, v),
        "gather() transpose (vjp_fn)": lambda: take_t(ct),
        "index_select transpose (vjp_fn)": lambda: select_t(ct),
        "graph_scatter C entry": lambda: lib.opt_graph_scatter(*raw_s),
        "graph_scatter wrapper": lambda: gc.graph_scatter(e, v0, order,
                                                          rowptr),
        "graph_scatter operator": lambda: gc._scatter_op(e, v0, order,
                                                         rowptr),
        "index_add_": lambda: out_v.index_add_(0, v0, e),
        "zeros_like + index_add_": lambda: torch.zeros_like(v).index_add_(
            0, v0, e),
    }
    # rounds over every row, so that each row meets the host's drift in
    # each round; the best of each row's rounds
    best = dict.fromkeys(rows, float("inf"))
    for name, fn in rows.items():
        for _ in range(20):
            fn()
    for _ in range(3):
        for name, fn in rows.items():
            best[name] = min(best[name], host_us(torch, fn))
    for name, us in best.items():
        print(f"  host {name}: {us:.2f} us per call (best of 3 x 1000)")
    n = 100
    for name in ("graph_gather wrapper", "vjp of gather() (forward)"):
        fn = rows[name]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                fn()
        print(f"  profiler CPU rows of {name}, per call over {n} calls:")
        for ev in sorted(prof.key_averages(),
                         key=lambda ev: -ev.self_cpu_time_total)[:8]:
            print(f"    {ev.self_cpu_time_total / n:8.2f} us self "
                  f"{ev.cpu_time_total / n:8.2f} us total "
                  f"{ev.count / n:5.1f} x {ev.key[:60]}")


def profile_solve(torch, plan, inputs, engine, label, card, wall_ms):
    """profile_call on one plan.solve."""
    profile_call(torch, lambda: plan.solve(inputs, engine=engine),
                 f"{label} engine={engine}", card, wall_ms)


def device_rows(torch, fn, warmup=False):
    """(kernel, launches, device us in all) of each kernel that one call
    of fn launches, from torch.profiler; with warmup, after one call in
    the profiler's warm-up step (the first calls a profiler traces can
    lose launches: 4 of 20 seen without it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warmup else None) as prof:
        for _ in range(2 if warmup else 1):
            fn()
            torch.cuda.synchronize()  # a call that ends in no host read
            if warmup:
                prof.step()
    # device-side rows only: the aten op rows repeat their kernels' time
    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def profile_call(torch, fn, label, card, wall_ms):
    """Where a warm solve (fn) spends the card's time: device time by
    kernel from torch.profiler (the top rows, then every other row of the
    port's kernels), and the device's busy share of the unprofiled solve's
    wall time (wall_ms; the profiler slows the host)."""
    rows = device_rows(torch, fn)
    if not rows:
        print("profile: the profiler saw no device time (not measured)")
        return
    busy_ms = sum(r[2] for r in rows) / 1e3
    print(f"profile: {label}: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle) ({card})")
    rows.sort(key=lambda r: -r[2])
    for n, (key, count, us) in enumerate(rows):
        if n < 12 or any(k in key for k in KERNEL_SYMBOLS):
            print(f"  {us / 1e3:9.2f} ms {count:6d} x {us / count:8.2f} us  "
                  f"{key[:90]}")
    passes = [r for r in rows if "graph_hat_" in r[0]]
    if passes:  # K11: an edge and a vertex pass an apply
        us = sum(r[2] for r in passes)
        applies = max(r[1] for r in passes)
        print(f"  {us / 1e3:9.2f} ms {applies:6d} x {us / applies:8.2f} us  "
              f"K11 graph_hat_apply, its two passes together "
              f"({100 * us / 1e3 / busy_ms:.1f}% of device time)")


def timed_call(torch, fn):
    """(fn's result, wall ms) of one call that ends in a host read (a
    solve's final cost)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def timed_solve(torch, plan, inputs, engine="auto"):
    """(final cost, wall ms) of one solve."""
    return timed_call(torch, lambda: plan.solve(inputs, engine=engine))


def best_of_3(torch, plan, inputs, engine, label, card):
    return best_of_3_call(torch, lambda: plan.solve(inputs, engine=engine),
                          f"{label} engine={engine}", card)


def best_of_3_call(torch, fn, label, card):
    times = [timed_call(torch, fn)[1] for _ in range(3)]
    print(f"solve {label}: best {min(times):.1f} ms of "
          f"{[round(v, 1) for v in times]} ({card})")
    return min(times)


def new_plan(opt_tpu_torch, energies, kind, size, n_outer, n_linear):
    state = opt_tpu_torch.NewState(device=DEVICE)
    plan = state.problem_plan(
        state.problem_define(energies.image_warping, kind), [size, size])
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


def new_vol_plan(opt_tpu_torch, energies, kind, variant):
    state = opt_tpu_torch.NewState(device=DEVICE)
    plan = state.problem_plan(
        state.problem_define(energies.volumetric_mesh_deformation, kind),
        [VOL] * 3)
    plan.set_solver_parameter("nIterations", VOL_OUTER)
    plan.set_solver_parameter("lIterations", VOL_LINEAR)
    plan.stream_variant = variant
    return plan


def run_graph_paths(torch, drive, card, paths=GRAPH_PATHS,
                    n_outer=GRAPH_OUTER, n_linear=GRAPH_LINEAR):
    """Phase 12: the slice-4 paths.  drive(plan, inputs) runs one solve
    with the launch counts zeroed just before it and returns (cost, ms,
    launches)."""
    import opt_tpu_torch
    from opt_tpu_torch import energies

    for label, kind, w, want_cost in paths:
        mesh_inputs = arap_inputs(w)
        mesh_shapes = {n: (w * w, 3) for n in ("Offset", "Angle")}
        plan = new_graph_plan(opt_tpu_torch, energies, kind, w,
                              n_outer=n_outer, n_linear=n_linear)
        cost, ms, launches = drive(plan, mesh_inputs)
        print(f"path {label} {n_outer}x{n_linear}: "
              f"engine={plan.engine} variant={plan.variant} {ms:.1f} ms "
              f"(cold) launches={launches}")
        if plan.engine != "graph":
            raise AssertionError(
                f"{label}: engine='auto' picked {plan.engine!r}, not 'graph'")
        check_launches(label, launches, expected_launches_graph(
            kind, n_outer, n_linear))
        check_unknowns(plan, mesh_shapes)
        check_cost(label, cost, want_cost)
        name = f"{label} {n_outer}x{n_linear}"
        best = best_of_3(torch, plan, mesh_inputs, "auto", f"{name} (warm)",
                         card)
        profile_solve(torch, plan, mesh_inputs, "auto", name, card, best)
        if kind == "gaussNewtonGPU" and w == MESH:
            # the plain engine on the card: K9 and K10 in the evaluator
            cost_t, ms_t = timed_solve(torch, plan, mesh_inputs, "torch")
            print(f"solve {name} engine=torch: one solve {ms_t:.1f} ms "
                  f"({card})")
            check_cost(f"{label} torch", cost_t, want_cost)
            print(f"graph route {name}: torch/graph {ms_t / best:.3f} "
                  f"({card})")
            # bench.aux_arap's own inputs: a rigid optimum, cost zero
            rigid = arap_inputs(w, rigid=True)
            best_of_3(torch, plan, rigid, "auto",
                      f"{name} bench.aux_arap inputs (warm)", card)
            cost_r = plan.solve(rigid)
            print(f"{label} bench.aux_arap inputs: engine={plan.engine} "
                  f"final cost {cost_r!r} (max {RIGID_COST_MAX:.0e})")
            if not 0.0 <= cost_r <= RIGID_COST_MAX:
                raise AssertionError(f"{label}: bench.aux_arap's inputs end "
                                     f"at cost {cost_r!r}")


def check_unknowns(plan, shapes):
    """The unknowns (name -> expected shape) are finite and of that
    shape."""
    x = plan.unknowns()
    for n, shape in shapes.items():
        if x[n].shape != shape or not np.isfinite(x[n]).all():
            raise AssertionError(f"unknown {n}: shape {x[n].shape} or "
                                 "non-finite values")


def check_cost(label, cost, want):
    rel = abs(cost - want) / abs(want)
    print(f"{label} final cost {cost!r} jax-cpu {want!r} (rel {rel:.3e}, "
          f"tol {COST_RTOL:.0e})")
    if not np.isfinite(cost) or rel > COST_RTOL:
        raise AssertionError(f"{label}: final cost disagrees")


def expected_launches(kind, engine, n_outer, n_linear, period=10,
                      onchip=False, variant="classic"):
    """Launch counts one solve makes, by kernel name; onchip: the grid takes
    K13's on-chip form (stream_cuda.onchip_tiles); variant: the stream
    engine's backend (GN's pipelined, or classic)."""
    resets = n_outer * (n_linear // period) if kind == "LMGPU" else 0
    # K3: the initial cost, then per outer linearize + cost (+ LM's model
    # cost)
    k3 = 1 + n_outer * (3 if kind == "LMGPU" else 2)
    n = n_outer * n_linear
    if engine == "cuda" and kind != "LMGPU":  # one K13 an outer step
        want = {"K13.resident_pcg": n_outer, "K3.warp_linearize": k3}
        if onchip:
            want["K13.resident_pcg_onchip"] = n_outer
        return want
    if engine == "cuda":
        return {"K1.warp_jtj_apply": n + resets, "K2.pcg_update": n - resets,
                "K3.warp_linearize": k3}
    if variant == "classic":
        return {"K4.warp_hat_apply": n + resets, "K2.pcg_update": n,
                "K3.warp_linearize": k3}
    return {"K4.warp_hat_apply": n_outer, "K5.warp_pipelined_sweep": n,
            "K3.warp_linearize": k3}


def expected_launches3d(kind, variant, n_outer, n_linear, period=10):
    """Launch counts one volume solve makes, by kernel name."""
    lm = kind == "LMGPU"
    resets = n_outer * (n_linear // period) if lm else 0
    k8 = 1 + n_outer * (3 if lm else 2)
    n = n_outer * n_linear
    if variant == "classic":
        return {"K6.vol_hat_apply": n + resets, "K2.pcg_update": n,
                "K8.vol_linearize": k8}
    # w_0 per outer step, and r = b - A delta, w = A r at each reset
    return {"K6.vol_hat_apply": n_outer + 2 * resets,
            "K7.vol_pipelined_sweep": n, "K8.vol_linearize": k8}


def expected_launches_graph(kind, n_outer, n_linear, period=10):
    """Launch counts one arap solve on "graph" makes, by kernel name (an
    apply launches K11's edge pass and its vertex pass).  A cost gathers both blocks (unknowns, constants) of both slots: 4 K9.
    An outer step: J^T F (the vjp's forward, 4 K9; its transpose of the
    unknown block, 2 K10), the leaf partials (4 K9), diag (one K10 per
    slot), the new cost (4 K9) and in LM the model cost (1 K9 for both
    slots)."""
    lm = kind == "LMGPU"
    resets = n_outer * (n_linear // period) if lm else 0
    n = n_outer * n_linear
    return {"K11.graph_hat_edge": n + resets,
            "K11.graph_hat_vertex": n + resets, "K2.pcg_update": n,
            "K9.graph_gather": 4 + n_outer * (13 if lm else 12),
            "K10.graph_scatter": 4 * n_outer}


def expected_slab_applies(variant, lm, n_outer, n_linear, period=10):
    """K15 or K16 launches in one sharded solve: per outer step the
    pipelined w_0 and one apply an iteration, or one an iteration and, in
    LM, one more at each reset (parallel/stream_shard.py's loops)."""
    if lm:
        return n_outer * (n_linear + n_linear // period)
    return n_outer * (n_linear + (variant == "pipelined"))


# the kernels line's rows whose launches are not the one counter of their
# name (runtime/trace.LAUNCHES): K3 and K8 whole and on slabs, and K11's
# applies, one edge pass each
ROW_COUNTERS = {"warp_linearize": ("K3.warp_linearize",
                                   "K3.warp_slab_linearize"),
                "vol_linearize": ("K8.vol_linearize", "K8.vol_slab_linearize"),
                "graph_hat_apply": ("K11.graph_hat_edge",)}


def check_launches(label, launches, want):
    got = {k: launches[k] for k in want}
    if got != want or any(launches[k] for k in launches if k not in want):
        raise AssertionError(f"{label}: launch counts {launches}, want "
                             f"{want} and no others")


def poisson_inputs(W, H, seed=1):
    """The slice-5 poisson paths' inputs: a copy of
    tests/test_stream_solver._poisson_inputs (a test holds the two equal).
    The frame is excluded (M != 0) and the central box free."""
    rng = np.random.RandomState(seed)
    mask = np.ones((H, W, 1), np.float32)
    mask[H // 4: -H // 4, W // 4: -W // 4] = 0
    return {
        "X": rng.rand(H, W, 4).astype(np.float32),
        "T": rng.rand(H, W, 4).astype(np.float32),
        "M": mask,
    }


def new_poisson_plan(opt_tpu_torch, energies, size, n_outer, n_linear):
    state = opt_tpu_torch.NewState(device=DEVICE)
    plan = state.problem_plan(state.problem_define(
        energies.poisson_image_editing, "gaussNewtonGPU"), [size, size])
    plan.set_solver_parameter("nIterations", n_outer)
    plan.set_solver_parameter("lIterations", n_linear)
    return plan


def resident_operands(torch, energy, W, H, dev, seed=12):
    """(hat, sq, b_hat) for K13, as the GN solver forms them: image_warping
    at kernel_operands' point, sq = sqrt(guarded_invert(diag)) (0 at its
    excluded pixel) and b_hat = sq (-J^T F), from the closed-form
    linearize; or poisson on a flat (H, W, 4) vector with sq = 0 on an
    excluded frame and one inner pixel and 1 elsewhere (no
    preconditioner), b_hat = sq times seeded noise.  (Random sq and b_hat
    make image_warping's hat system so ill-conditioned that float32 loops
    part from float64 by 2e-2 after 20 iterations; the solver's Jacobi
    scaling keeps that to 2e-6 at 50.)"""
    from opt_tpu_torch.ops import stream_cuda, warp_cuda
    from opt_tpu_torch.solver.core import guarded_invert

    rng = np.random.RandomState(seed)
    if energy == "warp":
        x, ur, cons, mask, params, _ = kernel_operands(torch, W, H, dev, seed)
        jtf, diag, _ = warp_cuda.warp_linearize_plain(x, ur, cons, mask,
                                                      params)
        keep = warp_cuda._flat_keep(mask.view(H, W) == 0)
        sq = torch.where(keep, torch.sqrt(guarded_invert(diag, "CERES")),
                         torch.zeros((), device=dev))
        return (stream_cuda.WarpHat(x, ur, cons, mask, params), sq,
                sq * -jtf)
    keep = np.zeros((H, W, 1), np.float32)
    keep[3:-3, 4:-4] = 1.0
    keep[H // 2, W // 3] = 0.0
    sq = torch.as_tensor(np.repeat(keep, 4, axis=-1).reshape(-1), device=dev)
    b = torch.as_tensor(rng.randn(H * W * 4).astype(np.float32), device=dev)
    return stream_cuda.PoissonHat(H, W, 4), sq, sq * b


def check_loop_cases(torch, cases, reps):
    """Each whole-loop case (kernel(n), plain(n), iterations to time,
    bytes in and out, operations at those iterations, bytes the kernel
    moves an iteration): agreement within KERNEL_RTOL after
    RESIDENT_CHECK_ITERS iterations, the same count at every size, since
    the rounding of two float32 loops grows with the iterations; then
    both timed at the given iterations (the plain loop with one call, the
    agreement check its warm-up), the bound, and the profiler's device
    time a launch and an iteration beside it, with the launch's grid
    syncs (csrc/resident_pcg.cuh: one, then two an iteration)."""
    out = {}
    for name, (kern, plain, n_time, n_bytes, n_ops, moved) in cases.items():
        n = RESIDENT_CHECK_ITERS
        got, want = kern(n), plain(n)
        torch.cuda.synchronize()
        rel, absmax = rel_err([got], [want])
        ok = rel <= KERNEL_RTOL and bool(torch.isfinite(got).all())
        ms = cuda_ms(torch, lambda: kern(n_time), reps)
        plain_ms = cuda_ms(torch, lambda: plain(n_time), 1, warmup=0)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"kernel {name}: max rel err {rel:.3e} after {n} iterations "
              f"(tol {KERNEL_RTOL:.0e}) max abs err {absmax:.3e}  "
              f"{n_time} iterations {ms * 1e3:.1f} us vs plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}, {n_bytes / 1e6:.1f} MB in and out); moves about "
              f"{moved / 1e6:.1f} MB an iteration, "
              f"{moved * n_time / (ms * 1e9):.2f} TB/s  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        out[name] = {"max_abs_err": absmax, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        device_vs_bound(torch, out, {name: lambda: kern(n_time)},
                        "pcg_kernel", f"{n_time} iterations")
        if "device_ms" in out[name]:
            print(f"  device {name}: "
                  f"{out[name]['device_ms'] * 1e3 / n_time:.2f} us an "
                  f"iteration beside its bound "
                  f"{bound_ms * 1e3 / n_time:.2f} us; {2 * n_time + 1} grid "
                  "syncs a launch, 2 an iteration")
    return out


def onchip_form(H, W):
    """True where an H x W image_warping grid takes K13's on-chip form on
    this card."""
    from opt_tpu_torch.ops import build, stream_cuda

    return bool(stream_cuda.onchip_tiles(H, W, *build.card_limits()))


def ptxas_report(log, symbol):
    """ptxas's lines (registers, stack, spills, static shared memory) for
    each kernel whose mangled name holds symbol, from an nvcc -Xptxas -v
    log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and symbol in name and ("registers" in line
                                          or "spill" in line):
            out.append(line.strip())
    return out


def check_slice5_kernels(torch, dev, reps):
    """Phase 13: K12-K14 against their plain versions; name -> timings,
    with library_ms (conv2d) for K14.  K13's image_warping mode at 512^2
    runs twice: on the form the grid takes (the on-chip one) and held to
    the L2 form, each timed beside the same bound."""
    import torch.nn.functional as F

    from opt_tpu_torch.ops import (build, halo_stencil, poisson_cuda,
                                   stream_cuda)

    class L2Form(stream_cuda.WarpHat):
        """WarpHat held to K13's L2 form whatever its grid."""

        def form(self, card):
            return self

    cases = {}
    # the ragged size is timed at the checks' iterations: no row reads it
    for size, n_time in ((SMALL_POISSON, RESIDENT_CHECK_ITERS), ((W, H), 400),
                         ((BIG, BIG), 100)):
        Ws, Hs = size
        keep_np = poisson_inputs(Ws, Hs)["M"][..., 0] == 0
        keep_np[Hs // 2, Ws // 3] = False
        keep = torch.as_tensor(keep_np.astype(np.float32), device=dev)
        rng = np.random.RandomState(Ws)
        for C in (1, 4):
            b = torch.as_tensor(rng.randn(C, Hs, Ws).astype(np.float32),
                                device=dev)
            if C == 4:
                b[2] = 0.0
            cases[f"poisson_cg(C={C}, {Ws}x{Hs})"] = (
                lambda n, b=b, keep=keep: poisson_cuda.poisson_cg(b, keep, n),
                lambda n, b=b, keep=keep: poisson_cuda.poisson_cg_plain(
                    b, keep, n),
                n_time, nbytes(b, keep, b),
                OPS["poisson_cg"] * b.numel() * n_time,
                9 * nbytes(b) + nbytes(keep))
    # the paths' PCG iterations: StreamSolver's and the cuda engine's GN
    # (warp 512^2 x400 and 2048^2 x100, poisson 512^2 x100)
    for size, energy, n_path in (
            (SMALL_POISSON, "warp", None), (SMALL_POISSON, "poisson", None),
            ((W, H), "warp", N_LINEAR), ((W, H), "poisson", 100),
            ((BIG, BIG), "warp", 100)):
        n_time = n_path or RESIDENT_CHECK_ITERS
        hat, sq, b_hat = resident_operands(torch, energy, *size, dev)
        px = size[0] * size[1]
        ops = (OPS["resident_pcg(warp)"] * px if energy == "warp"
               else OPS["resident_pcg(poisson)"] * b_hat.numel())
        forms = {"": hat}
        if energy == "warp" and size == (W, H):
            forms[", L2 form"] = L2Form(*hat.operands.values())
        tiles = (energy == "warp" and stream_cuda.onchip_tiles(
            size[1], size[0], *build.card_limits()))
        for tag, h in forms.items():
            # the on-chip form moves only its tiles' edges through L2: r and
            # p out, the ring's in, 24 bytes a ring pixel each way
            moved = (48 * 2 * sum(stream_cuda.ONCHIP_TILE) * tiles
                     if tiles and not tag else
                     9 * nbytes(b_hat) + nbytes(sq, *hat.operands.values()))
            cases[f"resident_pcg({energy}, {size[0]}x{size[1]}{tag})"] = (
                lambda n, h=h, s=sq, b=b_hat: stream_cuda.resident_pcg(
                    h, s, b, n),
                lambda n, h=h, s=sq, b=b_hat:
                    stream_cuda.resident_pcg_plain(h, s, b, n),
                n_time, nbytes(*hat.operands.values(), sq, b_hat, b_hat),
                ops * n_time, moved)
    print("slice-5 whole-loop kernels:")
    out = check_loop_cases(torch, cases, reps)
    # K13's two forms of image_warping at 512^2, side by side
    for tag, symbol, smem in (
            ("", "onchip15warp_pcg_kernel",
             f"{stream_cuda.ONCHIP_SMEM_BYTES} bytes of dynamic shared "
             "memory a block"),
            (", L2 form", "coop10pcg_kernelINS_8WarpLoop", "no dynamic "
             "shared memory")):
        row = out[f"resident_pcg(warp, {W}x{H}{tag})"]
        ms = row.get("device_ms", row["ms"])
        print(f"K13 warp {W}x{H}{tag or ', on-chip form'}: "
              f"{ms * 1e3 / N_LINEAR:.2f} us an iteration "
              f"({'profiler' if 'device_ms' in row else 'cuda events'}), "
              f"{100 * row['bound_ms'] / ms:.1f}% of its bound; {smem}; "
              f"ptxas: {'; '.join(ptxas_report(build.build_log, symbol))}")
    stencil = {}
    library = {}
    # cuDNN runs a float32 convolution in TF32 by default: the yardstick
    # is held to full float32, as the kernel computes
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(13)
    for shape in STENCIL_SHAPES + ((BIG_STENCIL, BIG_STENCIL),):
        img = torch.as_tensor(rng.randn(*shape).astype(np.float32),
                              device=dev)
        for tag, (offsets, weights) in STENCIL_TAPS.items():
            name = f"stencil_apply({tag}, {shape[0]}x{shape[1]})"
            stencil[name] = (
                lambda i=img, o=offsets, w=weights:
                    [halo_stencil.stencil_apply(i, o, w)],
                lambda i=img, o=offsets, w=weights:
                    [halo_stencil.stencil_apply_plain(i, o, w)],
                2 * nbytes(img), 2 * len(offsets) * img.numel())
            ry = max(abs(dy) for _, dy in offsets)
            rx = max(abs(dx) for dx, _ in offsets)
            k = torch.zeros(1, 1, 2 * ry + 1, 2 * rx + 1, device=dev)
            for (dx, dy), w in zip(offsets, weights):
                k[0, 0, dy + ry, dx + rx] += w
            library[name] = (lambda i=img, k=k, pad=(ry, rx): F.conv2d(
                i[None, None], k, padding=pad)[0, 0])
    print("slice-5 K14 stencil_apply (conv2d beside it, "
          "torch.backends.cudnn.allow_tf32 = False):")
    out.update(check_cases(torch, stencil, reps))
    for name, fn in library.items():
        kern = stencil[name][0]()[0]
        rel, _ = rel_err([fn()], [kern])
        out[name]["library_ms"] = cuda_ms(torch, fn, reps)
        print(f"  library {name}: conv2d {out[name]['library_ms'] * 1e3:.1f}"
              f" us (max rel diff from K14 {rel:.1e})")
    return out


def run_slice5_paths(torch, drive_call, card):
    """Phase 14: the slice-5 paths.  drive_call(fn) runs fn with the launch
    counts zeroed just before it and returns (fn's result, ms,
    launches)."""
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import halo_stencil, poisson_cuda, stream_cuda

    for label, size, n_iters, want_cost in POISSON_CG_PATHS:
        plan = new_poisson_plan(opt_tpu_torch, energies, size, 1, n_iters)
        solver = poisson_cuda.PoissonCudaSolver(plan)
        inputs = poisson_inputs(size, size)
        solve = lambda: solver.solve(inputs, n_iters)
        out, ms, launches = drive_call(solve)
        print(f"path {label} {n_iters}: PoissonCudaSolver {ms:.1f} ms "
              f"(cold) launches={launches}")
        check_launches(label, launches, {"K12.poisson_cg": 1})
        check_finite(label, out["x"]["X"], (size, size, 4))
        check_cost(label, out["final_cost"], want_cost)
        best = best_of_3_call(torch, solve, f"{label} {n_iters} (warm)",
                              card)
        profile_call(torch, solve, f"{label} {n_iters}", card, best)

    for label, energy, size, n_outer, n_linear, want_cost in RESIDENT_PATHS:
        fn = getattr(energies, energy)
        state = opt_tpu_torch.NewState(device=DEVICE)
        plan = state.problem_plan(state.problem_define(fn, "gaussNewtonGPU"),
                                  [size, size])
        plan.set_solver_parameter("nIterations", n_outer)
        plan.set_solver_parameter("lIterations", n_linear)
        solver = stream_cuda.StreamSolver(plan)
        warp = fn is energies.image_warping
        inputs = warp_inputs(size, size) if warp else poisson_inputs(size,
                                                                     size)
        solve = lambda: solver.solve(inputs)
        out, ms, launches = drive_call(solve)
        print(f"path {label} {n_outer}x{n_linear}: StreamSolver {ms:.1f} ms "
              f"(cold) launches={launches}")
        want = {"K13.resident_pcg": n_outer}
        if warp:  # K3: the initial cost, then linearize and cost a step
            want["K3.warp_linearize"] = 1 + 2 * n_outer
            if onchip_form(size, size):
                want["K13.resident_pcg_onchip"] = n_outer
        check_launches(label, launches, want)
        for n, shape in plan.funcs.unknown_shapes.items():
            check_finite(f"{label} {n}", out["x"][n], shape)
        check_cost(label, out["final_cost"], want_cost)
        name = f"{label} {n_outer}x{n_linear}"
        best = best_of_3_call(torch, solve, f"{name} (warm)", card)
        if warp:
            # the cuda engine's solve of the same problem, in the same run
            cuda_best = best_of_3(torch, plan, inputs, "cuda", name, card)
            print(f"resident {name}: cuda engine / StreamSolver "
                  f"{cuda_best / best:.3f} ({card})")
        profile_call(torch, solve, f"{name} StreamSolver", card, best)

    # K14 through its entry point: the JAX test's taps on a 4096^2 image
    offsets, weights = STENCIL_TAPS["radius1"]
    img = torch.as_tensor(np.random.RandomState(14).randn(
        BIG_STENCIL, BIG_STENCIL).astype(np.float32), device=DEVICE)
    out, ms, launches = drive_call(
        lambda: halo_stencil.stencil_apply(img, offsets, weights))
    label = f"stencil {BIG_STENCIL}x{BIG_STENCIL}"
    print(f"path {label}: stencil_apply {ms:.1f} ms (cold) "
          f"launches={launches}")
    check_launches(label, launches, {"K14.stencil_apply": 1})
    rel, _ = rel_err([out], [halo_stencil.stencil_apply_plain(img, offsets,
                                                               weights)])
    print(f"{label}: max rel err {rel:.3e} against the plain version")
    if rel > KERNEL_RTOL:
        raise AssertionError(f"{label}: output disagrees")
    # one call, ended by a host read of one pixel; the profiler sees no
    # device time in a window of one such call, so it profiles STENCIL_REPS
    stencil = lambda: float(halo_stencil.stencil_apply(img, offsets,
                                                       weights)[0, 0])
    best = best_of_3_call(torch, stencil, label, card)
    profile_call(torch, lambda: [stencil() for _ in range(STENCIL_REPS)],
                 f"{label} x{STENCIL_REPS}", card, STENCIL_REPS * best)


def run_shard_paths(torch, drive_call, card):
    """Phase 16: the slice-6 paths through Plan.solve(inputs,
    mesh=make_mesh(SHARD_SLABS)), each with its launch counts against those
    its loops make, its final cost against the single-card engine's in the
    same run (and the JAX package's CPU value), its warm solve beside the
    single-card engine's, and a profile.  drive_call as in phase 14."""
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(SHARD_SLABS, device=DEVICE)
    for (label, energy, kind, size, n_outer, n_linear, engine, variant,
         want_variant, single, rtol, want_cost) in SHARD_PATHS:
        vol = engine == "stream3d"
        state = opt_tpu_torch.NewState(device=DEVICE)
        plan = state.problem_plan(
            state.problem_define(getattr(energies, energy), kind),
            [size] * (3 if vol else 2))
        plan.set_solver_parameter("nIterations", n_outer)
        plan.set_solver_parameter("lIterations", n_linear)
        plan.stream_variant = variant
        inputs = volume_inputs(size) if vol else warp_inputs(size, size)
        solve = lambda: plan.solve(inputs, engine=engine, mesh=mesh)
        cost, ms, launches = drive_call(solve)
        name = f"{label} {n_outer}x{n_linear} on {SHARD_SLABS} slabs"
        print(f"path {name}: engine={plan.engine} variant={plan.variant} "
              f"{ms:.1f} ms (cold) launches={launches}")
        if (plan.engine, plan.variant) != (engine, want_variant):
            raise AssertionError(f"{name}: ran {plan.engine!r} "
                                 f"{plan.variant!r}")
        want = {}
        if engine != "halo":  # the halo path runs the plain evaluator
            lm = kind == "LMGPU"
            apply = "K16.vol_slab_apply" if vol else "K15.warp_slab_apply"
            want = {apply: expected_slab_applies(want_variant, lm, n_outer,
                                                 n_linear),
                    "K8.vol_slab_linearize" if vol
                    else "K3.warp_slab_linearize":
                        1 + n_outer * (3 if lm else 2)}
            print(f"{name}: {apply} launched {launches[apply]} times, the "
                  f"loops make {want[apply]}")
        check_launches(name, launches, want)
        shapes = ({n: (size,) * 3 + (3,) for n in ("Offset", "Angle")}
                  if vol else {"Offset": (size, size, 2),
                               "Angle": (size, size, 1)})
        check_unknowns(plan, shapes)
        best = best_of_3_call(torch, solve, f"{name} (warm)", card)
        # the single-card engine on the same plan and inputs, in this run
        cost1 = plan.solve(inputs, engine=single)
        if single == "torch":  # it traces J p at every outer step
            best1 = timed_solve(torch, plan, inputs, single)[1]
            print(f"solve {label} {n_outer}x{n_linear} engine=torch: one "
                  f"warm solve {best1:.1f} ms ({card})")
        else:
            best1 = best_of_3(torch, plan, inputs, single,
                              f"{label} {n_outer}x{n_linear}", card)
        rel = abs(cost - cost1) / abs(cost1)
        print(f"{name} final cost {cost!r}, {single} engine {cost1!r} (rel "
              f"{rel:.3e}, tol {rtol:.0e}); warm {best:.1f} ms against "
              f"{best1:.1f} ms, {best / best1:.3f}x the single card "
              f"({card})")
        if not np.isfinite(cost) or rel > rtol:
            raise AssertionError(f"{name}: final cost disagrees with the "
                                 f"{single} engine's")
        if want_cost is not None:
            check_cost(name, cost, want_cost)
        profile_call(torch, solve, name, card, best)


def check_finite(label, t, shape):
    """t is finite and of the shape given."""
    if tuple(t.shape) != tuple(shape) or not bool(t.isfinite().all()):
        raise AssertionError(f"{label}: shape {tuple(t.shape)} or non-finite"
                             " values")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import opt_tpu_torch
    from opt_tpu_torch import energies
    from opt_tpu_torch.ops import build
    # every kernel module, so that LAUNCHES holds each kernel's counter
    from opt_tpu_torch.ops import (  # noqa: F401
        graph_cuda, halo_stencil, pcg_update, poisson_cuda, slab_cuda,
        stream3d_cuda, stream_cuda, vol_cuda, warp_cuda)
    from opt_tpu_torch.runtime.trace import LAUNCHES

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    build.library()
    print(f"build: {build.build_seconds:.2f} s "
          f"({len(build.sources())} sources, {' '.join(build.NVCC_FLAGS)})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    timings = check_kernels(torch, dev)

    total = dict.fromkeys(LAUNCHES, 0)

    def drive_call(fn):
        """fn() with the launch counts read just before it and just after:
        (its result, ms, the launches it made, name -> count)."""
        before = dict(LAUNCHES)
        out, ms = timed_call(torch, fn)
        launches = {k: n - before[k] for k, n in LAUNCHES.items()}
        for name, n in launches.items():
            total[name] += n
        return out, ms, launches

    def drive(plan, inputs):
        """One solve through drive_call."""
        return drive_call(lambda: plan.solve(inputs))

    # -- the first path: 512x512 GN 8x400 ----------------------------------
    print(f"[{time.perf_counter() - t_start:.1f} s] first path")
    plan = new_plan(opt_tpu_torch, energies, "gaussNewtonGPU", W, N_OUTER,
                    N_LINEAR)
    inputs = warp_inputs(W, H)
    cost, _, launches = drive(plan, inputs)
    engine = plan.engine
    print(f"main path: engine={engine} final cost={cost!r} "
          f"launches={launches}")
    if engine != "cuda":
        raise AssertionError(f"engine='auto' picked {engine!r}, not 'cuda'")
    check_launches("main path", launches, expected_launches(
        "gaussNewtonGPU", "cuda", N_OUTER, N_LINEAR,
        onchip=onchip_form(H, W)))
    check_unknowns(plan, {"Offset": (H, W, 2), "Angle": (H, W, 1)})

    rel_jax = abs(cost - JAX_CPU_FINAL_COST) / JAX_CPU_FINAL_COST
    print(f"final cost: cuda {cost!r}  jax-cpu {JAX_CPU_FINAL_COST!r} (rel "
          f"{rel_jax:.3e})  tol {COST_RTOL:.0e}")
    if not np.isfinite(cost) or rel_jax > COST_RTOL:
        raise AssertionError("final cost disagrees")
    # the plain engine, held to the cuda engine at a cut depth: it traces J p
    # at every outer step and took 49-53 s at the full 8x400
    plan.set_solver_parameter("nIterations", TORCH_OUTER)
    plan.set_solver_parameter("lIterations", TORCH_LINEAR)
    cost_torch, torch_ms = timed_solve(torch, plan, inputs, "torch")
    cost_short = plan.solve(inputs, engine="cuda")
    rel_torch = abs(cost_short - cost_torch) / abs(cost_torch)
    print(f"final cost {TORCH_OUTER}x{TORCH_LINEAR}: cuda {cost_short!r}  "
          f"torch {cost_torch!r} (rel {rel_torch:.3e}, tol {COST_RTOL:.0e})")
    if not np.isfinite(cost_torch) or rel_torch > COST_RTOL:
        raise AssertionError("final cost disagrees with the plain engine")
    plan.set_solver_parameter("nIterations", N_OUTER)
    plan.set_solver_parameter("lIterations", N_LINEAR)

    # -- warm solve times ---------------------------------------------------
    cuda_best = best_of_3(torch, plan, inputs, "cuda",
                          f"512x512 GN {N_OUTER}x{N_LINEAR}", card)
    print(f"solve 512x512 GN {TORCH_OUTER}x{TORCH_LINEAR} engine=torch: one "
          f"solve {torch_ms:.1f} ms ({card})")
    profile_solve(torch, plan, inputs, "cuda",
                  f"512x512 GN {N_OUTER}x{N_LINEAR}", card, cuda_best)

    # -- slice 2: the kernels at 2048x2048, then its paths ------------------
    print(f"[{time.perf_counter() - t_start:.1f} s] slice 2")
    timings.update(check_big_kernels(torch, dev))
    big_inputs = warp_inputs(BIG, BIG)
    for (label, kind, size, n_outer, n_linear, variant, want_engine,
         want_variant, want_cost) in PATHS:
        plan = new_plan(opt_tpu_torch, energies, kind, size, n_outer,
                        n_linear)
        plan.stream_variant = variant
        path_inputs = big_inputs if size == BIG else warp_inputs(size, size)
        cost, ms, launches = drive(plan, path_inputs)
        print(f"path {label} {n_outer}x{n_linear}: engine={plan.engine} "
              f"variant={plan.variant} {ms:.1f} ms (cold) launches="
              f"{launches}")
        if (plan.engine, plan.variant) != (want_engine, want_variant):
            raise AssertionError(
                f"{label}: engine='auto' picked {plan.engine!r} "
                f"{plan.variant!r}, not {want_engine!r} {want_variant!r}")
        check_launches(label, launches, expected_launches(
            kind, want_engine, n_outer, n_linear, variant=want_variant))
        check_unknowns(plan, {"Offset": (size, size, 2),
                              "Angle": (size, size, 1)})
        check_cost(label, cost, want_cost)
        best_of_3(torch, plan, path_inputs, plan.engine,
                  f"{label} {n_outer}x{n_linear} (warm)", card)

    # -- the card's crossover: stream vs cuda, 8x100 ------------------------
    print(f"[{time.perf_counter() - t_start:.1f} s] crossover")
    for kind, label in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        for size in (BIG // 2, BIG):
            plan = new_plan(opt_tpu_torch, energies, kind, size, 8, 100)
            path_inputs = big_inputs if size == BIG else warp_inputs(size,
                                                                     size)
            name = f"{size}x{size} {label} 8x100"
            best = {eng: best_of_3(torch, plan, path_inputs, eng, name, card)
                    for eng in ("stream", "cuda")}
            print(f"crossover {name}: stream {best['stream']:.1f} ms, cuda "
                  f"{best['cuda']:.1f} ms, cuda/stream "
                  f"{best['cuda'] / best['stream']:.3f} ({card})")
        for eng in ("stream", "cuda"):
            profile_solve(torch, plan, big_inputs, eng, name, card, best[eng])

    # -- slice 3: the volume kernels, then its paths at 128^3 ---------------
    print(f"[{time.perf_counter() - t_start:.1f} s] slice 3")
    check_vol_kernels(torch, dev, SMALL_VOL, TIMING_REPS)
    timings.update(check_vol_kernels(torch, dev, (VOL,) * 3,
                                     BIG_TIMING_REPS))
    vol_inputs = volume_inputs(VOL)
    vol_shapes = {n: (VOL,) * 3 + (3,) for n in ("Offset", "Angle")}
    for label, kind, variant, want_variant, want_cost in VOL_PATHS:
        plan = new_vol_plan(opt_tpu_torch, energies, kind, variant)
        cost, ms, launches = drive(plan, vol_inputs)
        print(f"path {label} {VOL_OUTER}x{VOL_LINEAR}: engine={plan.engine} "
              f"variant={plan.variant} {ms:.1f} ms (cold) launches="
              f"{launches}")
        if (plan.engine, plan.variant) != ("stream3d", want_variant):
            raise AssertionError(
                f"{label}: engine='auto' picked {plan.engine!r} "
                f"{plan.variant!r}, not 'stream3d' {want_variant!r}")
        check_launches(label, launches, expected_launches3d(
            kind, want_variant, VOL_OUTER, VOL_LINEAR))
        check_unknowns(plan, vol_shapes)
        check_cost(label, cost, want_cost)
        name = f"{label} {VOL_OUTER}x{VOL_LINEAR}"
        best = best_of_3(torch, plan, vol_inputs, "auto", f"{name} (warm)",
                         card)
        profile_solve(torch, plan, vol_inputs, "auto", name, card, best)

    # -- slice 4: the graph kernels, then arap at 10k vertices ------------
    print(f"[{time.perf_counter() - t_start:.1f} s] slice 4")
    check_graph_kernels(torch, dev, MESH, TIMING_REPS)
    timings.update(check_graph_kernels(torch, dev, BIG_MESH,
                                       BIG_TIMING_REPS))
    print(f"[{time.perf_counter() - t_start:.1f} s] slice-4 paths")
    run_graph_paths(torch, drive, card)

    # -- slice 5: the whole-loop kernels and the stencil, then their paths -
    print(f"[{time.perf_counter() - t_start:.1f} s] slice 5")
    timings.update(check_slice5_kernels(torch, dev, BIG_TIMING_REPS))
    run_slice5_paths(torch, drive_call, card)

    # -- slice 6: the slab kernels, then the paths over a mesh of slabs ----
    print(f"[{time.perf_counter() - t_start:.1f} s] slice 6")
    timings.update(check_slab_kernels(torch, dev, BIG_TIMING_REPS))
    run_shard_paths(torch, drive_call, card)

    rows = []
    for name, src, repl, case in (
        ("warp_jtj_apply", "opt_tpu_torch/csrc/warp_kernels.cu",
         "opt_tpu/ops/vmem_solver.py:206", "warp_jtj_apply"),
        ("pcg_update", "opt_tpu_torch/csrc/pcg_update.cu",
         "opt_tpu/ops/pcg_pallas.py:50", "pcg_update"),
        ("warp_linearize", "opt_tpu_torch/csrc/warp_kernels.cu",
         "opt_tpu/ops/vmem_solver.py:206", "warp_linearize"),
        ("warp_hat_apply", "opt_tpu_torch/csrc/stream_kernels.cu",
         "opt_tpu/ops/stream_solver.py:763", "warp_hat_apply(lm)"),
        ("warp_pipelined_sweep", "opt_tpu_torch/csrc/stream_kernels.cu",
         "opt_tpu/ops/stream_solver.py:1216", "warp_pipelined_sweep"),
        ("vol_hat_apply", "opt_tpu_torch/csrc/stream3d_kernels.cu",
         "opt_tpu/ops/stream3d.py:842", "vol_hat_apply(lm, p_prev)"),
        ("vol_pipelined_sweep", "opt_tpu_torch/csrc/stream3d_kernels.cu",
         "opt_tpu/ops/stream3d.py:407", "vol_pipelined_sweep(gn)"),
        ("vol_linearize", "opt_tpu_torch/csrc/vol_kernels.cu",
         "opt_tpu/ops/stream3d.py:407", "vol_linearize"),
        ("graph_gather", "opt_tpu_torch/csrc/graph_kernels.cu",
         "opt_tpu/ops/onehot_pallas.py:40", "graph_gather(f32)"),
        ("graph_scatter", "opt_tpu_torch/csrc/graph_kernels.cu",
         "opt_tpu/ops/onehot_pallas.py:52", "graph_scatter(f32)"),
        ("graph_hat_apply", "opt_tpu_torch/csrc/graph_kernels.cu",
         "opt_tpu/ops/graph_pcg_kernel.py:250",
         "graph_hat_apply(gn, p_prev)"),
        ("poisson_cg", "opt_tpu_torch/csrc/poisson_kernels.cu",
         "opt_tpu/ops/poisson_pallas.py:63", "poisson_cg(C=4, 512x512)"),
        ("resident_pcg", "opt_tpu_torch/csrc/resident_kernels.cu",
         "opt_tpu/ops/stream_solver.py:378", "resident_pcg(warp, 512x512)"),
        ("stencil_apply", "opt_tpu_torch/csrc/stencil_kernels.cu",
         "opt_tpu/ops/halo_stencil.py:51",
         "stencil_apply(radius1, 4096x4096)"),
        ("warp_slab_apply", "opt_tpu_torch/csrc/stream_kernels.cu",
         "opt_tpu/parallel/stream_shard.py:158", "warp_slab_apply"),
        ("vol_slab_apply", "opt_tpu_torch/csrc/stream3d_kernels.cu",
         "opt_tpu/parallel/stream_shard.py:610", "vol_slab_apply"),
    ):
        err = max(v["max_abs_err"] for k, v in timings.items()
                  if k.split("(")[0] == name)
        counters = ROW_COUNTERS.get(name) or [
            k for k in total if k.endswith("." + name)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl,
                     "launches": sum(total[k] for k in counters),
                     "max_abs_err": err,
                     # K1, K3, K6, K8, K11, K15 and K16: the profiled
                     # device time a launch (K11: its two passes
                     # together); the CUDA events' time a call where the
                     # profiler saw no launch
                     "ms": timings[case].get("device_ms",
                                             timings[case]["ms"]),
                     "ms_from": ("profiler" if "device_ms" in timings[case]
                                 else "cuda events"),
                     "plain_ms": timings[case]["plain_ms"],
                     "bound_ms": timings[case]["bound_ms"],
                     "bound_by": timings[case]["bound_by"],
                     # index_select, index_add_ and conv2d compute K9's,
                     # K10's and K14's functions; no single PyTorch call
                     # computes the others
                     "library_ms": timings[case].get("library_ms")})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
