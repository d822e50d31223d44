// K12 poisson_cg: the whole conjugate-gradient solve of poisson image
// editing's delta system, every channel at once, in one cooperative
// launch.
//
// Replaces the TPU kernel opt_tpu/ops/poisson_pallas.py:_kernel
// (poisson_cg_vmem), the reference's inside baseline for poisson
// (WarpingSolver.cu): b = -J^T F and the keep mask in, delta out after a
// fixed n_iters of CG on keep . J^T J (poisson_energy.cuh), with
// r0 = keep . b, no preconditioner, and alpha and beta per channel.  The
// JAX solver makes one call per channel (poisson_pallas.py:159-165); the
// channels are independent systems, so one launch with per-channel
// scalars computes the same result.  The loop is resident_pcg.cuh's.
//
// Bound on the card: what the function must move is small (b and keep
// in, delta out: 2C + 1 planes), so its bound is its arithmetic, 17 flops
// an element an iteration: J^T J p as 2 (deg p - the sum of the in-domain
// neighbours), 6, the keep multiply, 1, the two dots, 4, and the three
// updates, 6.  (poisson_jtj adds each neighbour difference twice, about
// 16 flops for those 6: the apply is not what limits this kernel, the grid
// syncs and the bytes are.)  What the kernel moves is about 9 planes a
// channel an iteration (the apply reads r, p_prev and delta and writes p,
// Ap and delta, the update reads r and Ap and writes r; 11 planes and three
// syncs an iteration before the loop formed p and took the delta step in
// the apply): at 512^2 x 4 channels the five work vectors (21 MB) stay in
// the 50 MB L2; at 2048^2 they stream from device memory.  Two grid syncs
// an iteration add a fixed cost each.  ptxas (CUDA 12.8, sm_90a): 64
// registers, no spills, under PoissonLoop's cap of 4 blocks of 256 threads
// an SM (128 registers and half the blocks without it: slower).

#include "poisson_energy.cuh"
#include "resident_pcg.cuh"

namespace {
using PoissonCg = PoissonLoop<true, true>;
}  // namespace

// the grid opt_poisson_cg launches over n_pix pixels (or minus the CUDA
// error of the occupancy query)
extern "C" int opt_poisson_cg_blocks(int n_pix) {
  return coop::grid_blocks(
      coop::capacity(coop::pcg_kernel<PoissonCg>, PoissonCg::kThreads),
      (n_pix + PoissonCg::kThreads - 1) / PoissonCg::kThreads);
}

// b, delta, r, p0, p1, ap: (C, H, W); keep: (H, W), 1 where the pixel is
// free; parts: 2 C blocks floats of scratch
extern "C" int opt_poisson_cg(const float* b, const float* keep, float* delta,
                              float* r, float* p0, float* p1, float* ap,
                              float* parts, int C, int H, int W, int n_iters,
                              int blocks, void* stream) {
  if (C < 1 || C > PoissonCg::kComp) return (int)cudaErrorInvalidValue;
  const PoissonCg loop{H, W, C, 0, keep, b, delta, r, {p0, p1}, ap, parts};
  return coop::launch(loop, n_iters, blocks, stream);
}
