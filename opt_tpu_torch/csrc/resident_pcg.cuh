// A whole PCG loop in one cooperative persistent launch, shared by K12
// poisson_cg (poisson_kernels.cu) and K13 resident_pcg
// (resident_kernels.cu).
//
// On the TPU both loops run inside one Pallas kernel with every work
// vector resident in VMEM (opt_tpu/ops/poisson_pallas.py:63-97,
// opt_tpu/ops/stream_solver.py:424-550).  Here every block of the grid is
// resident at once (the grid is sized from the occupancy query, the launch
// is cudaLaunchCooperativeKernel) and walks its pixels; the work vectors
// stay in device memory, which at 512^2 the 50 MB L2 holds.  Each
// iteration is two phases separated by grid syncs:
//   1. p = r + beta p_prev, formed on the fly wherever the apply reads it
//      (the thread's own pixels and their neighbours) as
//      __fmaf_rn(beta, p_prev, r), from r and p_prev, both written before
//      the last sync; the own pixels' p written to the other buffer of a
//      ping-pong pair; Ap = A p and the block partials of <p, Ap>; and at
//      the own pixels the last iteration's step delta += alpha p_prev,
//      deferred to where p_prev is read anyway;
//   2. alpha = an / <p, Ap>; r -= alpha Ap, and the partials of <r, r>;
//      then beta = <r, r> / an and an = <r, r>.
// After the loop a last sweep of the own pixels takes the last step,
// delta += alpha p.  Iteration 0 runs with beta = 0, alpha = 0 and
// p_prev = 0 (zeroed at the start), so p = r0 exactly.  The classic loop's
// third phase (p = r + beta p over the vector, then a third sync) is
// folded into the next apply, and the delta step moves from phase 2 into
// the next apply: the same arithmetic, one sync and four passes over the
// vector fewer (9 an iteration, 11 before).  One explicit __fmaf_rn forms
// p at every site, so a pixel's p is the same float in its own apply, in
// each neighbour's and in the delta step (nvcc's contraction could
// otherwise differ between sites).  The guards
// of poisson_pallas.py:86-90 and stream_solver.py:514-534 hold (alpha = 0
// where <p, Ap> = 0, beta = 0 where an = 0), with a fixed trip count and
// no early exit.  A = diag(sq) J^T J diag(sq): the energy E gives J^T J at
// a pixel, sq is the hat space's sqrt(pre) (K13) or the 0/1 keep mask
// (K12).  Not taken: a one-reduction recurrence (Chronopoulos-Gear, or the
// Ghysels-Vanroose form of K5), which computes other float32 iterates than
// the TPU kernels' classic loop.
//
// The partials are fixed-tree block sums, and after each sync every block
// sums the whole partial array in the same order, so every block holds
// the same alpha and beta, with no float atomics and no extra sync to
// broadcast them; repeated launches match bit for bit (the grid size,
// fixed by the card and the build, decides the order).
//
// r, the two p buffers, Ap and delta are written and read back inside the
// launch: they are never read through the read-only path (no __ldg, no
// const __restrict__), and a read of a value another thread wrote (r and
// p_prev at a neighbour, a partial) goes through L2 with __ldcg, after the
// grid sync that ordered the write.  A thread gives both phases the same
// pixels and reads back its own pixels' p, Ap and delta plainly.
//
// A problem L for the loop provides kThreads (its block), kMinBlocks (the
// blocks an SM should hold, which caps the registers), kGroups (the most
// dot groups: one alpha and beta each), groups(), the pointers
// p[2] and parts, and four sweeps over the thread's own pixels:
//   start(acc)                         r = r0, p[0] = 0, delta = 0;
//                                      acc[g] += r0 . r0
//   apply(p_prev, p, beta, alpha, acc) p as above, Ap, delta +=
//                                      alpha p_prev; acc[g] += p . Ap
//   update(alpha, acc)                 r -= alpha Ap; acc[g] += r . r
//   finish(p, alpha)                   delta += alpha p
// (K12: a group a channel, alpha and beta per channel, poisson_pallas.py
// :159-165; K13: one group for the whole vector.)

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {
namespace coop {

// The sum over the block's N threads, (32, N / 32) of them: a shuffle
// tree in each warp (lane 0's order), then the warps' sums in warp order,
// the same order on every run; every thread gets the sum.
template <int N>
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x == 0) sh[threadIdx.y] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < N / 32; ++w) s += sh[w];
  __syncthreads();  // sh is the next sum's
  return s;
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b != 0.f ? a / b : 0.f;
}

__device__ __forceinline__ bool leader() {
  return threadIdx.x == 0 && threadIdx.y == 0;
}

// parts[g * G + block] = the block's sum of acc[g], for g < ng
template <int N, int KG>
__device__ __forceinline__ void put_partials(const float (&acc)[KG], int ng,
                                             float* parts, float* sh) {
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < ng) {
      const float s = block_sum<N>(acc[g], sh);
      if (leader()) parts[g * gridDim.x + blockIdx.x] = s;
    }
  }
}

// out[g] = the sum of every block's partial of group g, in one fixed
// order (the same in every block)
template <int N, int KG>
__device__ __forceinline__ void grid_totals(const float* parts, int ng,
                                            float (&out)[KG], float* sh) {
  const int G = gridDim.x;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < ng) {
      float s = 0.f;
      for (int b = t; b < G; b += N) s += __ldcg(parts + g * G + b);
      out[g] = block_sum<N>(s, sh);
    } else {
      out[g] = 0.f;
    }
  }
}

// Two grid syncs an iteration (and one before the loop)
template <class L>
__global__ void __launch_bounds__(L::kThreads, L::kMinBlocks)
pcg_kernel(L loop, int n_iters) {
  constexpr int N = L::kThreads;
  constexpr int KG = L::kGroups;
  __shared__ float sh[N];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int ng = loop.groups();
  float* pap_parts = loop.parts;
  float* rr_parts = loop.parts + ng * gridDim.x;
  float an[KG], acc[KG], alpha[KG], beta[KG], tot[KG];

#pragma unroll
  for (int g = 0; g < KG; ++g) acc[g] = alpha[g] = beta[g] = 0.f;
  loop.start(acc);
  put_partials<N>(acc, ng, rr_parts, sh);
  grid.sync();
  grid_totals<N>(rr_parts, ng, an, sh);

  for (int it = 0; it < n_iters; ++it) {
    // phase 1: p from r and p_prev, Ap, <p, Ap>; the last delta step
#pragma unroll
    for (int g = 0; g < KG; ++g) acc[g] = 0.f;
    // (a select, not loop.p[it & 1]: an index that varies would copy the
    // loop's parameters to local memory)
    const bool odd = it & 1;
    loop.apply(odd ? loop.p[1] : loop.p[0], odd ? loop.p[0] : loop.p[1],
               beta, alpha, acc);
    put_partials<N>(acc, ng, pap_parts, sh);
    grid.sync();

    // phase 2: alpha; r -= alpha Ap, <r, r>; beta
    grid_totals<N>(pap_parts, ng, tot, sh);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      alpha[g] = safe_div(an[g], tot[g]);
      acc[g] = 0.f;
    }
    loop.update(alpha, acc);
    put_partials<N>(acc, ng, rr_parts, sh);
    grid.sync();
    grid_totals<N>(rr_parts, ng, tot, sh);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      beta[g] = safe_div(tot[g], an[g]);
      an[g] = tot[g];
    }
  }
  loop.finish((n_iters & 1) ? loop.p[1] : loop.p[0], alpha);
}

// The blocks of `kernel` (threads a block) the current card holds at
// once: its occupancy with the kernel's real registers and shared memory,
// times the SMs; a cooperative grid may hold no more.  Minus the CUDA
// error where the query fails, or where not one block fits on an SM.
template <class Kernel>
int capacity(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: it is this query's, not a launch's
    return -(int)err;
  }
  if (per_sm == 0) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return per_sm * sms;
}

// The grid over `work` tiles on a card that holds `cap` blocks (or minus
// a CUDA error): one block a tile, at most cap; past that, the blocks
// stride over the tiles
inline int grid_blocks(int cap, long work) {
  if (cap <= 0) return cap;
  return work < cap ? (work > 0 ? (int)work : 1) : cap;
}

// One cooperative launch of `blocks` blocks of L::kThreads threads
// (block: (32, N / 32)); returns the launch's error
// (cudaErrorCooperativeLaunchTooLarge for a grid the card cannot hold at
// once) or cudaGetLastError()
template <class L>
int launch(const L& loop, int n_iters, int blocks, void* stream) {
  void* args[] = {const_cast<L*>(&loop), &n_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pcg_kernel<L>, dim3(blocks),
      dim3(32, L::kThreads / 32), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? (int)err : (int)last;
}

}  // namespace coop
}  // namespace
