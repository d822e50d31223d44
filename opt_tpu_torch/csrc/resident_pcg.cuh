// A whole PCG loop in one cooperative persistent launch, shared by K12
// poisson_cg (poisson_kernels.cu) and K13 resident_pcg
// (resident_kernels.cu).
//
// On the TPU both loops run inside one Pallas kernel with every work
// vector resident in VMEM (opt_tpu/ops/poisson_pallas.py:63-97,
// opt_tpu/ops/stream_solver.py:424-550).  Here every block of the grid is
// resident at once (the grid is sized from the occupancy query, the launch
// is cudaLaunchCooperativeKernel) and walks its pixels with a grid stride;
// the work vectors stay in device memory, which at 512^2 the 50 MB L2
// holds.  Each iteration is three phases separated by grid syncs:
//   1. Ap = A p and the block partials of <p, Ap>;
//   2. alpha = an / <p, Ap>; delta += alpha p, r -= alpha Ap, and the
//      partials of <r, r>;
//   3. beta = <r, r> / an; p = r + beta p; an = <r, r>.
// with the guards of poisson_pallas.py:86-90 and stream_solver.py:514-534
// (alpha = 0 where <p, Ap> = 0, beta = 0 where an = 0), a fixed trip
// count and no early exit.  A = diag(sq) J^T J diag(sq): the energy E
// gives J^T J at a pixel, sq is the hat space's sqrt(pre) (K13) or the
// 0/1 keep mask (K12).
//
// The partials are fixed-tree block sums, and after each sync every block
// sums the whole partial array in the same order, so every block holds
// the same alpha and beta, with no float atomics and no extra sync to
// broadcast them; repeated launches match bit for bit (the grid size,
// fixed by the card and the build, decides the order).
//
// p, r, Ap and delta are written and read back inside the launch: they
// are never read through the read-only path (no __ldg, no const
// __restrict__), and a read of another thread's value (p at a neighbour,
// a partial) goes through L2 with __ldcg, after the grid sync that
// ordered the write.  A thread reads its own pixels' values plainly: the
// grid stride gives it the same pixels in every phase.
//
// kPerComp: every component (channel) of a pixel has its own alpha and
// beta (K12: poisson's channels are independent systems,
// poisson_pallas.py:159-165); otherwise one set for the whole vector
// (K13).  kMaskRhs: r0 = sq . b (K12's b * keep); otherwise r0 = b (K13's
// b_hat, already scaled).
//
// An energy E provides kComp (the most components a pixel has), comps()
// (how many it has), idx(k, c) and sq_idx(k, c) (where component c of
// pixel k lives in the vectors and in sq), and hat(k, sq, p, a): a[c] =
// (A p) at pixel k, reading p at the neighbours with __ldcg.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {
namespace coop {

constexpr int kThreads = 256;

// Sum over the block's threads by a fixed shared-memory tree; every
// thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b != 0.f ? a / b : 0.f;
}

// parts[g * G + block] = the block's sum of acc[g], for g < ng
template <int KG>
__device__ __forceinline__ void put_partials(const float (&acc)[KG], int ng,
                                             float* parts, float* sh) {
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < ng) {
      const float s = block_sum(acc[g], sh);
      if (threadIdx.x == 0) parts[g * gridDim.x + blockIdx.x] = s;
    }
  }
}

// out[g] = the sum of every block's partial of group g, in one fixed
// order (the same in every block)
template <int KG>
__device__ __forceinline__ void grid_totals(const float* parts, int ng,
                                            float (&out)[KG], float* sh) {
  const int G = gridDim.x;
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < ng) {
      float s = 0.f;
      for (int b = threadIdx.x; b < G; b += kThreads)
        s += __ldcg(parts + g * G + b);
      out[g] = block_sum(s, sh);
    } else {
      out[g] = 0.f;
    }
  }
}

template <class E, bool kPerComp, bool kMaskRhs>
__global__ void __launch_bounds__(kThreads)
pcg_kernel(E e, const float* __restrict__ sq, const float* __restrict__ b,
           float* delta, float* r, float* p, float* ap, float* parts,
           int n_pix, int n_iters) {
  constexpr int K = E::kComp;
  constexpr int KG = kPerComp ? K : 1;
  __shared__ float sh[kThreads];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int comps = e.comps();
  const int ng = kPerComp ? comps : 1;
  float* pap_parts = parts;
  float* rr_parts = parts + ng * gridDim.x;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  float an[KG], acc[KG], alpha[KG], beta[KG], tot[KG];

  // r = p = r0, delta = 0, an = <r0, r0>
#pragma unroll
  for (int g = 0; g < KG; ++g) acc[g] = 0.f;
  for (int k = first; k < n_pix; k += stride) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < comps) {
        const int i = e.idx(k, c);
        const float v = kMaskRhs ? sq[e.sq_idx(k, c)] * b[i] : b[i];
        r[i] = v;
        p[i] = v;
        delta[i] = 0.f;
        acc[kPerComp ? c : 0] += v * v;
      }
    }
  }
  put_partials(acc, ng, rr_parts, sh);
  grid.sync();
  grid_totals(rr_parts, ng, an, sh);

  for (int it = 0; it < n_iters; ++it) {
    // phase 1: Ap, <p, Ap>
#pragma unroll
    for (int g = 0; g < KG; ++g) acc[g] = 0.f;
    for (int k = first; k < n_pix; k += stride) {
      float a[K];
      e.hat(k, sq, p, a);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (c < comps) {
          const int i = e.idx(k, c);
          ap[i] = a[c];
          acc[kPerComp ? c : 0] += p[i] * a[c];
        }
      }
    }
    put_partials(acc, ng, pap_parts, sh);
    grid.sync();

    // phase 2: alpha; delta += alpha p, r -= alpha Ap, <r, r>
    grid_totals(pap_parts, ng, tot, sh);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      alpha[g] = safe_div(an[g], tot[g]);
      acc[g] = 0.f;
    }
    for (int k = first; k < n_pix; k += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (c < comps) {
          const int i = e.idx(k, c);
          const float al = alpha[kPerComp ? c : 0];
          delta[i] = delta[i] + al * p[i];
          const float rn = r[i] - al * ap[i];
          r[i] = rn;
          acc[kPerComp ? c : 0] += rn * rn;
        }
      }
    }
    put_partials(acc, ng, rr_parts, sh);
    grid.sync();

    // phase 3: beta = bn / an (the old an); p = r + beta p
    grid_totals(rr_parts, ng, tot, sh);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      beta[g] = safe_div(tot[g], an[g]);
      an[g] = tot[g];
    }
    for (int k = first; k < n_pix; k += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (c < comps) {
          const int i = e.idx(k, c);
          p[i] = r[i] + beta[kPerComp ? c : 0] * p[i];
        }
      }
    }
    grid.sync();
  }
}

// The grid a cooperative launch of `kernel` over n_pix pixels takes: as
// many blocks as the card holds at once (occupancy x SMs, with the
// kernel's real registers and shared memory), at most one per kThreads
// pixels.  A negative value is minus the CUDA error that stopped the
// query.
template <class Kernel>
int grid_blocks(Kernel kernel, int n_pix) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: it is this query's, not a launch's
    return -(int)err;
  }
  if (per_sm == 0) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int work = (n_pix + kThreads - 1) / kThreads;
  const int most = per_sm * sms;
  return work < most ? (work > 0 ? work : 1) : most;
}

// One cooperative launch of blocks x kThreads threads; returns the
// launch's error (cudaErrorCooperativeLaunchTooLarge for a grid the card
// cannot hold at once) or cudaGetLastError().
template <class E, bool kPerComp, bool kMaskRhs>
int launch(E e, const float* sq, const float* b, float* delta, float* r,
           float* p, float* ap, float* parts, int n_pix, int n_iters,
           int blocks, void* stream) {
  void* args[] = {&e, &sq, &b, &delta, &r, &p, &ap, &parts, &n_pix,
                  &n_iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pcg_kernel<E, kPerComp, kMaskRhs>, dim3(blocks),
      dim3(kThreads), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? (int)err : (int)last;
}

}  // namespace coop
}  // namespace
