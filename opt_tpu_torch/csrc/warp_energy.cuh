// The image_warping energy's J^T J apply at one pixel, the gather form
// that K5 runs (stream_kernels.cu); K1, K4, K13 and K15 run on
// warp_tile.cuh's row-marching core instead.
//
// The energy, for pixel k (row i, column j) and stencil offset s in
// {(+1,0), (-1,0), (0,+1), (0,-1)} (x = column first), n = k + s:
//   reg  r_{k,s} = w_reg * ((O(k) - O(n)) - R(A(k)) (U(k) - U(n)))
//                  where InBounds(n) and Mask(n) == 0 and Mask(k) == 0
//   fit  f_k     = w_fit * (O(k) - C(k))  where C(k) >= 0 in both channels
// with R(a) the 2-D rotation, O the Offset (2 ch), A the Angle (1 ch),
// U the UrShape, C the Constraints.  d/da R(a) v = R'(a) v with
// R'(a) = [[-sin a, -cos a], [cos a, -sin a]].
//
// Gather form: pixel k sums the 4 residuals centred at k and the 4
// residuals centred at m = k - s that read k as their neighbour, so the
// halo is one pixel and no thread writes another thread's output.
//
// Layout: the flat unknown vector holds Offset as (H, W, 2) then Angle as
// (H, W, 1); UrShape and Constraints are (H, W, 2), Mask (H, W, 1).

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;

// stencil offsets in the energy's order, (dx, dy) = (column, row)
__constant__ int kDX[4] = {1, -1, 0, 0};
__constant__ int kDY[4] = {0, 0, 1, -1};

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * kBX + threadIdx.x;
}

// Sum over the block's threads by a fixed shared-memory tree (the same
// order on every run: no float atomics); every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int t = thread_rank();
  sh[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// blocks in z-major order: a slab launch's partials come slab by slab
__device__ __forceinline__ int block_rank() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

// The H x W array a kernel indexes and where it lies in the global grid:
// row0 is the global row of the array's row 0, Hg the global height.
// inside() is both the array bound and the energy's InBounds, which tests
// global rows: on an extended slab of a sharded grid (K3's offset mode,
// K15) a zero-filled halo row past the global edge is outside the grid,
// not a neighbour that holds 0.  A whole grid (Grid{H, W}: K1, K4, K5,
// K13) keeps row0 = 0 and an unbounded Hg, so there the two coincide.
struct Grid {
  int H, W;
  int row0 = 0;
  int Hg = INT_MAX;
  __device__ bool inside(int i, int j) const {
    return i >= 0 && i < H && j >= 0 && j < W && row0 + i >= 0 &&
           row0 + i < Hg;
  }
};

// The rows of a launch over a batch of extended slabs (one per
// blockIdx.z): S slabs of n own rows with he halo rows above and below,
// slab s's array row 0 at global row row0 + s * n, in a grid of Hg rows.
// Each slab's arrays are the flat layout of an (n + 2 he) x W grid, one
// slab after another; outputs cover the own rows only, in the local
// layout (Offset (S, n, W, 2) then Angle (S, n, W, 1)).  A whole grid is
// Slabs{1, H, 0, 0, H}.
struct Slabs {
  int S, n, he, row0, Hg;
  __device__ int rows() const { return n + 2 * he; }
  __device__ Grid grid(int s, int W) const {
    return Grid{rows(), W, row0 + s * n, Hg};
  }
};

// R'(a) d for d = U(m) - U(n)
__device__ __forceinline__ void drot(float s, float c, float d0, float d1,
                                     float* g0, float* g1) {
  *g0 = -s * d0 - c * d1;
  *g1 = c * d0 - s * d1;
}

// (J^T J v)(k) for a pixel k whose Mask is 0, given v(k) = (vk0, vk1, vkA)
// and a reader for v at the neighbours.
template <class Read>
__device__ __forceinline__ void jtj_at(
    const Grid& g, int i, int j, const float* __restrict__ angle,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ mask, float w_fit, float w_reg, float vk0,
    float vk1, float vkA, const Read& read, float* out0, float* out1,
    float* outA) {
  const int W = g.W;
  const int k = i * W + j;
  const float uk0 = ur[2 * k], uk1 = ur[2 * k + 1];
  float sk, ck;
  sincosf(angle[k], &sk, &ck);
  float a0 = 0.f, a1 = 0.f, aA = 0.f;
  for (int t = 0; t < 4; ++t) {
    // residual centred at k, reading n = k + s
    const int ni = i + kDY[t], nj = j + kDX[t];
    if (g.inside(ni, nj)) {
      const int n = ni * W + nj;
      if (mask[n] == 0.f) {
        float g0, g1, vn0, vn1, vnA;
        read(n, &vn0, &vn1, &vnA);
        drot(sk, ck, uk0 - ur[2 * n], uk1 - ur[2 * n + 1], &g0, &g1);
        const float jp0 = w_reg * ((vk0 - vn0) - g0 * vkA);
        const float jp1 = w_reg * ((vk1 - vn1) - g1 * vkA);
        a0 += w_reg * jp0;
        a1 += w_reg * jp1;
        aA += -w_reg * g0 * jp0 + -w_reg * g1 * jp1;
      }
    }
    // residual centred at m = k - s, reading k
    const int mi = i - kDY[t], mj = j - kDX[t];
    if (g.inside(mi, mj)) {
      const int m = mi * W + mj;
      if (mask[m] == 0.f) {
        float sm, cm, g0, g1, vm0, vm1, vmA;
        read(m, &vm0, &vm1, &vmA);
        sincosf(angle[m], &sm, &cm);
        drot(sm, cm, ur[2 * m] - uk0, ur[2 * m + 1] - uk1, &g0, &g1);
        const float jp0 = w_reg * ((vm0 - vk0) - g0 * vmA);
        const float jp1 = w_reg * ((vm1 - vk1) - g1 * vmA);
        a0 -= w_reg * jp0;
        a1 -= w_reg * jp1;
      }
    }
  }
  if (cons[2 * k] >= 0.f && cons[2 * k + 1] >= 0.f) {
    a0 += w_fit * (w_fit * vk0);
    a1 += w_fit * (w_fit * vk1);
  }
  *out0 = a0;
  *out1 = a1;
  *outA = aA;
}

dim3 warp_grid(int H, int W, int S = 1) {
  return dim3((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, S);
}

}  // namespace
