// The poisson_image_editing energy's J^T J apply at one pixel, shared by
// K12 (poisson_kernels.cu) and K13's poisson mode (resident_kernels.cu).
//
// The energy (opt_tpu_torch/energies.py poisson_image_editing), per pixel
// q, channel c and direction d in {(+1,0), (-1,0), (0,+1), (0,-1)}:
//   r_{q,d} = [q + d in the H x W domain] ((X(q) - X(q+d)) - (T(q) - T(q+d)))
// so J has +1 at q and -1 at q + d in each row, the same for every
// channel, and rows are not masked (only the cost is).  With
// m_d(q) = [q + d in the domain]:
//   (J^T J v)(q) = sum_d m_d(q) (v(q) - v(q+d)) - m_d(q-d) (v(q-d) - v(q))
// (opt_tpu/ops/poisson_pallas.py:11-16, :69-74).  Radius 1: a pixel reads
// its four neighbours.  The caller masks the unknown side.
//
// The JAX kernel pads W to 128 lanes and masks the padded lanes
// (poisson_pallas.py:33-49): TPU scaffolding, not ported.

#pragma once

#include <cuda_runtime.h>

namespace {

// (J^T J v)(i, j) of one channel; v(i', j') reads v at a pixel inside the
// domain (the caller's scaling and layout)
template <class Read>
__device__ __forceinline__ float poisson_jtj_at(int i, int j, int H, int W,
                                                const Read& v) {
  constexpr int dx[4] = {1, -1, 0, 0};
  constexpr int dy[4] = {0, 0, 1, -1};
  const float vq = v(i, j);
  float a = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int ni = i + dy[t], nj = j + dx[t];
    if (ni >= 0 && ni < H && nj >= 0 && nj < W) a += vq - v(ni, nj);
    const int mi = i - dy[t], mj = j - dx[t];
    if (mi >= 0 && mi < H && mj >= 0 && mj < W) a -= v(mi, mj) - vq;
  }
  return a;
}

// The energy for resident_pcg.cuh: C channels of an H x W grid, component
// (pixel k, channel c) of the vectors at k * ps + c * cs and of sq at
// k * sps + c * scs.  K12 reads (C, H, W) planes and a (H, W) keep mask
// (ps 1, cs H W, sps 1, scs 0); K13 the solver's flat (H, W, C) vector
// and its sq (ps = sps = C, cs = scs = 1).
struct PoissonHat {
  static constexpr int kComp = 4;
  int H, W, C;
  int ps, cs, sps, scs;
  __device__ int comps() const { return C; }
  __device__ int idx(int k, int c) const { return k * ps + c * cs; }
  __device__ int sq_idx(int k, int c) const { return k * sps + c * scs; }
  // a[c] = sq (J^T J (sq p)) at pixel k; p at the neighbours through L2
  __device__ void hat(int k, const float* sq, const float* p,
                      float* a) const {
    const int i = k / W, j = k - i * W;
#pragma unroll
    for (int c = 0; c < kComp; ++c) {
      a[c] = 0.f;
      if (c < C) {
        const auto v = [&](int ii, int jj) {
          const int q = ii * W + jj;
          return sq[sq_idx(q, c)] * __ldcg(p + idx(q, c));
        };
        a[c] = sq[sq_idx(k, c)] * poisson_jtj_at(i, j, H, W, v);
      }
    }
  }
};

}  // namespace
