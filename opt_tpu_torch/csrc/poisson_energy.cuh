// The poisson_image_editing energy's J^T J apply, and the resident PCG
// loop over it that K12 (poisson_kernels.cu) and K13's poisson mode
// (resident_kernels.cu) run on resident_pcg.cuh.
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

// (J^T J v)(q) of one channel from v(q) and the neighbours' v in the
// energy's direction order (+x, -x, +y, -y), 0 for a neighbour outside the
// domain: each direction adds its own residual's share, then the share of
// the residual centred at the opposite neighbour, which reads q
// (v(q-d) - v(q) subtracted is vq - v(q-d) added, exactly)
__device__ __forceinline__ float poisson_jtj(float vq, const float (&vn)[4],
                                             const bool (&in)[4]) {
  float a = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (in[t]) a += vq - vn[t];
    if (in[t ^ 1]) a += vq - vn[t ^ 1];
  }
  return a;
}

// The loop for resident_pcg.cuh over C planes (C, H, W) of an H x W grid,
// a thread a pixel (every channel), the warp's lanes on consecutive pixels
// of the flat grid.  sq has a plane a channel (sq_cs = H W: K13's hat
// space) or one plane for all (sq_cs = 0: K12's keep mask).  kPerComp:
// alpha and beta per channel (K12); kMaskRhs: r0 = sq . b (K12's
// keep . b), else r0 = b (K13's b_hat).  The apply forms p at the pixel
// and its two neighbours along H from r and p_prev, and takes the two
// along W from the lanes beside it by shuffles (a lane at a row's end or
// the warp's loads its own); it reads every channel's centre first, so
// that their loads are in flight together.
template <bool kPerComp, bool kMaskRhs>
struct PoissonLoop {
  static constexpr int kComp = 4;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 4;  // 64 registers at most
  static constexpr int kGroups = kPerComp ? kComp : 1;
  int H, W, C;
  int sq_cs;
  const float* __restrict__ sq;
  const float* __restrict__ b;
  float* delta;
  float* r;
  float* p[2];
  float* ap;
  float* parts;

  __device__ int groups() const { return kPerComp ? C : 1; }
  __device__ static int grp(int c) { return kPerComp ? c : 0; }

  // f(k, in) over this warp's pixels k = base + lane, base a multiple of
  // 32 striding over the grid, in = k inside it (the whole warp runs each
  // step, so the apply's shuffles see every lane)
  template <class F>
  __device__ __forceinline__ void sweep(F f) const {
    const int HW = H * W;
    const int warp = threadIdx.y, lane = threadIdx.x;
    const int stride = gridDim.x * kThreads;
    for (int base = blockIdx.x * kThreads + warp * 32; base < HW;
         base += stride)
      f(base + lane, base + lane < HW);
  }

  // f(i, c, k) for each own element i, channel c of pixel k
  template <class F>
  __device__ __forceinline__ void own(F f) const {
    const int HW = H * W;
    sweep([&](int k, bool in) {
      if (!in) return;
#pragma unroll
      for (int c = 0; c < kComp; ++c)
        if (c < C) f(c * HW + k, c, k);
    });
  }

  template <int KG>
  __device__ __forceinline__ void start(float (&acc)[KG]) const {
    own([&](int i, int c, int k) {
      const float v = kMaskRhs ? sq[c * sq_cs + k] * b[i] : b[i];
      r[i] = v;
      p[0][i] = 0.f;
      delta[i] = 0.f;
      acc[grp(c)] += v * v;
    });
  }

  template <int KG>
  __device__ __forceinline__ void apply(const float* pp, float* pn,
                                        const float (&beta)[KG],
                                        const float (&alpha)[KG],
                                        float (&acc)[KG]) const {
    const int HW = H * W;
    const int lane = threadIdx.x;
    sweep([&](int k, bool in) {
      const int i = k / W, j = k - i * W;
      float pk[kComp], vk[kComp];
#pragma unroll
      for (int c = 0; c < kComp; ++c) {
        pk[c] = vk[c] = 0.f;
        if (c < C && in) {
          const int o = c * HW + k;
          const float ppk = __ldcg(pp + o);
          pk[c] = __fmaf_rn(beta[grp(c)], ppk, __ldcg(r + o));
          vk[c] = sq[c * sq_cs + k] * pk[c];
          delta[o] = delta[o] + alpha[grp(c)] * ppk;  // the last step
        }
      }
#pragma unroll
      for (int c = 0; c < kComp; ++c) {
        if (c < C) {
          const float bt = beta[grp(c)];
          const float* sc = sq + c * sq_cs;
          const int o = c * HW;
          // sq . p at pixel q, p formed from r and p_prev (through L2)
          const auto v = [&](int q) {
            return sc[q] * __fmaf_rn(bt, __ldcg(pp + o + q),
                                     __ldcg(r + o + q));
          };
          // the W neighbours from the lanes beside (same row: j -/+ 1 is
          // the lane before's or after's pixel), else a load
          const float left = __shfl_up_sync(0xffffffffu, vk[c], 1);
          const float right = __shfl_down_sync(0xffffffffu, vk[c], 1);
          if (!in) continue;
          const bool ins[4] = {j + 1 < W, j > 0, i + 1 < H, i > 0};
          float vn[4] = {0.f, 0.f, 0.f, 0.f};
          if (ins[0]) vn[0] = lane < 31 ? right : v(k + 1);
          if (ins[1]) vn[1] = lane > 0 ? left : v(k - 1);
          if (ins[2]) vn[2] = v(k + W);
          if (ins[3]) vn[3] = v(k - W);
          const float a = sc[k] * poisson_jtj(vk[c], vn, ins);
          pn[o + k] = pk[c];
          ap[o + k] = a;
          acc[grp(c)] += pk[c] * a;
        }
      }
    });
  }

  template <int KG>
  __device__ __forceinline__ void update(const float (&alpha)[KG],
                                         float (&acc)[KG]) const {
    own([&](int i, int c, int) {
      const float rn = r[i] - alpha[grp(c)] * ap[i];
      r[i] = rn;
      acc[grp(c)] += rn * rn;
    });
  }

  template <int KG>
  __device__ __forceinline__ void finish(const float* pl,
                                         const float (&alpha)[KG]) const {
    own([&](int i, int c, int) {
      delta[i] = delta[i] + alpha[grp(c)] * pl[i];
    });
  }
};

}  // namespace
