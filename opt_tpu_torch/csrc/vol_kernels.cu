// K8 vol_linearize: the volumetric ARAP energy's outer step, written out
// by hand -- J^T F, diag(J^T J) and the cost at x, the cost alone, or LM's
// model cost 0.5 sum (F + J delta)^2.
//
// The JAX package runs this step in fused XLA around its 3-D streamed
// kernels (opt_tpu/ops/stream3d.py StreamSolver3D.solve, whose PCG kernels
// StreamSolver3D._build_pipelined_kernel and _build_classic_kernel trace
// the energy's evaluator).  Here it is one kernel, for the reason K3 is
// one for image_warping: the plain engine re-traces torch.func.linearize
// every outer step, and at 128^3 (12.6 M unknowns) that would set the pace
// of the solve.  vol_energy.cuh states the energy and its derivatives.
//
// Bound on the card: device memory.  The full mode reads x (24 B per
// voxel), UrShape and Constraints (24 B) and writes J^T F and diag (48 B):
// 96 B per voxel, 201 MB at 128^3, which is 60 us at 3.35 TB/s.  The 21
// sincosf per voxel (its own angles and, for the residuals that read it,
// each neighbour's) are the arithmetic; neighbour reads are served by
// L1/L2 (a 32x8 block touches a 34x10x3 footprint).  One thread per voxel,
// blocks of 32 (W, the contiguous axis) x 8 (H), D on the grid; the cost is
// per-block partials from a fixed shared-memory tree, summed by the caller
// (no float atomics: repeated runs match bit for bit).  sincosf is the
// full-precision version: the build uses no --use_fast_math.

#include "vol_energy.cuh"

namespace {

enum LinearizeMode { kFull = 0, kCostOnly = 1, kModelCost = 2 };

__global__ void __launch_bounds__(kVThreads)
vol_linearize_kernel(const float* __restrict__ x,
                     const float* __restrict__ ur,
                     const float* __restrict__ cons,
                     const float* __restrict__ params,
                     const float* __restrict__ delta,
                     float* __restrict__ jtf, float* __restrict__ diag,
                     float* __restrict__ cost_partials, int H, int W,
                     VolSlabs sl, int mode) {
  __shared__ float sh[kVThreads];
  // blockIdx.z = sb * n + dc: own plane dc of slab sb, at array plane
  // he + dc of its slab (a whole volume is one slab with no halo)
  const int sb = blockIdx.z / sl.n, dc = blockIdx.z % sl.n;
  const Vol g = sl.vol(sb, H, W);
  const int w = blockIdx.x * kVX + threadIdx.x;
  const int h = blockIdx.y * kVY + threadIdx.y;
  const int d = sl.he + dc;
  const int N = g.n();
  // this slab's arrays
  x += (size_t)sb * 6 * N;
  ur += (size_t)sb * 3 * N;
  cons += (size_t)sb * 3 * N;
  if (delta != nullptr) delta += (size_t)sb * 6 * N;
  const float* angle = x + 3 * N;
  const bool derivs = mode == kFull;
  const bool model = mode == kModelCost;
  float cost = 0.f;
  if (h < H && w < W) {
    const int k = g.idx(d, h, w);
    const float w_fit = params[0], w_reg = params[1];
    float O[3], A[3], dO[3] = {0.f, 0.f, 0.f}, dA[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 3; ++c) {
      O[c] = x[3 * k + c];
      A[c] = angle[3 * k + c];
      if (model) {
        dO[c] = delta[3 * k + c];
        dA[c] = delta[3 * N + 3 * k + c];
      }
    }
    const Trig tk = trig(A);
    float jO[3] = {0.f, 0.f, 0.f}, jA[3] = {0.f, 0.f, 0.f};
    float gA[3] = {0.f, 0.f, 0.f}, gO = 0.f, ssq = 0.f;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      int dw, dh, dd;
      offset(t, &dw, &dh, &dd);
      float e[3], re[3], r[3];
      // residual centred at k, reading n = k + o
      if (g.inside(d + dd, h + dh, w + dw)) {
        const int n = g.idx(d + dd, h + dh, w + dw);
        ur_diff(ur, k, n, e);
        rot(tk, e, re);
        for (int c = 0; c < 3; ++c)
          r[c] = w_reg * ((O[c] - x[3 * n + c]) - re[c]);
        if (model || derivs) {
          float G[3][3];
          drot(tk, e, G);
          if (model) {
            // r + J delta: the linear model of this residual
            const float nO[3] = {delta[3 * n], delta[3 * n + 1],
                                 delta[3 * n + 2]};
            float jd[3];
            arap_jv(w_reg, G, dO, nO, dA, jd);
            for (int c = 0; c < 3; ++c) r[c] += jd[c];
          }
          if (derivs) {
            for (int c = 0; c < 3; ++c) jO[c] += w_reg * r[c];
            for (int q = 0; q < 3; ++q) {
              jA[q] -= w_reg * (G[q][0] * r[0] + G[q][1] * r[1] +
                                G[q][2] * r[2]);
              gA[q] += w_reg * w_reg *
                       (G[q][0] * G[q][0] + G[q][1] * G[q][1] +
                        G[q][2] * G[q][2]);
            }
            gO += w_reg * w_reg;
          }
        }
        ssq += r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      }
      if (!derivs) continue;
      // residual centred at m = k - o, reading k
      if (g.inside(d - dd, h - dh, w - dw)) {
        const int m = g.idx(d - dd, h - dh, w - dw);
        ur_diff(ur, m, k, e);
        rot(trig(angle + 3 * m), e, re);
        for (int c = 0; c < 3; ++c)
          jO[c] -= w_reg * (w_reg * ((x[3 * m + c] - O[c]) - re[c]));
        gO += w_reg * w_reg;
      }
    }
    if (cons[3 * k] >= kFitValid) {
      for (int c = 0; c < 3; ++c) {
        float f = w_fit * (O[c] - cons[3 * k + c]);
        if (model) f += w_fit * dO[c];
        ssq += f * f;
        jO[c] += w_fit * f;
      }
      gO += w_fit * w_fit;
    }
    cost = 0.5f * ssq;
    if (derivs) {
      // the own voxel in the local layout
      const int ko = ((sb * sl.n + dc) * H + h) * W + w;
      const int No = sl.S * sl.n * H * W;
      for (int c = 0; c < 3; ++c) {
        jtf[3 * ko + c] = jO[c];
        jtf[3 * No + 3 * ko + c] = jA[c];
        diag[3 * ko + c] = gO;
        diag[3 * No + 3 * ko + c] = gA[c];
      }
    }
  }
  const float s = vblock_sum(cost, sh);
  if (vthread_rank() == 0) cost_partials[vblock_rank()] = s;
}

}  // namespace

extern "C" int opt_vol_blocks(int D, int H, int W) {
  const dim3 gr = vol_grid(D, H, W);
  return (int)(gr.x * gr.y * gr.z);
}

// mode: 0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum (F + J delta)^2 alone.  delta is read only in mode 2, jtf and
// diag written only in mode 0.
extern "C" int opt_vol_linearize(const float* x, const float* ur,
                                 const float* cons, const float* params,
                                 const float* delta, float* jtf, float* diag,
                                 float* cost_partials, int D, int H, int W,
                                 int mode, void* stream) {
  vol_linearize_kernel<<<vol_grid(D, H, W), dim3(kVX, kVY), 0,
                         (cudaStream_t)stream>>>(
      x, ur, cons, params, delta, jtf, diag, cost_partials, H, W,
      VolSlabs{1, D, 0, 0, D}, mode);
  return (int)cudaGetLastError();
}

// K8's global-offset mode over S extended D slabs (VolSlabs in
// vol_energy.cuh): the arrays hold S slabs of n + 2 he planes, slab s's
// plane 0 at global plane d0 + s * n of Dg; jtf and diag cover the own
// planes in the local layout, the cost partials come slab by slab
// (opt_vol_blocks(S * n, H, W) of them)
extern "C" int opt_vol_slab_linearize(const float* x, const float* ur,
                                      const float* cons, const float* params,
                                      const float* delta, float* jtf,
                                      float* diag, float* cost_partials,
                                      int S, int n, int he, int H, int W,
                                      int d0, int Dg, int mode,
                                      void* stream) {
  vol_linearize_kernel<<<vol_grid(S * n, H, W), dim3(kVX, kVY), 0,
                         (cudaStream_t)stream>>>(
      x, ur, cons, params, delta, jtf, diag, cost_partials, H, W,
      VolSlabs{S, n, he, d0, Dg}, mode);
  return (int)cudaGetLastError();
}
