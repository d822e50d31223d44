// The volumetric ARAP energy (opt_tpu_torch/energies.py:
// volumetric_mesh_deformation) in closed form: the rotation, its
// derivatives and the J^T J apply at one voxel, shared by K8
// (vol_kernels.cu) and by K6 and K7 (stream3d_kernels.cu).
//
// The energy, for voxel v and stencil offset o in the energy's order
// (+W, -W, +H, -H, +D, -D), n = v + o:
//   fit  f_v     = w_fit * (O(v) - C(v))        where C(v)[0] >= -999999.9
//   arap r_{v,o} = w_reg * ((O(v) - O(n)) - R(A(v)) (U(v) - U(n)))
//                                                where InBounds(n)
// with O the Offset and A the Angle (3 channels each, the unknowns), U the
// UrShape, C the Constraints (unconstrained voxels hold -inf), and R(a)
// the reference's Rotate3D in the angles (alpha, beta, gamma) = a[0..2]
// (dsl/env.py Rotate3D).  J of r_{v,o} is w_reg I on O(v), -w_reg I on
// O(n) and -w_reg dR/da_k e on A_k(v), e = U(v) - U(n).  There is no
// exclusion mask: every voxel's unknowns are kept.
//
// Gather form: voxel v sums its own seven residual groups and the six
// neighbours' arap residuals whose offset points at v; those need each
// neighbour's rotation derivatives, so the halo is one voxel and no thread
// writes another thread's output.
//
// Layout: the flat unknown vector holds Offset as (D, H, W, 3) then Angle
// as (D, H, W, 3) (solver/core.Layout); UrShape and Constraints are
// (D, H, W, 3); params = {w_fitSqrt, w_regSqrt} on the device.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kVX = 32;  // threads along W, the contiguous axis
constexpr int kVY = 8;   // threads along H; D is the grid's z
constexpr int kVThreads = kVX * kVY;
constexpr float kFitValid = -999999.9f;

__device__ __forceinline__ int vthread_rank() {
  return threadIdx.y * kVX + threadIdx.x;
}

__device__ __forceinline__ int vblock_rank() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

// Sum over the block's threads by a fixed shared-memory tree (the same
// order on every run: no float atomics); every thread gets the sum.
__device__ __forceinline__ float vblock_sum(float v, float* sh) {
  const int t = vthread_rank();
  sh[t] = v;
  __syncthreads();
  for (int s = kVThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// stencil offset t in the energy's order, as (dw, dh, dd)
__device__ __forceinline__ void offset(int t, int* dw, int* dh, int* dd) {
  *dw = t == 0 ? 1 : (t == 1 ? -1 : 0);
  *dh = t == 2 ? 1 : (t == 3 ? -1 : 0);
  *dd = t == 4 ? 1 : (t == 5 ? -1 : 0);
}

// The D x H x W array a kernel indexes and where it lies in the global
// volume: d0 is the global plane of the array's plane 0, Dg the global
// depth.  inside() is both the array bound and the energy's InBounds,
// which tests global planes: on an extended D slab of a sharded volume
// (K8's offset mode, K16) a zero-filled halo plane past the global edge is
// outside, not a neighbour that holds 0.  A whole volume (Vol{D, H, W}:
// K6, K7) keeps d0 = 0 and an unbounded Dg.
struct Vol {
  int D, H, W;
  int d0 = 0;
  int Dg = INT_MAX;
  __device__ bool inside(int d, int h, int w) const {
    return d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W &&
           d0 + d >= 0 && d0 + d < Dg;
  }
  __device__ int idx(int d, int h, int w) const {
    return (d * H + h) * W + w;
  }
  __device__ int n() const { return D * H * W; }
};

// sines and cosines of a voxel's three angles (full-precision sincosf)
struct Trig {
  float sa, ca, sb, cb, sg, cg;
};

__device__ __forceinline__ Trig trig(const float* a) {
  Trig t;
  sincosf(a[0], &t.sa, &t.ca);
  sincosf(a[1], &t.sb, &t.cb);
  sincosf(a[2], &t.sg, &t.cg);
  return t;
}

// R(a) e
__device__ __forceinline__ void rot(const Trig& t, const float e[3],
                                    float o[3]) {
  o[0] = t.cg * t.cb * e[0] + (-t.sg * t.ca + t.cg * t.sb * t.sa) * e[1] +
         (t.sg * t.sa + t.cg * t.sb * t.ca) * e[2];
  o[1] = t.sg * t.cb * e[0] + (t.cg * t.ca + t.sg * t.sb * t.sa) * e[1] +
         (-t.cg * t.sa + t.sg * t.sb * t.ca) * e[2];
  o[2] = -t.sb * e[0] + t.cb * t.sa * e[1] + t.cb * t.ca * e[2];
}

// g[k] = (dR/da_k) e for k = alpha, beta, gamma
__device__ __forceinline__ void drot(const Trig& t, const float e[3],
                                     float g[3][3]) {
  g[0][0] = (t.sg * t.sa + t.cg * t.sb * t.ca) * e[1] +
            (t.sg * t.ca - t.cg * t.sb * t.sa) * e[2];
  g[0][1] = (-t.cg * t.sa + t.sg * t.sb * t.ca) * e[1] +
            (-t.cg * t.ca - t.sg * t.sb * t.sa) * e[2];
  g[0][2] = t.cb * t.ca * e[1] - t.cb * t.sa * e[2];
  g[1][0] = -t.cg * t.sb * e[0] + t.cg * t.cb * t.sa * e[1] +
            t.cg * t.cb * t.ca * e[2];
  g[1][1] = -t.sg * t.sb * e[0] + t.sg * t.cb * t.sa * e[1] +
            t.sg * t.cb * t.ca * e[2];
  g[1][2] = -t.cb * e[0] - t.sb * t.sa * e[1] - t.sb * t.ca * e[2];
  g[2][0] = -t.sg * t.cb * e[0] + (-t.cg * t.ca - t.sg * t.sb * t.sa) * e[1] +
            (t.cg * t.sa - t.sg * t.sb * t.ca) * e[2];
  g[2][1] = t.cg * t.cb * e[0] + (-t.sg * t.ca + t.cg * t.sb * t.sa) * e[1] +
            (t.sg * t.sa + t.cg * t.sb * t.ca) * e[2];
  g[2][2] = 0.f;
}

// e = U(a) - U(b)
__device__ __forceinline__ void ur_diff(const float* __restrict__ ur, int a,
                                        int b, float e[3]) {
  for (int c = 0; c < 3; ++c) e[c] = ur[3 * a + c] - ur[3 * b + c];
}

// J of one arap residual applied to v: w_reg (vO(v) - vO(n)) - w_reg
// sum_k g[k] vA_k(v)
__device__ __forceinline__ void arap_jv(float w_reg, const float g[3][3],
                                        const float vO[3], const float nO[3],
                                        const float vA[3], float jv[3]) {
  for (int c = 0; c < 3; ++c)
    jv[c] = w_reg * ((vO[c] - nO[c]) -
                     (g[0][c] * vA[0] + g[1][c] * vA[1] + g[2][c] * vA[2]));
}

// (J^T J v)(k) at voxel (d, h, w), given v(k) = (vO, vA) and a reader for
// v at the neighbours: read(n, vO, vA), which forms the operand on the fly
// (stream3d_kernels.cu's VolHatRead).
template <class Read>
__device__ __forceinline__ void vol_jtj_at(
    const Vol& g, int d, int h, int w, const float* __restrict__ angle,
    const float* __restrict__ ur, const float* __restrict__ cons,
    float w_fit, float w_reg, const float vO[3], const float vA[3],
    const Read& read, float aO[3], float aA[3]) {
  const int k = g.idx(d, h, w);
  const Trig tk = trig(angle + 3 * k);
  for (int c = 0; c < 3; ++c) aO[c] = aA[c] = 0.f;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    int dw, dh, dd;
    offset(t, &dw, &dh, &dd);
    float e[3], G[3][3], jv[3], nO[3], nA[3];
    // residual centred at k, reading n = k + o
    if (g.inside(d + dd, h + dh, w + dw)) {
      const int n = g.idx(d + dd, h + dh, w + dw);
      read(n, nO, nA);
      ur_diff(ur, k, n, e);
      drot(tk, e, G);
      arap_jv(w_reg, G, vO, nO, vA, jv);
      for (int c = 0; c < 3; ++c) aO[c] += w_reg * jv[c];
      for (int q = 0; q < 3; ++q)
        aA[q] -= w_reg * (G[q][0] * jv[0] + G[q][1] * jv[1] + G[q][2] * jv[2]);
    }
    // residual centred at m = k - o, reading k
    if (g.inside(d - dd, h - dh, w - dw)) {
      const int m = g.idx(d - dd, h - dh, w - dw);
      read(m, nO, nA);
      ur_diff(ur, m, k, e);
      drot(trig(angle + 3 * m), e, G);
      arap_jv(w_reg, G, nO, vO, nA, jv);
      for (int c = 0; c < 3; ++c) aO[c] -= w_reg * jv[c];
    }
  }
  if (cons[3 * k] >= kFitValid)
    for (int c = 0; c < 3; ++c) aO[c] += w_fit * (w_fit * vO[c]);
}

// The planes of a launch over a batch of extended D slabs: S slabs of n
// own planes with he halo planes before and after, slab s's array plane 0
// at global plane d0 + s * n, in a volume of Dg planes.  blockIdx.z runs
// over the S * n own planes, slab by slab.  Each slab's arrays are the
// flat layout of an (n + 2 he) x H x W volume, one slab after another;
// outputs cover the own planes only, in the local layout (Offset
// (S, n, H, W, 3) then Angle (S, n, H, W, 3)).  A whole volume is
// VolSlabs{1, D, 0, 0, D}.
struct VolSlabs {
  int S, n, he, d0, Dg;
  __device__ int planes() const { return n + 2 * he; }
  __device__ Vol vol(int s, int H, int W) const {
    return Vol{planes(), H, W, d0 + s * n, Dg};
  }
};

// D rides the grid's z extent, so a volume holds at most 65,535 planes; a
// deeper one fails to launch (and its wrapper raises)
dim3 vol_grid(int D, int H, int W) {
  return dim3((W + kVX - 1) / kVX, (H + kVY - 1) / kVY, D);
}

}  // namespace
