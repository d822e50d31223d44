// The shared-memory 3-D apply core of K6 vol_hat_apply and K16
// vol_slab_apply (stream3d_kernels.cu): a = sq . J^T J (sq . v) for
// volumetric ARAP (vol_energy.cuh states the energy), each voxel's data
// read once per block, its sincosf taken once, each residual formed once.
//
// What bounded the gather form on this card.  The gather form, which K7
// and K8 keep (vol_energy.cuh vol_jtj_at, one thread a voxel), takes 21
// sincosf a voxel, forms each of the six residuals that touch a voxel
// twice and reads every neighbour's operand, angles and UrShape from
// device memory again: about 330 scalar loads a voxel.  K6 (GN, p_prev)
// took 260.5-262.1 us at 128^3 against its bytes' 92.7 us, but the same
// math with the neighbours' operand staged in shared memory took
// 298.2-300.5 (PERF.md, PR 9): the neighbour loads alone did not set its
// pace; the repeated trig and products and the exposed
// latency of a one-plane block did as much.
//
// The design.  A block of 32 (W) x kTileH (H) threads owns a tile of
// columns and marches along D through a chunk of kTileD own planes, one
// thread per column.  At each plane:
//   - the thread reads its voxel once, from a ring of two shared-memory
//     stages that cp.async fills a plane ahead (4-byte copies of its own
//     voxel's operand vectors, angles, UrShape and Constraints; threads
//     0 .. kTileHalo - 1 copy one halo voxel each, the W and H faces of
//     the tile without corners), and takes its sincosf once.  u = sq . v's
//     Offset part and UrShape go to shared memory, structure of arrays
//     over the tile with its halo;
//   - the D direction rides the march: the thread keeps the plane before
//     in registers and forms the pair r_{d-1,+D} and r_{d,-D} once, each
//     half into its voxel's sums.  Plane d-1 is then whole and is written;
//     the chunk reads one plane on each side for the pair that crosses
//     its faces;
//   - each voxel m forms its four in-plane residuals r_{m,o} once: the
//     centre half (w_reg jv on O(m), -w_reg G^T jv on A(m)) into its own
//     registers, and jv into a shared slot of the neighbour m + o, which
//     adds -w_reg jv.  A halo voxel forms only the residual that points
//     into the tile.
// Every voxel adds what it receives in a fixed order, and the block's dot
// partial comes from a fixed tree: repeated calls match bit for bit.
// InBounds is an explicit test on global planes (Vol::inside), never a zero
// fill: on an extended slab (K16) a halo plane past the global edge holds
// no voxel.  The tile is ragged at any W, H and D; two __syncthreads a
// plane, no atomics.
//
// Measured at 128^3 (PERF.md, PR 9): K6 (GN, p_prev) about 171 us, the
// plain apply 125, K16 on 4 slabs 123, 50-54% of their bytes' time, at
// 121-122 registers and two 256-thread blocks an SM; blocks of 32 x 4 and
// chunks of 8 or 32 planes measured within 5% of that.
// Two other forms measured slower and are not kept: the plane loaded into
// registers (no ring), and the tile's rows moved as 16-byte copies shared
// by the block, with each neighbour's operand formed again from the rows.

#pragma once

#include <cuda_pipeline.h>

#include "vol_energy.cuh"

namespace {

constexpr int kTileD = 16;  // own planes a block marches through
constexpr int kTileW = kVX;  // threads along W, the contiguous axis
constexpr int kTileH = 8;    // threads along H
constexpr int kTileThreads = kTileW * kTileH;
constexpr int kTileMinBlocks = 16 / kTileH;  // resident per SM: 16 warps
constexpr int kTX = kTileW + 2, kTY = kTileH + 2;  // the tile with its halo
constexpr int kTileHalo = 2 * kTileW + 2 * kTileH;  // halo voxels, no corners
static_assert(kTileHalo <= kTileThreads, "a halo voxel per thread at most");

// The nonzero entries of a voxel's three rotation derivatives dR/da_k as
// matrices, G[k] = M_k e (vol_energy.cuh drot): alpha's first column is
// zero, gamma's third row is zero and its other entries repeat alpha's.
struct DRot {
  float a01, a02, a11, a12, a21, a22;
  float b00, b01, b02, b10, b11, b12, b20, b21, b22;
  float g00, g10;
};

__device__ __forceinline__ DRot drot_of(const Trig& t) {
  DRot m;
  m.a01 = t.sg * t.sa + t.cg * t.sb * t.ca;
  m.a02 = t.sg * t.ca - t.cg * t.sb * t.sa;
  m.a11 = -t.cg * t.sa + t.sg * t.sb * t.ca;
  m.a12 = -t.cg * t.ca - t.sg * t.sb * t.sa;
  m.a21 = t.cb * t.ca;
  m.a22 = -t.cb * t.sa;
  m.b00 = -t.cg * t.sb;
  m.b01 = t.cg * t.cb * t.sa;
  m.b02 = t.cg * t.cb * t.ca;
  m.b10 = -t.sg * t.sb;
  m.b11 = t.sg * t.cb * t.sa;
  m.b12 = t.sg * t.cb * t.ca;
  m.b20 = -t.cb;
  m.b21 = -t.sb * t.sa;
  m.b22 = -t.sb * t.ca;
  m.g00 = -t.sg * t.cb;
  m.g10 = t.cg * t.cb;
  return m;
}

// g[k] = (dR/da_k) e, as vol_energy.cuh drot
__device__ __forceinline__ void drot_apply(const DRot& m, const float e[3],
                                           float g[3][3]) {
  g[0][0] = m.a01 * e[1] + m.a02 * e[2];
  g[0][1] = m.a11 * e[1] + m.a12 * e[2];
  g[0][2] = m.a21 * e[1] + m.a22 * e[2];
  g[1][0] = m.b00 * e[0] + m.b01 * e[1] + m.b02 * e[2];
  g[1][1] = m.b10 * e[0] + m.b11 * e[1] + m.b12 * e[2];
  g[1][2] = m.b20 * e[0] + m.b21 * e[1] + m.b22 * e[2];
  g[2][0] = m.g00 * e[0] + m.a12 * e[1] - m.a11 * e[2];
  g[2][1] = m.g10 * e[0] - m.a02 * e[1] + m.a01 * e[2];
  g[2][2] = 0.f;
}

// One arap residual centred at m (angles' derivatives dm, hat operand
// (cO, cA), UrShape cU) reading the neighbour n (nO, nU): its jv, and its
// centre half added to (aO, aA).  The neighbour's half is -w_reg jv on
// O(n), which the caller routes.
__device__ __forceinline__ void tile_residual(
    const DRot& dm, const float cO[3], const float cA[3], const float cU[3],
    const float nO[3], const float nU[3], float w_reg, float aO[3],
    float aA[3], float jv[3]) {
  const float e[3] = {cU[0] - nU[0], cU[1] - nU[1], cU[2] - nU[2]};
  float g[3][3];
  drot_apply(dm, e, g);
  arap_jv(w_reg, g, cO, nO, cA, jv);
  for (int c = 0; c < 3; ++c) aO[c] += w_reg * jv[c];
  for (int q = 0; q < 3; ++q)
    aA[q] -= w_reg * (g[q][0] * jv[0] + g[q][1] * jv[1] + g[q][2] * jv[2]);
}

// The halo voxel of thread rank t < kTileHalo: its (dh, dw) from the
// tile's corner (h0, w0) and the in-plane offset (vol_energy.cuh order)
// whose residual points into the tile.
__device__ __forceinline__ void tile_halo(int t, int* dh, int* dw, int* o) {
  if (t < kTileW) {
    *dh = -1, *dw = t, *o = 2;  // the row before: +H
  } else if (t < 2 * kTileW) {
    *dh = kTileH, *dw = t - kTileW, *o = 3;  // the row after: -H
  } else if (t < 2 * kTileW + kTileH) {
    *dh = t - 2 * kTileW, *dw = -1, *o = 0;  // the column before: +W
  } else {
    *dh = t - 2 * kTileW - kTileH, *dw = kTileW, *o = 1;  // after: -W
  }
}

// Fields a voxel's raw data takes in the ring: the Io's vectors (6 floats
// each), the angles, UrShape and (own voxels only) Constraints' first
// channel
template <class Io>
__host__ __device__ constexpr int tile_own_fields() {
  return 6 * Io::kVecs + 7;
}
template <class Io>
__host__ __device__ constexpr int tile_halo_fields() {
  return 6 * Io::kVecs + 6;
}

// Dynamic shared memory of a march: two ring stages of the own and the
// halo voxels' raw data, u's Offset part and UrShape over the tile with its
// halo, the exchange slots
template <class Io>
constexpr size_t vol_tile_smem() {
  return sizeof(float) *
         (2 * tile_own_fields<Io>() * kTileThreads +
          2 * tile_halo_fields<Io>() * kTileHalo + 6 * kTY * kTX +
          4 * 3 * kTileH * kTileW);
}

// a 4-byte async copy of src[i] into dst[f * stride] (cp.async)
__device__ __forceinline__ void tile_copy(float* dst, int f, int stride,
                                          const float* src, int i) {
  __pipeline_memcpy_async(dst + f * stride, src + i, sizeof(float));
}

// The march of one block over own planes [c0, c1) of the array g (planes
// c0 - 1 and c1 are read for the pair that crosses the chunk's faces).
// The Io gives the operand: io.fetch(k, dst, stride) starts the async
// copies of its kVecs vectors at array voxel k into dst[f * stride],
// io.operand(src, stride, v, s) forms the operand v and sq from them, and
// io.store(d, h, w, k, jtj, v, s) writes the voxel's output from jtj =
// J^T J (sq . v) and returns what it adds to the dot.  Returns this
// thread's share of the dot, summed in plane order.
//
// A plane's raw data arrive by cp.async in a ring of two stages: plane
// d + 1's copies start once plane d's first barrier has passed (every read
// of the stage they overwrite, plane d - 1's, is done), and run under
// plane d's in-plane residuals.  Each thread copies and reads only its own
// voxel's (and its halo voxel's) slots, so waiting for its own copies
// (__pipeline_wait_prior) is enough to read them.
template <class Io>
__device__ __forceinline__ float vol_tile_march(
    const Vol& g, int c0, int c1, const float* __restrict__ angle,
    const float* __restrict__ ur, const float* __restrict__ cons,
    float w_fit, float w_reg, const Io& io) {
  constexpr int kOwn = tile_own_fields<Io>(), kHalo = tile_halo_fields<Io>();
  constexpr int kVec = 6 * Io::kVecs;  // the first field of the angles
  extern __shared__ __align__(16) float tile_smem[];
  float* const own_ring = tile_smem;
  float* const halo_ring = own_ring + 2 * kOwn * kTileThreads;
  auto sO = reinterpret_cast<float(*)[kTY][kTX]>(halo_ring +
                                                 2 * kHalo * kTileHalo);
  auto sU = sO + 3;
  auto sR = reinterpret_cast<float(*)[3][kTileH][kTileW]>(sU + 3);
  const int tx = threadIdx.x, ty = threadIdx.y, t = vthread_rank();
  const int w0 = blockIdx.x * kTileW, h0 = blockIdx.y * kTileH;
  const int w = w0 + tx, h = h0 + ty;
  int hdh = 0, hdw = 0, ho = 0, odw = 0, odh = 0, odd = 0;
  if (t < kTileHalo) {
    tile_halo(t, &hdh, &hdw, &ho);
    offset(ho, &odw, &odh, &odd);
  }
  const int hh = h0 + hdh, hw = w0 + hdw;
  // this thread's slots in ring stage d & 1
  auto own_at = [&](int d) {
    return own_ring + (d & 1) * kOwn * kTileThreads + t;
  };
  auto halo_at = [&](int d) {
    return halo_ring + (d & 1) * kHalo * kTileHalo + t;
  };
  // start plane d's copies: the own voxel, and the halo voxel on an own
  // plane
  auto fetch = [&](int d) {
    if (g.inside(d, h, w)) {
      const int k = g.idx(d, h, w);
      float* dst = own_at(d);
      io.fetch(k, dst, kTileThreads);
      for (int c = 0; c < 3; ++c) {
        tile_copy(dst, kVec + c, kTileThreads, angle, 3 * k + c);
        tile_copy(dst, kVec + 3 + c, kTileThreads, ur, 3 * k + c);
      }
      tile_copy(dst, kVec + 6, kTileThreads, cons, 3 * k);
    }
    if (d >= c0 && d < c1 && t < kTileHalo && g.inside(d, hh, hw)) {
      const int k = g.idx(d, hh, hw);
      float* dst = halo_at(d);
      io.fetch(k, dst, kTileHalo);
      for (int c = 0; c < 3; ++c) {
        tile_copy(dst, kVec + c, kTileHalo, angle, 3 * k + c);
        tile_copy(dst, kVec + 3 + c, kTileHalo, ur, 3 * k + c);
      }
    }
    __pipeline_commit();
  };
  // a voxel's hat operand, UrShape and trig from its raw data
  auto voxel = [&](const float* src, int stride, float O[3], float A[3],
                   float U[3], Trig& tr) {
    float v[6], s[6];
    io.operand(src, stride, v, s);
    float a[3];
    for (int c = 0; c < 3; ++c) {
      O[c] = s[c] * v[c];
      A[c] = s[3 + c] * v[3 + c];
      a[c] = src[(kVec + c) * stride];
      U[c] = src[(kVec + 3 + c) * stride];
    }
    tr = trig(a);
  };

  float dot = 0.f;
  // the plane before: hat operand, UrShape, trig, sums, its fit test
  float pO[3] = {}, pA[3] = {}, pU[3] = {}, pacc[6] = {};
  Trig pt = {};
  bool pin = false, pfit = false;
  fetch(c0 - 1);
  for (int d = c0 - 1; d <= c1; ++d) {
    const bool own = d >= c0 && d < c1;
    const bool cin = g.inside(d, h, w);
    __pipeline_wait_prior(0);
    float cO[3] = {}, cA[3] = {}, cU[3] = {}, cacc[6] = {};
    Trig ct = {};
    bool cfit = false;
    if (cin) {
      voxel(own_at(d), kTileThreads, cO, cA, cU, ct);
      cfit = own && own_at(d)[(kVec + 6) * kTileThreads] >= kFitValid;
    }
    // a face plane before the chunk: plane c0 - 1's stage holds nothing
    // that is still to be read
    if (d < c0) fetch(d + 1);
    if (pin && cin) {
      // the D pair: r_{d-1,+D}, then r_{d,-D}
      float jv[3];
      tile_residual(drot_of(pt), pO, pA, pU, cO, cU, w_reg, pacc, pacc + 3,
                    jv);
      for (int c = 0; c < 3; ++c) cacc[c] -= w_reg * jv[c];
      tile_residual(drot_of(ct), cO, cA, cU, pO, pU, w_reg, cacc, cacc + 3,
                    jv);
      for (int c = 0; c < 3; ++c) pacc[c] -= w_reg * jv[c];
    }
    if (pin && d - 1 >= c0) {
      // the plane before is whole: its fit term, then its output
      if (pfit)
        for (int c = 0; c < 3; ++c) pacc[c] += w_fit * (w_fit * pO[c]);
      float v[6], s[6];
      io.operand(own_at(d - 1), kTileThreads, v, s);
      dot += io.store(d - 1, h, w, g.idx(d - 1, h, w), pacc, v, s);
    }
    if (own) {
      // the in-plane residuals: stage u's Offset and UrShape, own and halo
      if (cin)
        for (int c = 0; c < 3; ++c) {
          sO[c][ty + 1][tx + 1] = cO[c];
          sU[c][ty + 1][tx + 1] = cU[c];
        }
      const bool hin = t < kTileHalo && g.inside(d, hh, hw);
      float hO[3], hA[3], hU[3];
      Trig htr;
      if (hin) {
        voxel(halo_at(d), kTileHalo, hO, hA, hU, htr);
        for (int c = 0; c < 3; ++c) {
          sO[c][hdh + 1][hdw + 1] = hO[c];
          sU[c][hdh + 1][hdw + 1] = hU[c];
        }
      }
      __syncthreads();
      fetch(d + 1);
      if (cin) {
        const DRot cm = drot_of(ct);  // again: not held across the pair
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          int dw, dh, dd;
          offset(o, &dw, &dh, &dd);
          if (!g.inside(d, h + dh, w + dw)) continue;
          const int sy = ty + 1 + dh, sx = tx + 1 + dw;
          const float nO[3] = {sO[0][sy][sx], sO[1][sy][sx], sO[2][sy][sx]};
          const float nU[3] = {sU[0][sy][sx], sU[1][sy][sx], sU[2][sy][sx]};
          float jv[3];
          tile_residual(cm, cO, cA, cU, nO, nU, w_reg, cacc, cacc + 3, jv);
          const int ry = ty + dh, rx = tx + dw;
          if (ry >= 0 && ry < kTileH && rx >= 0 && rx < kTileW)
            for (int c = 0; c < 3; ++c) sR[o][c][ry][rx] = jv[c];
        }
      }
      if (hin && g.inside(d, hh + odh, hw + odw)) {
        // the halo voxel's residual into the tile
        const int sy = hdh + 1 + odh, sx = hdw + 1 + odw;
        const float nO[3] = {sO[0][sy][sx], sO[1][sy][sx], sO[2][sy][sx]};
        const float nU[3] = {sU[0][sy][sx], sU[1][sy][sx], sU[2][sy][sx]};
        float aO[3] = {}, aA[3] = {}, jv[3];
        tile_residual(drot_of(htr), hO, hA, hU, nO, nU, w_reg, aO, aA, jv);
        for (int c = 0; c < 3; ++c) sR[ho][c][hdh + odh][hdw + odw] = jv[c];
      }
      __syncthreads();
      if (cin) {
        // the neighbours' halves, in offset order
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          int dw, dh, dd;
          offset(o, &dw, &dh, &dd);
          if (!g.inside(d, h - dh, w - dw)) continue;
          for (int c = 0; c < 3; ++c) cacc[c] -= w_reg * sR[o][c][ty][tx];
        }
      }
    }
    for (int c = 0; c < 3; ++c) {
      pO[c] = cO[c];
      pA[c] = cA[c];
      pU[c] = cU[c];
      pacc[c] = cacc[c];
      pacc[3 + c] = cacc[3 + c];
    }
    pt = ct;
    pin = cin;
    pfit = cfit;
  }
  return dot;
}

// A march kernel's dynamic shared memory, over the 48 KB a launch gets
// unasked
template <class Kernel>
cudaError_t vol_tile_prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The grid of a march over S slabs of n own planes each: (W, H) tiles, and
// blockIdx.z = slab * chunks + chunk of kTileD planes.  The z extent holds
// at most 65,535, so a volume deeper than that many chunks fails to launch
// (and its wrapper raises).
dim3 vol_tile_grid(int S, int n, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
              S * ((n + kTileD - 1) / kTileD));
}

}  // namespace
