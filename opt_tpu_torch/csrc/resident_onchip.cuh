// K13 resident_pcg's on-chip form for image_warping
// (resident_kernels.cu opt_resident_warp_onchip): the whole hat-space PCG
// state of the launch stays on chip, one tile a streaming multiprocessor,
// for all lIterations.
//
// Why.  The L2 form (resident_kernels.cu WarpLoop on resident_pcg.cuh)
// keeps r, p, A_hat p and delta in device memory: each iteration moves
// about 40 MB through L2 at 512^2, marches its rows through L2 loads and
// syncs 640 blocks twice; it took 17.3 us an iteration against a bound of
// 0.77 (PERF.md).  The TPU kernel it replaces keeps the vectors in VMEM
// (opt_tpu/ops/stream_solver.py:424-550); here a grid whose tiles number no
// more than the card's SMs keeps them in each SM's shared memory and
// registers, so that only the tiles' edges and one partial a block cross
// L2 an iteration.
//
// Grid and residency.  One cooperative launch (every block resident at
// once, which the barrier below needs) of one block of kThreads threads a
// tile of kTileH x kTileW pixels (__launch_bounds__(kThreads, 1) and
// kSmemBytes of dynamic shared memory: one block an SM).  The form runs
// where the tiles number no more than the SMs and kSmemBytes fits what a
// block may take (ops/stream_cuda.py onchip_tiles; 512^2: 128 tiles of
// 32 x 64 on 132 SMs); past that the L2 form runs.  A warp holds 32
// columns of a band of kRows rows, a thread one column of the band: its
// own pixels.
//   shared memory, over the tile and its one-pixel ring:
//     sv  the operand v = sq p and the keep flag (inside the grid, Mask 0),
//         v rewritten each iteration;
//     sg  UrShape and the sin and cos of the Angle, each angle's sincosf
//         taken once before the loop (the same float the L2 form takes at
//         every apply);
//     ss  sq and the fit flag (both Constraints channels >= 0);
//   registers, at the thread's own pixels: r, p, A_hat p and delta;
//   device memory, through L2: the tile's edge pixels of r (phase 2) and
//   of p (phase 1, into the buffer of the iteration's parity), from which
//   the neighbouring tiles form their ring's v, and two 8-byte slots a
//   block, one for each dot's partial.
//
// The loop is resident_pcg.cuh's classic one in its phase order: phase 1
// forms p = r + beta p_prev by one __fmaf_rn (at the own pixels, and at
// the ring from the neighbours' edge r and p_prev: the same float its
// owner forms), takes the deferred step delta += alpha p_prev, writes
// v = sq p, then A_hat p and <p, A_hat p>; barrier; phase 2 takes alpha,
// r -= alpha A_hat p and <r, r>; barrier; beta.  The last step
// delta += alpha p follows the loop.  The guards (alpha = 0 where
// <p, A_hat p> = 0, beta = 0 where an = 0), the fixed trip count and the
// fixed-tree partials hold, with no float atomics.
//
// The barrier is the dot's own (grid_sum): a block stores its partial
// with the barrier's tag into its slot, one 64-bit word (released after
// <r, r>, whose barrier hands on the edges); warp 0 of every block loads
// all slots at once until each holds the tag and sums the partials in one
// fixed order, so every block holds the same alpha and beta, and repeated
// launches match bit for bit; each ring thread meanwhile acquires its
// neighbour's <r, r> slot and reads that block's edge r and p_prev.  The
// launch zeroes the slots first; the tags (1, then 2 it + 2 and 2 it + 3)
// grow, and a block can run at most one barrier ahead, into the other
// dot's slots.  Measured on an H100 at 512^2 (PERF.md): cooperative
// groups' grid.sync() over the 128 blocks and the partials read back
// after it took 2.8-2.9 us a phase; the slots take 1.5 us for <p, A_hat p>
// and 2.3 us for <r, r> with the ring's reads, of 7.0 us an iteration
// (the apply 2.1).  Tried and dropped: 8 rows a thread and 256 threads (a
// slower apply, 11% slower in all), the edges' p stored after the apply,
// a second round of slot loads in flight (both within 2%), and the edges
// as tagged 8-byte words that the ring polls in place of the neighbour's
// slot (4-6% slower in the same call: the edge stores cost more than the
// wait they save).  ptxas
// (CUDA 12.8, sm_90a): 128 registers, no stack frame, no spills.
//
// The apply (J^T J v, warp_energy.cuh states the energy) walks the
// thread's column down its band: each H pair of residuals (the one
// centred above reading below, and back) once, in registers, with the
// rows above and below the band from shared memory; each W residual that
// touches an own pixel from the neighbour's sv and sg (the residual
// centred at the own pixel, and the one centred at the neighbour, whose
// half is the own pixel's).  Each pixel adds in a fixed order (the H pair
// above, its W pairs right then left, the H pair below, the fit term).

#pragma once

#include <cuda_runtime.h>

#include "warp_energy.cuh"

namespace {
namespace onchip {

constexpr int kRows = 4;                   // own rows a thread
constexpr int kBands = 8;                  // bands of kRows rows a tile
constexpr int kTileW = 64;                 // two warps side by side
constexpr int kTileH = kRows * kBands;     // 32
constexpr int kThreads = 2 * 32 * kBands;  // 512
constexpr int kWarps = kThreads / 32;
constexpr int kExtW = kTileW + 2;
constexpr int kExt = (kTileH + 2) * kExtW;  // the tile and its ring
constexpr int kRing = 2 * (kTileW + kTileH);  // the ring but its corners
constexpr int kMaxBlocks = 256;  // the partials warp 0 reads at once
// sv, sg and ss over the tile and its ring, and kWarps + 1 floats of
// scratch (rounded to float4s): 107,792 bytes
constexpr size_t kSmemBytes =
    sizeof(float4) * (3 * kExt + (kWarps + 4) / 4);
static_assert(kRing <= kThreads - 32, "a thread past warp 0 a ring pixel");

// The tiles of an H x W grid, row-major, kTileW columns a tile row
__host__ __device__ inline int tiles_w(int W) {
  return (W + kTileW - 1) / kTileW;
}
inline int tiles(int H, int W) {
  return ((H + kTileH - 1) / kTileH) * tiles_w(W);
}

struct Params {
  const float* __restrict__ x;  // flat: Offset (H, W, 2), then Angle
  const float* __restrict__ ur;
  const float* __restrict__ cons;
  const float* __restrict__ mask;
  const float* __restrict__ params;  // w_fit, w_reg
  const float* __restrict__ sq;
  const float* __restrict__ b;  // b_hat, r0
  float* delta;                 // out: d_hat
  float* r;                     // the tiles' edge r
  float* p[2];                  // the tiles' edge p, by iteration parity
  // two slots a block, zeroed before the launch: <p, Ap>'s, then <r, r>'s
  unsigned long long* slots;
  int H, W;
};

// v[0 .. 2] at flat pixel k (Offset pair, then the Angle's)
__device__ __forceinline__ void ld3_cg(const float* a, int k, int HW,
                                       float (&v)[3]) {
  v[0] = __ldcg(a + 2 * k);
  v[1] = __ldcg(a + 2 * k + 1);
  v[2] = __ldcg(a + 2 * HW + k);
}

__device__ __forceinline__ void st3(float* a, int k, int HW,
                                    const float (&v)[3]) {
  a[2 * k] = v[0];
  a[2 * k + 1] = v[1];
  a[2 * HW + k] = v[2];
}

// A pixel as the apply reads it
struct Px {
  float v0, v1, vA;  // the operand
  float u0, u1;      // UrShape
  float sn, cs;      // sin and cos of the Angle (0 where not kept)
  bool keep;         // inside the grid, Mask 0
};

__device__ __forceinline__ Px px_at(const float4* sv, const float4* sg,
                                    int e) {
  const float4 a = sv[e], g = sg[e];
  return Px{a.x, a.y, a.z, g.x, g.y, g.z, g.w, a.w != 0.f};
}

// jp of the reg residual centred at c reading n:
// w_reg ((v_c - v_n) - G v_c^A), G = R'(a_c) (U_c - U_n)
__device__ __forceinline__ void reg_jp(const Px& c, const Px& n, float w_reg,
                                       float* g0, float* g1, float* jp0,
                                       float* jp1) {
  drot(c.sn, c.cs, c.u0 - n.u0, c.u1 - n.u1, g0, g1);
  *jp0 = w_reg * ((c.v0 - n.v0) - *g0 * c.vA);
  *jp1 = w_reg * ((c.v1 - n.v1) - *g1 * c.vA);
}

// The residual centred at c reading n: its centre half into c's sums a;
// returns jp, whose half -w_reg jp is n's
__device__ __forceinline__ void reg_centre(const Px& c, const Px& n,
                                           float w_reg, float (&a)[3],
                                           float* jp0, float* jp1) {
  float g0, g1;
  reg_jp(c, n, w_reg, &g0, &g1, jp0, jp1);
  a[0] += w_reg * *jp0;
  a[1] += w_reg * *jp1;
  a[2] += -w_reg * g0 * *jp0 + -w_reg * g1 * *jp1;
}

// The two reg residuals of the W pair (c, n) at c's sums: the one centred
// at c, then the neighbour's half of the one centred at n
__device__ __forceinline__ void w_pair(const Px& c, const Px& n, float w_reg,
                                       float (&a)[3]) {
  if (!(c.keep && n.keep)) return;
  float g0, g1, jp0, jp1;
  reg_centre(c, n, w_reg, a, &jp0, &jp1);
  reg_jp(n, c, w_reg, &g0, &g1, &jp0, &jp1);
  a[0] -= w_reg * jp0;
  a[1] -= w_reg * jp1;
}

// A slot of the barrier: the tag of the barrier (high 32 bits) and a
// block's partial (low 32 bits), stored and loaded as one 64-bit word
__device__ __forceinline__ unsigned long long slot_word(unsigned tag,
                                                        float v) {
  return ((unsigned long long)tag << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void st_slot(unsigned long long* slot,
                                        unsigned long long w, bool release) {
  if (release)
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(slot), "l"(w)
                 : "memory");
  else
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(slot), "l"(w)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_slot(
    const unsigned long long* slot) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(slot));
  return w;
}

__device__ __forceinline__ unsigned long long ld_slot_acquire(
    const unsigned long long* slot) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(slot)
               : "memory");
  return w;
}

// Spins until `slot` holds `tag`; acquires what its block wrote before it
__device__ __forceinline__ void acquire_slot(const unsigned long long* slot,
                                             unsigned tag) {
  while ((unsigned)(ld_slot_acquire(slot) >> 32) != tag) {
  }
}

// The grid's sum of every thread's v, and the barrier between the phases.
// The block's partial (a shuffle tree a warp, then the warps in order) goes
// to its slot with the tag, released where `release` (what the block wrote
// before it, the edges, is then the neighbours'); warp 0 polls every
// block's slot at once until all hold the tag and sums their partials in
// one fixed order, the same in every block; meanwhile the other warps run
// during(), the ring's reads.  Every thread gets the sum.
template <class During>
__device__ __forceinline__ float grid_sum(float v, unsigned long long* slots,
                                          unsigned tag, bool release,
                                          float* red, During during) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    st_slot(slots + blockIdx.x, slot_word(tag, s), release);
  }
  if (warp == 0) {
    // lane l holds blocks l, l + 32, ... (kMaxBlocks at most): their loads
    // in flight together, then the check; a missing block reads as 0
    unsigned long long w[kMaxBlocks / 32];
    bool ready;
    do {
#pragma unroll
      for (int u = 0; u < kMaxBlocks / 32; ++u) {
        const int b = lane + 32 * u;
        w[u] = b < (int)gridDim.x ? ld_slot(slots + b)
                                  : slot_word(tag, 0.f);
      }
      ready = true;
#pragma unroll
      for (int u = 0; u < kMaxBlocks / 32; ++u)
        ready = ready && (unsigned)(w[u] >> 32) == tag;
    } while (!__all_sync(0xffffffffu, ready));
    float tot = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxBlocks / 32; ++u)
      tot += __uint_as_float((unsigned)w[u]);
    // each butterfly step adds the same two floats in every lane
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) red[kWarps] = tot;
  } else {
    during();
  }
  __syncthreads();
  return red[kWarps];
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b != 0.f ? a / b : 0.f;
}

__global__ void __launch_bounds__(kThreads, 1)
warp_pcg_kernel(Params q, int n_iters) {
  extern __shared__ float4 smem[];
  float4* sv = smem;
  float4* sg = sv + kExt;
  float4* ss = sg + kExt;
  float* red = reinterpret_cast<float*>(ss + kExt);
  const int t = threadIdx.x, warp = t >> 5;
  const int band = warp >> 1, tj = (warp & 1) * 32 + (t & 31);
  const int tx = tiles_w(q.W);
  const int i0 = (blockIdx.x / tx) * kTileH, j0 = (blockIdx.x % tx) * kTileW;
  const int H = q.H, W = q.W, HW = H * W;
  unsigned long long* pap_slots = q.slots;
  unsigned long long* rr_slots = q.slots + gridDim.x;
  const float w_fit = q.params[0], w_reg = q.params[1];

  // the tile's and its ring's constants, once
  for (int e = t; e < kExt; e += kThreads) {
    const int i = i0 + e / kExtW - 1, j = j0 + e % kExtW - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), g = v, s = v;
    if (i >= 0 && i < H && j >= 0 && j < W) {
      const int k = i * W + j;
      const bool keep = __ldg(q.mask + k) == 0.f;
      float sn = 0.f, cs = 0.f;
      if (keep) sincosf(__ldg(q.x + 2 * HW + k), &sn, &cs);
      g = make_float4(__ldg(q.ur + 2 * k), __ldg(q.ur + 2 * k + 1), sn, cs);
      const bool fit =
          __ldg(q.cons + 2 * k) >= 0.f && __ldg(q.cons + 2 * k + 1) >= 0.f;
      s = make_float4(__ldg(q.sq + 2 * k), __ldg(q.sq + 2 * k + 1),
                      __ldg(q.sq + 2 * HW + k), fit ? 1.f : 0.f);
      v.w = keep ? 1.f : 0.f;
    }
    sv[e] = v;
    sg[e] = g;
    ss[e] = s;
  }

  // this thread's ring pixel, for a thread past warp 0 (one side of the
  // ring, its corners left out): rk its flat index where it is inside the
  // grid and kept, else -1; nb the block whose edge it is
  int rk = -1, re = 0, nb = 0;
  if (t >= 32 && t < 32 + kRing) {
    const int u = t - 32;
    int ti, tc;
    if (u < kTileW) {
      ti = -1, tc = u, nb = blockIdx.x - tx;
    } else if (u < 2 * kTileW) {
      ti = kTileH, tc = u - kTileW, nb = blockIdx.x + tx;
    } else if (u < 2 * kTileW + kTileH) {
      ti = u - 2 * kTileW, tc = -1, nb = blockIdx.x - 1;
    } else {
      ti = u - 2 * kTileW - kTileH, tc = kTileW, nb = blockIdx.x + 1;
    }
    const int i = i0 + ti, j = j0 + tc;
    re = (ti + 1) * kExtW + tc + 1;
    if (i >= 0 && i < H && j >= 0 && j < W && __ldg(q.mask + i * W + j) == 0.f)
      rk = i * W + j;
  }
  // the ring's r and p_prev, read once its block has published them (its
  // <r, r> slot holds the tag), while warp 0 waits on the grid
  float fr[3] = {0.f, 0.f, 0.f}, fp[3] = {0.f, 0.f, 0.f};
  auto ring_reads = [&](unsigned tag, const float* pprev) {
    if (rk < 0) return;
    acquire_slot(rr_slots + nb, tag);
    ld3_cg(q.r, rk, HW, fr);
    ld3_cg(pprev, rk, HW, fp);
  };

  // the own pixels: r = b_hat, p_prev = 0, delta = 0; the edges published
  const int j = j0 + tj;
  const int e0 = (band * kRows + 1) * kExtW + tj + 1;  // the band's first
  float r[kRows][3], p[kRows][3], ap[kRows][3], dl[kRows][3];
  unsigned keep = 0;  // bit s: own pixel s kept
  __syncthreads();  // sv's keep flags
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int ti = band * kRows + s, i = i0 + ti, k = i * W + j;
    const bool in = i < H && j < W;
    const bool edge = ti == 0 || ti == kTileH - 1 || tj == 0 ||
                      tj == kTileW - 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int at = c < 2 ? 2 * k + c : 2 * HW + k;
      r[s][c] = in ? __ldg(q.b + at) : 0.f;
      p[s][c] = ap[s][c] = dl[s][c] = 0.f;
      acc += r[s][c] * r[s][c];
    }
    if (sv[e0 + s * kExtW].w != 0.f) keep |= 1u << s;
    if (in && edge) {
      const float zero[3] = {0.f, 0.f, 0.f};
      st3(q.r, k, HW, r[s]);
      st3(q.p[1], k, HW, zero);  // p_prev at iteration 0
    }
  }
  // the barriers' tags: <r, r> before the loop 1, then 2 it + 2 and
  // 2 it + 3; <p, A_hat p>'s slots carry no release (nothing is read
  // through them but the partial), <r, r>'s release the edges
  float an = grid_sum(acc, rr_slots, 1u, true, red,
                      [&] { ring_reads(1u, q.p[1]); });
  float alpha = 0.f, beta = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    // phase 1: the last step of delta, p, v; the ring's v from the
    // neighbours' edges
    float* pn = (it & 1) ? q.p[1] : q.p[0];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int ti = band * kRows + s, i = i0 + ti, k = i * W + j;
      const int e = e0 + s * kExtW;
      const float4 sqf = ss[e];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dl[s][c] += alpha * p[s][c];
        p[s][c] = __fmaf_rn(beta, p[s][c], r[s][c]);
      }
      sv[e] = make_float4(sqf.x * p[s][0], sqf.y * p[s][1], sqf.z * p[s][2],
                          (keep >> s) & 1u ? 1.f : 0.f);
      if ((ti == 0 || ti == kTileH - 1 || tj == 0 || tj == kTileW - 1) &&
          i < H && j < W)
        st3(pn, k, HW, p[s]);
    }
    if (rk >= 0) {
      const float4 sqf = ss[re];
      sv[re] = make_float4(sqf.x * __fmaf_rn(beta, fp[0], fr[0]),
                           sqf.y * __fmaf_rn(beta, fp[1], fr[1]),
                           sqf.z * __fmaf_rn(beta, fp[2], fr[2]), 1.f);
    }
    __syncthreads();

    // A_hat p = sq J^T J v at the own pixels (0 where not kept), and
    // <p, A_hat p>
    float dot = 0.f;
    {
      Px prev = px_at(sv, sg, e0 - kExtW);
      float pa[3] = {0.f, 0.f, 0.f};  // prev's sums
#pragma unroll
      for (int s = 0; s <= kRows; ++s) {
        const int e = e0 + s * kExtW;
        const Px cur = px_at(sv, sg, e);
        float ca[3] = {0.f, 0.f, 0.f};
        if (prev.keep && cur.keep) {  // the H pair
          float jp0, jp1;
          reg_centre(prev, cur, w_reg, pa, &jp0, &jp1);
          ca[0] -= w_reg * jp0;
          ca[1] -= w_reg * jp1;
          reg_centre(cur, prev, w_reg, ca, &jp0, &jp1);
          pa[0] -= w_reg * jp0;
          pa[1] -= w_reg * jp1;
        }
        if (s >= 1) {  // the row before is whole: its fit term, A_hat p
          const int o = s - 1;
          const float4 sqf = ss[e - kExtW];
          float a0 = 0.f, a1 = 0.f, aA = 0.f;
          if (prev.keep) {
            if (sqf.w != 0.f) {
              pa[0] += w_fit * (w_fit * prev.v0);
              pa[1] += w_fit * (w_fit * prev.v1);
            }
            a0 = sqf.x * pa[0], a1 = sqf.y * pa[1], aA = sqf.z * pa[2];
          }
          ap[o][0] = a0, ap[o][1] = a1, ap[o][2] = aA;
          dot += p[o][0] * a0 + p[o][1] * a1 + p[o][2] * aA;
        }
        if (s < kRows) {  // an own row: its W pairs
          w_pair(cur, px_at(sv, sg, e + 1), w_reg, ca);
          w_pair(cur, px_at(sv, sg, e - 1), w_reg, ca);
        }
        prev = cur;
        pa[0] = ca[0], pa[1] = ca[1], pa[2] = ca[2];
      }
    }
    const unsigned tag = 2u * it + 2u;
    const float pap = grid_sum(dot, pap_slots, tag, false, red, [] {});

    // phase 2: alpha; r -= alpha A_hat p, <r, r>; the edges' r published
    alpha = safe_div(an, pap);
    float rr = 0.f;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int ti = band * kRows + s, i = i0 + ti, k = i * W + j;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[s][c] = r[s][c] - alpha * ap[s][c];
        rr += r[s][c] * r[s][c];
      }
      if ((ti == 0 || ti == kTileH - 1 || tj == 0 || tj == kTileW - 1) &&
          i < H && j < W)
        st3(q.r, k, HW, r[s]);
    }
    const float rn = grid_sum(rr, rr_slots, tag + 1u, true, red,
                              [&] { ring_reads(tag + 1u, pn); });
    beta = safe_div(rn, an);
    an = rn;
  }

  // the last step
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = i0 + band * kRows + s, k = i * W + j;
    if (i < H && j < W) {
#pragma unroll
      for (int c = 0; c < 3; ++c) dl[s][c] += alpha * p[s][c];
      st3(q.delta, k, HW, dl[s]);
    }
  }
}

}  // namespace onchip
}  // namespace
