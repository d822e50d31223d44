// The row-marching 2-D apply core of K1 warp_jtj_apply (warp_kernels.cu),
// K15 warp_slab_apply (stream_kernels.cu) and K13 resident_pcg's apply
// (resident_kernels.cu): J^T J v for image_warping
// (warp_energy.cuh states the energy), each pixel's data read once, its
// sincosf taken once, each residual formed once.
//
// What bounded the gather form on this card.  The gather form, which K4
// and K5 keep (warp_energy.cuh jtj_at, one thread a pixel), takes
// five sincosf a pixel (its own and one for each neighbour whose residual
// reads it), forms each of the eight residuals that touch a pixel, so
// every residual twice, and reads UrShape, Mask and the operand again at
// each neighbour.  At 2048^2 K1 took 141.5-142.0 us against its bytes'
// 60.1 us, and 14.0-14.3 us more with LM's ctc, whose 50.4 MB more ran at
// about HBM's peak (PERF.md): the base time is per-pixel work, not bytes.
//
// The design.  A warp covers kStrip = 32 columns, a lane a column along W,
// the contiguous axis: a strip of kOwn = 30 own columns and the column on
// each side of it (lanes 0 and 31), and marches down a chunk of own rows;
// a block holds kStripWarps strips side by side.  At each row:
//   - the lane reads its pixel once: UrShape, Constraints and the Offset
//     part of the operand's vectors as float2 pairs, the Angle, Mask and
//     the operand's Angle part as floats, in loads issued a row ahead into
//     a register double buffer, and takes its sincosf once;
//   - the H direction rides the march: the lane keeps the row before in
//     registers and forms the pair r_{i-1,+H} and r_{i,-H} once, each half
//     into its pixel's sums.  Row i-1 is then whole and is written; the
//     chunk reads one face row on each side for the pair that crosses it;
//   - the lane forms its pixel's two W residuals once, with the
//     neighbour's operand and UrShape from the lanes beside it (warp
//     shuffles): the centre half (w_reg jp on O, -w_reg G^T jp on A) into
//     its own sums, and jp back to the neighbour by a shuffle, which adds
//     -w_reg jp.  Lanes 0 and 31 hold the columns beside the strip: what
//     they form that points into the strip reaches lanes 1 and 30, and
//     they write nothing.
// Every pixel adds what it receives in a fixed order (the H pair, its two
// W residuals, the W halves it is handed, the next H pair, the fit term),
// and K1's dot partial comes from a fixed tree: repeated calls match bit
// for bit.  No shared memory but K1's partial, no barrier in the march, no
// atomics.  InBounds is an explicit test on global rows (Grid::inside),
// never a zero fill: on an extended slab (K15) a halo row past the global
// edge holds no pixel.  Any W, H and slab height; a grid of at most 65,535
// chunks a slab.
//
// Measured on an H100 (PERF.md): 32 own columns a warp, with lanes 0 and
// 31 also loading the pixel beside the strip and forming its residual into
// it, took 88 registers (K1) and was 5% slower at 2048^2 and 7% at 512^2;
// the two lanes' extra sincosf and loads run for the whole warp.  Chunks
// of a fixed 16, 32 or 64 rows were 5-15% slower at 2048^2 than chunks
// sized to one wave (warp_tile_rows), and 128 rows 40%.

#pragma once

#include <algorithm>
#include <cstdint>

#include "warp_energy.cuh"

namespace {

constexpr int kStrip = 32;      // columns a warp covers, a lane each
constexpr int kOwn = kStrip - 2;  // of them its own: lanes 1 .. 30
constexpr int kStripWarps = 4;  // strips a block holds, side by side
constexpr int kStripThreads = kStrip * kStripWarps;
constexpr int kMarchMin = 4;    // own rows a warp marches, at least
constexpr unsigned kLanes = 0xffffffffu;

// a[2k], a[2k + 1]: one 8-byte load where every pair lies on 8 bytes
__device__ __forceinline__ void ld_pair(const float* __restrict__ a, int k,
                                        bool pairs, float* x0, float* x1) {
  if (pairs) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(a) + k);
    *x0 = t.x;
    *x1 = t.y;
  } else {
    *x0 = __ldg(a + 2 * k);
    *x1 = __ldg(a + 2 * k + 1);
  }
}

__device__ __forceinline__ void st_pair(float* __restrict__ a, int k,
                                        bool pairs, float x0, float x1) {
  if (pairs) {
    reinterpret_cast<float2*>(a)[k] = make_float2(x0, x1);
  } else {
    a[2 * k] = x0;
    a[2 * k + 1] = x1;
  }
}

// What a pixel's loads bring: the Io's kRaw values (its vectors at the
// pixel), the Angle, UrShape, Mask and (pixels the lane writes)
// Constraints
template <class Io>
struct Raw {
  float io[Io::kRaw];
  float ang, u0, u1, m, c0, c1;
};

// A pixel as the march holds it
struct Pix {
  float v0, v1, vA;  // the operand J^T J is applied to
  float x0, x1, xA;  // the Io's values for the output (K1 ctc, K15 sq,
  float y0, y1, yA;  // K13 sq and p)
  float u0, u1;      // UrShape
  float sn, cs;      // sincos of the Angle (kept pixels only)
  float a0, a1, aA;  // J^T J v so far
  bool keep;         // inside the grid, Mask 0
  bool fit;          // written by the lane, both Constraints channels >= 0
};

// The reg residual centred at c reading the neighbour's operand (n0, n1)
// and UrShape (nu0, nu1): its centre half into c's sums, with
// G = R'(a_c) (U_c - U_n); returns jp, whose half -w_reg jp the caller
// routes to the neighbour
__device__ __forceinline__ void reg_centre(Pix& c, float n0, float n1,
                                           float nu0, float nu1, float w_reg,
                                           float* jp0, float* jp1) {
  float g0, g1;
  drot(c.sn, c.cs, c.u0 - nu0, c.u1 - nu1, &g0, &g1);
  *jp0 = w_reg * ((c.v0 - n0) - g0 * c.vA);
  *jp1 = w_reg * ((c.v1 - n1) - g1 * c.vA);
  c.a0 += w_reg * *jp0;
  c.a1 += w_reg * *jp1;
  c.aA += -w_reg * g0 * *jp0 + -w_reg * g1 * *jp1;
}

// The march of one warp over own rows [c0, c1) of the array g, lane column
// j = w0 - 1 + lane for a strip of own columns w0 .. w0 + kOwn - 1 (rows
// c0 - 1 and c1 are read for the pair that crosses the chunk's faces).
// pairs: every pair array lies on 8 bytes (ld_pair).  The Io gives the
// operand: io.fetch(k, own, pairs, r) loads its kRaw values at array pixel
// k (own: a pixel the lane writes), io.operand(r, px) forms px's v and x
// from them, and io.store(i, j, px, pairs) writes the pixel's output from
// px.a = J^T J v (its fit term added) and returns what it adds to the dot.
// Returns this lane's share of the dot, summed in row order.
template <class Io>
__device__ __forceinline__ float warp_tile_march(
    const Grid& g, int c0, int c1, int j, const float* __restrict__ angle,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ mask, float w_fit, float w_reg, bool pairs,
    const Io& io) {
  const int lane = threadIdx.x;
  const bool first = lane == 0, last = lane == kStrip - 1;
  const bool writes = !first && !last;  // an own column

  auto fetch = [&](int i, bool in, bool own, Raw<Io>& r) {
    if (!in) return;
    const int k = i * g.W + j;
    io.fetch(k, own, pairs, r.io);
    r.ang = __ldg(angle + k);
    ld_pair(ur, k, pairs, &r.u0, &r.u1);
    r.m = __ldg(mask + k);
    if (own) ld_pair(cons, k, pairs, &r.c0, &r.c1);
  };
  auto unpack = [&](const Raw<Io>& r, bool in, bool own) {
    Pix px;
    io.operand(r.io, px);
    px.u0 = r.u0;
    px.u1 = r.u1;
    px.keep = in && r.m == 0.f;
    px.sn = px.cs = 0.f;
    if (px.keep) sincosf(r.ang, &px.sn, &px.cs);
    px.fit = own && r.c0 >= 0.f && r.c1 >= 0.f;
    px.a0 = px.a1 = px.aA = 0.f;
    return px;
  };

  Raw<Io> nxt = {};
  bool nin = g.inside(c0 - 1, j);
  fetch(c0 - 1, nin, false, nxt);
  Pix prev = unpack(nxt, false, false);
  bool pin = false;  // the row before is inside the grid at this column
  float dot = 0.f;
  for (int i = c0 - 1; i <= c1; ++i) {
    const bool own = i >= c0 && i < c1;
    const bool cin = nin;
    const Raw<Io> cr = nxt;
    if (i < c1) {
      // the next row's loads, in flight under this row's math
      nin = g.inside(i + 1, j);
      fetch(i + 1, nin, i + 1 < c1 && writes, nxt);
    }
    Pix cur = unpack(cr, cin, own && writes);
    if (prev.keep && cur.keep) {
      // the H pair: r_{i-1,+H}, then r_{i,-H}
      float jp0, jp1;
      reg_centre(prev, cur.v0, cur.v1, cur.u0, cur.u1, w_reg, &jp0, &jp1);
      cur.a0 -= w_reg * jp0;
      cur.a1 -= w_reg * jp1;
      reg_centre(cur, prev.v0, prev.v1, prev.u0, prev.u1, w_reg, &jp0, &jp1);
      prev.a0 -= w_reg * jp0;
      prev.a1 -= w_reg * jp1;
    }
    if (i - 1 >= c0 && pin && writes) {
      // the row before is whole: its fit term, then its output
      if (prev.keep && prev.fit) {
        prev.a0 += w_fit * (w_fit * prev.v0);
        prev.a1 += w_fit * (w_fit * prev.v1);
      }
      dot += io.store(i - 1, j, prev, pairs);
    }
    if (own) {
      // the W pair.  The right neighbour j + 1 is the next lane's pixel
      // (lane 31 has none in the warp)
      float n0 = __shfl_down_sync(kLanes, cur.v0, 1);
      float n1 = __shfl_down_sync(kLanes, cur.v1, 1);
      float nu0 = __shfl_down_sync(kLanes, cur.u0, 1);
      float nu1 = __shfl_down_sync(kLanes, cur.u1, 1);
      bool nk = __shfl_down_sync(kLanes, (int)cur.keep, 1) != 0 && !last;
      float jr0 = 0.f, jr1 = 0.f;
      if (cur.keep && nk) reg_centre(cur, n0, n1, nu0, nu1, w_reg, &jr0, &jr1);
      // the left neighbour j - 1, the lane before's (lane 0 has none)
      n0 = __shfl_up_sync(kLanes, cur.v0, 1);
      n1 = __shfl_up_sync(kLanes, cur.v1, 1);
      nu0 = __shfl_up_sync(kLanes, cur.u0, 1);
      nu1 = __shfl_up_sync(kLanes, cur.u1, 1);
      nk = __shfl_up_sync(kLanes, (int)cur.keep, 1) != 0 && !first;
      float jl0 = 0.f, jl1 = 0.f;
      if (cur.keep && nk) reg_centre(cur, n0, n1, nu0, nu1, w_reg, &jl0, &jl1);
      // the neighbours' halves: r_{j-1,+W} from the lane before, then
      // r_{j+1,-W} from the next lane (lanes 0 and 31 take their own jp
      // back, and write nothing)
      cur.a0 -= w_reg * __shfl_up_sync(kLanes, jr0, 1);
      cur.a1 -= w_reg * __shfl_up_sync(kLanes, jr1, 1);
      cur.a0 -= w_reg * __shfl_down_sync(kLanes, jl0, 1);
      cur.a1 -= w_reg * __shfl_down_sync(kLanes, jl1, 1);
    }
    prev = cur;
    pin = cin;
  }
  return dot;
}

// The block's sum of the lanes' v: a shuffle tree in each warp, then the
// warps in order (the same order on every run); thread (0, 0) holds it
__device__ __forceinline__ float strip_block_sum(float v, float* sh) {
  for (int o = kStrip / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(kLanes, v, o);
  if (threadIdx.x == 0) sh[threadIdx.y] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kStripWarps; ++w) s += sh[w];
  return s;
}

// Blocks along W: kStripWarps strips of kOwn own columns each
int warp_tile_gx(int W) {
  return ((W + kOwn - 1) / kOwn + kStripWarps - 1) / kStripWarps;
}

// The blocks of `kernel` the current device holds at once: its occupancy
// at kStripThreads threads a block (the kernel's registers), times the
// SMs; cached per device.  Minus the CUDA error where a query fails.
template <class Kernel>
int warp_tile_capacity(Kernel kernel) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < kDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kStripThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  const int capacity = std::max(1, sms * per_sm);
  if (dev < kDevices) cached[dev] = capacity;
  return capacity;
}

// The own rows a warp marches over S slabs of n rows, W columns, on a card
// that holds `capacity` blocks at once: the fewest (kMarchMin at least)
// that keep the grid to one wave, so that the chunks' face rows cost the
// least and no second wave runs with the card part idle (at 512^2 on an
// H100, kMarchMin)
int warp_tile_rows(int S, int n, int W, int capacity) {
  const long row_blocks = std::max(1L, (long)S * warp_tile_gx(W));
  const long chunks = std::max(1L, capacity / row_blocks);  // a slab
  return (int)std::max<long>(kMarchMin, (n + chunks - 1) / chunks);
}

// The grid of a march: (W, rows) blocks of kStripWarps strips, one slab
// per blockIdx.z
dim3 warp_tile_grid(int S, int n, int W, int rows) {
  return dim3(warp_tile_gx(W), (n + rows - 1) / rows, S);
}

// True when the pair arrays (given) lie on 8 bytes, and so does each
// slab's part of them (slab_floats apart)
template <class... T>
bool tile_pairs(long slab_floats, int S, const T*... arrays) {
  const std::uintptr_t any =
      (std::uintptr_t{0} | ... | reinterpret_cast<std::uintptr_t>(arrays));
  return any % 8 == 0 && (S == 1 || slab_floats % 2 == 0);
}

}  // namespace
