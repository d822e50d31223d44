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
// 96 B per voxel, 201 MB at 128^3, which is 60 us at 3.35 TB/s; the cost
// alone reads 48 B (30 us), the model cost 72 B (45 us).
//
// The design: vol_tile.cuh's core, as K6 and K16 run it.  A block of
// 32 (W) x 8 (H) threads owns a tile of columns and marches along D
// through a chunk of own planes sized to one wave of the kernel's own
// occupancy (vol_lin_planes), each thread a column; a plane's raw data
// arrive by 4-byte cp.async copies in a ring of two shared-memory stages
// a plane ahead, each thread's own voxel and (threads 0 .. kTileHalo - 1)
// one halo voxel, and each voxel's sincosf is taken once.  Each arap
// residual is formed once, by its centre, which keeps its r^2 and its
// halves: the D pair with the plane before in registers, the four in-plane
// residuals reading the neighbours' Offset and UrShape from shared memory;
// in full mode each hands -w_reg r to its neighbour (the plane before's
// registers, or a shared slot the neighbour adds after its own), and a
// halo voxel forms only the residual that points into the tile.  R(a) and
// its derivatives come from the one trig (LinRot).  One template per mode:
// the cost modes carry no derivative, stage no slots and take the
// sincosf of own voxels only; the model cost stages delta's Offset for the
// neighbours.  The gather form K8 had (one thread a voxel of a one-plane
// block, 21 sincosf a voxel, every residual formed twice, about 330 scalar
// loads a voxel) took 254.3 us in full mode at 128^3, 129.3 for the cost
// and 168.2 for the model cost (PERF.md).  The cost is per-block partials
// from a fixed shared-memory tree, summed by the caller (no float atomics:
// repeated runs match bit for bit); the cost counts only the residuals
// centred on a block's own voxels, so a residual centred on a face plane,
// a halo voxel or a slab's halo plane is counted once, by its own block.
// sincosf is the full-precision version: the build uses no
// --use_fast_math.

#include "tile_launch.cuh"
#include "vol_tile.cuh"

namespace {

constexpr int kLinPlanesMin = 4;  // own planes a block marches, at least

// The fields of K8's ring: an own voxel's Offset, Angle, UrShape,
// Constraints and (model cost) delta's Offset and Angle; a halo voxel's
// Offset, UrShape and its angles (full: it forms the residual into the
// tile) or delta's Offset (model cost: the tile's residuals read it)
template <int kMode>
struct LinFields {
  static constexpr int kO = 0, kA = 3, kU = 6, kC = 9, kD = 12, kDA = 15;
  static constexpr int kOwnFields = kMode == kModelCost ? 18 : 12;
  static constexpr int kHO = 0, kHU = 3, kHX = 6;
  static constexpr int kHaloFields = kMode == kCostOnly ? 6 : 9;
};

// Dynamic shared memory of K8's march: two ring stages of the own and the
// halo voxels' fields, Offset and UrShape over the tile with its halo
// (and delta's Offset in the model cost), the exchange slots (full)
template <int kMode>
constexpr size_t vol_lin_smem() {
  using F = LinFields<kMode>;
  return sizeof(float) *
         (2 * F::kOwnFields * kTileThreads + 2 * F::kHaloFields * kTileHalo +
          (kMode == kModelCost ? 9 : 6) * kTY * kTX +
          (kMode == kFull ? 4 * 3 * kTileH * kTileW : 0));
}
// kTileMinBlocks blocks an SM within the 227 KB an SM gives its blocks
static_assert(kTileMinBlocks * (vol_lin_smem<kFull>() + 1024) <= 232448 &&
                  kTileMinBlocks * (vol_lin_smem<kCostOnly>() + 1024) <=
                      232448 &&
                  kTileMinBlocks * (vol_lin_smem<kModelCost>() + 1024) <=
                      232448,
              "two blocks of K8 an SM");

// R(a) and its derivatives at a voxel: DRot's entries and sin(beta), from
// which R(a) = [[g10, -a02, a01], [-g00, -a12, a11], [-sb, -a22, a21]]
// (vol_energy.cuh rot)
struct LinRot {
  DRot m;
  float sb;
};

__device__ __forceinline__ LinRot lin_rot(const Trig& t) {
  return LinRot{drot_of(t), t.sb};
}

// r = w_reg ((O_c - O_n) - R(a_c) e), e = U_c - U_n: an arap residual's
// value at the linearization point
__device__ __forceinline__ void lin_value(const LinRot& q, const float cO[3],
                                          const float nO[3], const float e[3],
                                          float w_reg, float r[3]) {
  const float re0 = q.m.g10 * e[0] - q.m.a02 * e[1] + q.m.a01 * e[2];
  const float re1 = -q.m.g00 * e[0] - q.m.a12 * e[1] + q.m.a11 * e[2];
  const float re2 = -q.sb * e[0] - q.m.a22 * e[1] + q.m.a21 * e[2];
  r[0] = w_reg * ((cO[0] - nO[0]) - re0);
  r[1] = w_reg * ((cO[1] - nO[1]) - re1);
  r[2] = w_reg * ((cO[2] - nO[2]) - re2);
}

// A voxel as K8's march holds it
struct LinVox {
  float O[3], U[3];    // Offset, UrShape
  float D[3], DA[3];   // delta's Offset and Angle (the model cost)
  Trig t;              // its angles' sincos (voxels that centre a residual)
  float jO[3], jA[3];  // J^T F so far (full)
  float gA[3];         // diag's Angle part so far (full)
  float ssq;           // the squared residuals centred here
  int nreg;            // residual halves on the Offset (full): diag's
  bool in;             // inside the volume
  bool mine;           // on an own plane of the chunk
};

// The arap residual centred at c (rotation q) reading the neighbour's
// Offset nO, UrShape nU and (model cost) delta's Offset nD: r, plus J delta
// in the model cost.  r^2 goes into c's ssq and, in full mode, c's halves
// into its sums: w_reg r on O_c, -w_reg G^T r on A_c and w_reg^2 |G_k|^2
// on diag's A_c, G_k = dR/da_k e, and two w_reg^2 on diag's O_c: its own,
// and the one of the neighbour's residual reading c, valid exactly when
// this one is.  Returns r; the caller routes its half -w_reg r to the
// neighbour.
template <int kMode>
__device__ __forceinline__ void lin_residual(LinVox& c, const LinRot& q,
                                             const float nO[3],
                                             const float nU[3],
                                             const float nD[3], float w_reg,
                                             float r[3]) {
  const float e[3] = {c.U[0] - nU[0], c.U[1] - nU[1], c.U[2] - nU[2]};
  lin_value(q, c.O, nO, e, w_reg, r);
  if (kMode != kCostOnly) {
    float g[3][3];
    drot_apply(q.m, e, g);
    if (kMode == kModelCost) {
      float jd[3];
      arap_jv(w_reg, g, c.D, nD, c.DA, jd);
      for (int i = 0; i < 3; ++i) r[i] += jd[i];
    } else {
      for (int i = 0; i < 3; ++i) c.jO[i] += w_reg * r[i];
      for (int k = 0; k < 3; ++k) {
        c.jA[k] -= w_reg * (g[k][0] * r[0] + g[k][1] * r[1] + g[k][2] * r[2]);
        c.gA[k] += w_reg * w_reg *
                   (g[k][0] * g[k][0] + g[k][1] * g[k][1] + g[k][2] * g[k][2]);
      }
      c.nreg += 2;
    }
  }
  c.ssq += r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
}

// K8's march: one block over own planes [c0, c1) of the slab array g, as
// vol_tile_march walks them (planes c0 - 1 and c1 read for the pair that
// crosses the chunk's faces; a plane's copies start under the plane
// before's in-plane residuals), forming each residual once, by its centre.
// x and delta are the slab's flat unknown vectors; jtf and diag the local
// layout (voxel k of the array at ko0 + k of No, full mode).  Returns the
// thread's sum of its own voxels' squared residuals, arap and fit: the
// cost (of F + J delta in the model cost) times 2.
template <int kMode>
__device__ __forceinline__ float vol_linearize_march(
    const Vol& g, int c0, int c1, const float* __restrict__ x,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ delta, float* __restrict__ jtf,
    float* __restrict__ diag, int ko0, int No, float w_fit, float w_reg) {
  using F = LinFields<kMode>;
  constexpr bool full = kMode == kFull, model = kMode == kModelCost;
  extern __shared__ __align__(16) float lin_smem[];
  float* const own_ring = lin_smem;
  float* const halo_ring = own_ring + 2 * F::kOwnFields * kTileThreads;
  auto sO = reinterpret_cast<float(*)[kTY][kTX]>(halo_ring +
                                                 2 * F::kHaloFields *
                                                     kTileHalo);
  auto sU = sO + 3;
  auto sD = sU + 3;  // the model cost
  auto sR = reinterpret_cast<float(*)[3][kTileH][kTileW]>(sU + 3);  // full
  const int tx = threadIdx.x, ty = threadIdx.y, t = vthread_rank();
  const int w0 = blockIdx.x * kTileW, h0 = blockIdx.y * kTileH;
  const int w = w0 + tx, h = h0 + ty;
  const int N = g.n();
  int hdh = 0, hdw = 0, ho = 0, odw = 0, odh = 0, odd = 0;
  if (t < kTileHalo) {
    tile_halo(t, &hdh, &hdw, &ho);
    offset(ho, &odw, &odh, &odd);
  }
  const int hh = h0 + hdh, hw = w0 + hdw;
  // this thread's slots in ring stage d & 1
  auto own_at = [&](int d) {
    return own_ring + (d & 1) * F::kOwnFields * kTileThreads + t;
  };
  auto halo_at = [&](int d) {
    return halo_ring + (d & 1) * F::kHaloFields * kTileHalo + t;
  };
  // start plane d's copies: the own voxel, and the halo voxel on an own
  // plane
  auto fetch = [&](int d) {
    const bool mine = d >= c0 && d < c1;
    if (g.inside(d, h, w)) {
      const int k = g.idx(d, h, w);
      float* dst = own_at(d);
      for (int c = 0; c < 3; ++c) {
        tile_copy(dst, F::kO + c, kTileThreads, x, 3 * k + c);
        tile_copy(dst, F::kU + c, kTileThreads, ur, 3 * k + c);
        if (full || mine)
          tile_copy(dst, F::kA + c, kTileThreads, x, 3 * N + 3 * k + c);
        if (mine) tile_copy(dst, F::kC + c, kTileThreads, cons, 3 * k + c);
        if (model) {
          tile_copy(dst, F::kD + c, kTileThreads, delta, 3 * k + c);
          if (mine)
            tile_copy(dst, F::kDA + c, kTileThreads, delta,
                      3 * N + 3 * k + c);
        }
      }
    }
    if (mine && t < kTileHalo && g.inside(d, hh, hw)) {
      const int k = g.idx(d, hh, hw);
      float* dst = halo_at(d);
      for (int c = 0; c < 3; ++c) {
        tile_copy(dst, F::kHO + c, kTileHalo, x, 3 * k + c);
        tile_copy(dst, F::kHU + c, kTileHalo, ur, 3 * k + c);
        if (full) tile_copy(dst, F::kHX + c, kTileHalo, x, 3 * N + 3 * k + c);
        if (model) tile_copy(dst, F::kHX + c, kTileHalo, delta, 3 * k + c);
      }
    }
    __pipeline_commit();
  };
  // plane d's own voxel from its stage
  auto load = [&](int d, bool in, bool mine) {
    LinVox v = {};
    v.in = in;
    v.mine = mine;
    if (in) {
      const float* src = own_at(d);
      float a[3];
      for (int c = 0; c < 3; ++c) {
        v.O[c] = src[(F::kO + c) * kTileThreads];
        v.U[c] = src[(F::kU + c) * kTileThreads];
        a[c] = src[(F::kA + c) * kTileThreads];
        if (model) {
          v.D[c] = src[(F::kD + c) * kTileThreads];
          v.DA[c] = src[(F::kDA + c) * kTileThreads];
        }
      }
      if (full || mine) v.t = trig(a);
    }
    return v;
  };

  float ssq = 0.f;
  LinVox prev = {};  // the plane before
  fetch(c0 - 1);
  for (int d = c0 - 1; d <= c1; ++d) {
    const bool own = d >= c0 && d < c1;
    const bool cin = g.inside(d, h, w);
    __pipeline_wait_prior(0);
    LinVox cur = load(d, cin, own && cin);
    // a face plane before the chunk: plane c0 - 1's stage holds nothing
    // that is still to be read
    if (d < c0) fetch(d + 1);
    if (prev.in && cur.in) {
      // the D pair: r_{d-1,+D}, then r_{d,-D}
      float r[3] = {0.f, 0.f, 0.f};
      if (full || prev.mine)
        lin_residual<kMode>(prev, lin_rot(prev.t), cur.O, cur.U, cur.D,
                            w_reg, r);
      if (full)
        for (int c = 0; c < 3; ++c) cur.jO[c] -= w_reg * r[c];
      if (full || cur.mine)
        lin_residual<kMode>(cur, lin_rot(cur.t), prev.O, prev.U, prev.D,
                            w_reg, r);
      if (full)
        for (int c = 0; c < 3; ++c) prev.jO[c] -= w_reg * r[c];
    }
    if (prev.mine) {
      // the plane before is whole (its stage not yet refilled): its fit
      // term, its cost, its output
      const float* src = own_at(d - 1);
      const bool fit = src[F::kC * kTileThreads] >= kFitValid;
      float f[3] = {0.f, 0.f, 0.f};
      if (fit)
        for (int c = 0; c < 3; ++c) {
          f[c] = w_fit * (prev.O[c] - src[(F::kC + c) * kTileThreads]);
          if (model) f[c] += w_fit * prev.D[c];
        }
      ssq += prev.ssq + (f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);
      if (full) {
        const int ko = ko0 + g.idx(d - 1, h, w);
        const float gO =
            prev.nreg * (w_reg * w_reg) + (fit ? w_fit * w_fit : 0.f);
        for (int c = 0; c < 3; ++c) {
          jtf[3 * ko + c] = prev.jO[c] + w_fit * f[c];
          jtf[3 * No + 3 * ko + c] = prev.jA[c];
          diag[3 * ko + c] = gO;
          diag[3 * No + 3 * ko + c] = prev.gA[c];
        }
      }
    }
    if (own) {
      // the in-plane residuals: stage the Offset and UrShape (and delta's
      // Offset), own and halo
      if (cin)
        for (int c = 0; c < 3; ++c) {
          sO[c][ty + 1][tx + 1] = cur.O[c];
          sU[c][ty + 1][tx + 1] = cur.U[c];
          if (model) sD[c][ty + 1][tx + 1] = cur.D[c];
        }
      const bool hin = t < kTileHalo && g.inside(d, hh, hw);
      float hO[3], hU[3], hX[3];
      if (hin) {
        const float* src = halo_at(d);
        for (int c = 0; c < 3; ++c) {
          hO[c] = src[(F::kHO + c) * kTileHalo];
          hU[c] = src[(F::kHU + c) * kTileHalo];
          if (!(kMode == kCostOnly)) hX[c] = src[(F::kHX + c) * kTileHalo];
          sO[c][hdh + 1][hdw + 1] = hO[c];
          sU[c][hdh + 1][hdw + 1] = hU[c];
          if (model) sD[c][hdh + 1][hdw + 1] = hX[c];
        }
      }
      __syncthreads();
      fetch(d + 1);
      if (cur.mine) {
        const LinRot q = lin_rot(cur.t);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          int dw, dh, dd;
          offset(o, &dw, &dh, &dd);
          if (!g.inside(d, h + dh, w + dw)) continue;
          const int sy = ty + 1 + dh, sx = tx + 1 + dw;
          const float nO[3] = {sO[0][sy][sx], sO[1][sy][sx], sO[2][sy][sx]};
          const float nU[3] = {sU[0][sy][sx], sU[1][sy][sx], sU[2][sy][sx]};
          float nD[3] = {0.f, 0.f, 0.f};
          if (model)
            for (int c = 0; c < 3; ++c) nD[c] = sD[c][sy][sx];
          float r[3];
          lin_residual<kMode>(cur, q, nO, nU, nD, w_reg, r);
          const int ry = ty + dh, rx = tx + dw;
          if (full && ry >= 0 && ry < kTileH && rx >= 0 && rx < kTileW)
            for (int c = 0; c < 3; ++c) sR[o][c][ry][rx] = r[c];
        }
      }
      if (full && hin && g.inside(d, hh + odh, hw + odw)) {
        // the halo voxel's residual into the tile
        const int sy = hdh + 1 + odh, sx = hdw + 1 + odw;
        const float nO[3] = {sO[0][sy][sx], sO[1][sy][sx], sO[2][sy][sx]};
        const float e[3] = {hU[0] - sU[0][sy][sx], hU[1] - sU[1][sy][sx],
                            hU[2] - sU[2][sy][sx]};
        float r[3];
        lin_value(lin_rot(trig(hX)), hO, nO, e, w_reg, r);
        for (int c = 0; c < 3; ++c) sR[ho][c][hdh + odh][hdw + odw] = r[c];
      }
      __syncthreads();
      if (full && cin) {
        // the neighbours' halves, in offset order
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          int dw, dh, dd;
          offset(o, &dw, &dh, &dd);
          if (!g.inside(d, h - dh, w - dw)) continue;
          for (int c = 0; c < 3; ++c) cur.jO[c] -= w_reg * sR[o][c][ty][tx];
        }
      }
    }
    prev = cur;
  }
  return ssq;
}

// K8 on the tile core over S extended D slabs (VolSlabs in
// vol_energy.cuh; a whole volume is one slab with no halo): blockIdx.z =
// slab * chunks + chunk of `planes` own planes, a chunk's face planes read
// from the slab's own halo (he >= 1) or past the volume's edge, where
// Vol::inside makes them no neighbour; one cost partial a block, slab by
// slab
template <int kMode>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
vol_linearize_kernel(const float* __restrict__ x,
                     const float* __restrict__ ur,
                     const float* __restrict__ cons,
                     const float* __restrict__ params,
                     const float* __restrict__ delta,
                     float* __restrict__ jtf, float* __restrict__ diag,
                     float* __restrict__ cost_partials, int H, int W,
                     VolSlabs sl, int planes) {
  __shared__ float sh[kTileThreads];
  const int chunks = (sl.n + planes - 1) / planes;
  const int sb = blockIdx.z / chunks, ch = blockIdx.z % chunks;
  const Vol g = sl.vol(sb, H, W);
  const int N = g.n();
  const int c0 = sl.he + ch * planes;
  const int c1 = sl.he + min((ch + 1) * planes, sl.n);
  const size_t s6 = (size_t)sb * 6 * N, s3 = (size_t)sb * 3 * N;
  const float ssq = vol_linearize_march<kMode>(
      g, c0, c1, x + s6, ur + s3, cons + s3,
      delta != nullptr ? delta + s6 : nullptr, jtf, diag,
      (sb * sl.n - sl.he) * H * W, sl.S * sl.n * H * W, params[0],
      params[1]);
  const float s = vblock_sum<kTileThreads>(ssq, sh);
  if (vthread_rank() == 0) cost_partials[vblock_rank()] = 0.5f * s;
}

// The own planes a block of K8 in mode kMode marches over S slabs of n
// planes of H x W: the fewest (kLinPlanesMin at least) that keep the grid
// to one wave of the blocks the device holds at once (its occupancy with
// the mode's registers and shared memory, granted first; at 128^3 on an
// H100, 32); minus the CUDA error of a call that fails
template <int kMode>
int vol_lin_planes(int S, int n, int H, int W) {
  constexpr size_t smem = vol_lin_smem<kMode>();
  const cudaError_t err = vol_tile_prepare(vol_linearize_kernel<kMode>, smem);
  if (err != cudaSuccess) return -(int)err;
  const int capacity =
      tile_capacity(vol_linearize_kernel<kMode>, kTileThreads, smem);
  if (capacity < 0) return capacity;
  const long tiles = std::max(1L, (long)S * ((W + kTileW - 1) / kTileW) *
                                      ((H + kTileH - 1) / kTileH));
  const long chunks = std::max(1L, capacity / tiles);  // a slab
  return (int)std::max<long>(kLinPlanesMin, (n + chunks - 1) / chunks);
}

// K8's grid: (W, H) tiles, and S slabs of chunks of `planes` own planes on
// z (at most 65,535: a deeper grid fails to launch, and the wrapper raises)
dim3 vol_lin_grid(int S, int n, int H, int W, int planes) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
              S * ((n + planes - 1) / planes));
}

template <int kMode>
int vol_lin_launch(const float* x, const float* ur, const float* cons,
                   const float* params, const float* delta, float* jtf,
                   float* diag, float* cost_partials, int H, int W,
                   VolSlabs sl, void* stream) {
  const int planes = vol_lin_planes<kMode>(sl.S, sl.n, H, W);
  if (planes < 0) return -planes;
  vol_linearize_kernel<kMode><<<vol_lin_grid(sl.S, sl.n, H, W, planes),
                                dim3(kTileW, kTileH), vol_lin_smem<kMode>(),
                                (cudaStream_t)stream>>>(
      x, ur, cons, params, delta, jtf, diag, cost_partials, H, W, sl, planes);
  return (int)cudaGetLastError();
}

// K8 in `mode` (0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum (F + J delta)^2 alone) over the slabs sl
int vol_linearize(const float* x, const float* ur, const float* cons,
                  const float* params, const float* delta, float* jtf,
                  float* diag, float* cost_partials, int H, int W,
                  VolSlabs sl, int mode, void* stream) {
  return with_mode(mode, (int)cudaErrorInvalidValue, [&](auto m) {
    return vol_lin_launch<decltype(m)::value>(x, ur, cons, params, delta,
                                              jtf, diag, cost_partials, H, W,
                                              sl, stream);
  });
}

}  // namespace

// K7's partials (stream3d_kernels.cu): one a block of its 32 x 8 x 1 grid
extern "C" int opt_vol_blocks(int D, int H, int W) {
  const dim3 gr = vol_grid(D, H, W);
  return (int)(gr.x * gr.y * gr.z);
}

// K8's cost partials over S slabs of n own planes of H x W in `mode`: one
// a block (minus the CUDA error where the occupancy query fails); a whole
// volume is S = 1, n = D
extern "C" int opt_vol_linearize_blocks(int S, int n, int H, int W,
                                        int mode) {
  return with_mode(mode, -(int)cudaErrorInvalidValue, [&](auto m) {
    const int planes = vol_lin_planes<decltype(m)::value>(S, n, H, W);
    if (planes < 0) return planes;
    const dim3 gr = vol_lin_grid(S, n, H, W, planes);
    return (int)(gr.x * gr.y * gr.z);
  });
}

// mode: 0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum (F + J delta)^2 alone.  delta is read only in mode 2, jtf and
// diag written only in mode 0; the cost partials are
// opt_vol_linearize_blocks(1, D, H, W, mode)
extern "C" int opt_vol_linearize(const float* x, const float* ur,
                                 const float* cons, const float* params,
                                 const float* delta, float* jtf, float* diag,
                                 float* cost_partials, int D, int H, int W,
                                 int mode, void* stream) {
  return vol_linearize(x, ur, cons, params, delta, jtf, diag, cost_partials,
                       H, W, VolSlabs{1, D, 0, 0, D}, mode, stream);
}

// K8's global-offset mode over S extended D slabs (VolSlabs in
// vol_energy.cuh): the arrays hold S slabs of n + 2 he planes, slab s's
// plane 0 at global plane d0 + s * n of Dg; jtf and diag cover the own
// planes in the local layout, the cost partials
// (opt_vol_linearize_blocks(S, n, H, W, mode)) come slab by slab
extern "C" int opt_vol_slab_linearize(const float* x, const float* ur,
                                      const float* cons, const float* params,
                                      const float* delta, float* jtf,
                                      float* diag, float* cost_partials,
                                      int S, int n, int he, int H, int W,
                                      int d0, int Dg, int mode,
                                      void* stream) {
  return vol_linearize(x, ur, cons, params, delta, jtf, diag, cost_partials,
                       H, W, VolSlabs{S, n, he, d0, Dg}, mode, stream);
}
