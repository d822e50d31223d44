// K1 warp_jtj_apply and K3 warp_linearize: the image_warping energy's
// Gauss-Newton and Levenberg-Marquardt operator, written out by hand.
//
// Replaces the work that the TPU kernel opt_tpu/ops/vmem_solver.py:
// VmemSolver._build traces into its body from the energy: the
// (J^T J + CtC) p apply of every PCG iteration (the reference's PCGStep1,
// K1 here) and the per-outer-iteration linearization -- J^T F,
// diag(J^T J), the masked cost and LM's model cost (PCGInit1, computeCost
// and createmodelcost, K3 here).  The TPU kernel is generic because it
// traces the energy's JAX evaluator; CUDA cannot trace Python, so these
// two kernels hold the derivatives of one energy,
// opt_tpu_torch/energies.py:image_warping, in closed form (the reference
// did the same in its hand-written WarpingSolver.cu).  warp_energy.cuh
// states the energy; K1's J^T J apply is warp_tile.cuh's core, which K15
// shares.
//
// J is UNMASKED (rows whose centre pixel is excluded stay in J); only the
// cost and the unknown side are masked: K1 zeroes Ap at excluded pixels,
// K3's costs skip residuals centred on them (opt_tpu/compile/
// plan_fns.py:7-10, :197-200, :217-234).
//
// Layout: the flat unknown vector holds Offset as (H, W, 2) then Angle as
// (H, W, 1), the JAX package's channel-last layout; UrShape and Constraints
// are (H, W, 2), Mask (H, W, 1); params = {w_fitSqrt, w_regSqrt} on the
// device.  K1's ctc (LM's CtC diagonal) and K3's delta (the model cost's
// step) are flat vectors of the unknown layout, or null.
//
// Bound on the card: device memory and launch latency.  K1 reads p (12 B),
// Angle (4 B), UrShape (8 B), Constraints (8 B) and Mask (4 B) per pixel
// and writes Ap (12 B): 48 B per pixel (60 B with ctc), 12.6 MB at 512^2,
// which sits in the 50 MB L2 across PCG iterations.  K3 reads x (12 B),
// UrShape, Constraints and Mask (20 B) per pixel, and delta (12 B) in the
// model cost, and in full mode writes J^T F and diag (24 B): 56 B per pixel
// in full mode, 70.1 us at 2048^2 at 3.35 TB/s; 32 B (40.1 us) for the
// cost alone, 44 B (55.1 us) for the model cost.
//
// K1 and K3 run on the row-marching core of warp_tile.cuh (a warp of 32
// lanes marches a strip of 30 own columns down a chunk of rows sized to
// one wave of the kernel's own occupancy, each pixel's data read once, its
// sincosf taken once, each residual formed once; the file says what
// bounded the gather form).  K1 is its apply march, K3 a linearize march
// beside it (warp_linearize_march below) that reuses its loaders, chunk
// rule and block sum, so that K1, K13 and K15 compile as they did: each
// reg residual is formed once, by its centre, which keeps its r^2 and its
// halves and hands -w_reg r to the neighbour (the row before in registers,
// the W neighbours by shuffles); one template per mode, so the cost modes
// carry no derivative and take the sincosf of own pixels only.  At
// 2048^2 the gather form K3 had (one thread a pixel, five sincosf a pixel,
// every residual formed twice, the neighbours' data read again) took
// 208.3-210.4 us in full mode on 4 slabs, 136.3-137.3 for the cost alone
// (PERF.md).  Sums across blocks are per-block partials from a fixed tree
// (no float atomics: repeated runs match bit for bit).  sincosf is the
// full-precision version: the build uses no --use_fast_math, since __sinf
// and __cosf would cost Rotate2D accuracy over 3,200 applies.

#include "warp_energy.cuh"
#include "warp_tile.cuh"

namespace {

// K1's operand and output: v = p; Ap = mask(J^T J p + ctc p) at own
// pixel k, and <p, Ap>.  Its raw data: p and (at the pixels the lane
// writes, LM) ctc.
struct ApplyIo {
  static constexpr int kRaw = 6;
  const float* __restrict__ p;
  const float* __restrict__ ctc;
  float* __restrict__ ap;
  int W, HW;
  __device__ void fetch(int k, bool own, bool pairs, float* r) const {
    ld_pair(p, k, pairs, &r[0], &r[1]);
    r[2] = __ldg(p + 2 * HW + k);
    if (own && ctc != nullptr) {
      ld_pair(ctc, k, pairs, &r[3], &r[4]);
      r[5] = __ldg(ctc + 2 * HW + k);
    }
  }
  __device__ void operand(const float* r, Pix& px) const {
    px.v0 = r[0], px.v1 = r[1], px.vA = r[2];
    px.x0 = r[3], px.x1 = r[4], px.xA = r[5];
  }
  __device__ float store(int i, int j, const Pix& px, bool pairs) const {
    const int k = i * W + j;
    float a0 = 0.f, a1 = 0.f, aA = 0.f, dot = 0.f;
    if (px.keep) {
      a0 = px.a0, a1 = px.a1, aA = px.aA;
      if (ctc != nullptr) {
        a0 += px.x0 * px.v0;
        a1 += px.x1 * px.v1;
        aA += px.xA * px.vA;
      }
      dot = px.v0 * a0 + px.v1 * a1 + px.vA * aA;
    }
    st_pair(ap, k, pairs, a0, a1);
    ap[2 * HW + k] = aA;
    return dot;
  }
};

// K1 on the row-marching core: blockIdx.y is a chunk of `rows` own rows
// (warp_tile_rows), each warp a strip of kOwn own columns; one dot
// partial a block
__global__ void __launch_bounds__(kStripThreads)
warp_jtj_apply_kernel(const float* __restrict__ x,
                      const float* __restrict__ p,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ mask,
                      const float* __restrict__ params,
                      const float* __restrict__ ctc,
                      float* __restrict__ ap, float* __restrict__ partials,
                      int H, int W, int rows, bool pairs) {
  __shared__ float sh[kStripWarps];
  const int w0 = (blockIdx.x * kStripWarps + threadIdx.y) * kOwn;
  const int c0 = blockIdx.y * rows, c1 = min(c0 + rows, H);
  const int HW = H * W;
  float dot = 0.f;
  if (w0 < W)
    dot = warp_tile_march(Grid{H, W}, c0, c1, w0 - 1 + (int)threadIdx.x,
                          x + 2 * HW, ur, cons, mask, params[0], params[1],
                          pairs, ApplyIo{p, ctc, ap, W, HW});
  const float s = strip_block_sum(dot, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// A pixel as K3's march holds it
struct LinPix {
  float o0, o1;      // Offset
  float d0, d1, dA;  // delta (the model cost)
  float u0, u1;      // UrShape
  float sn, cs;      // sincos of the Angle (pixels that centre a residual)
  float f0, f1;      // the fit residual (own pixels; 0 where not fitted)
  float j0, j1, jA;  // J^T F so far (full)
  float gA;          // diag's Angle part so far (full)
  float ssq;         // the squared reg residuals centred here
  int nreg;          // reg residual halves on the Offset (full): diag's
  bool keep;         // inside the grid, Mask 0
  bool mine;         // an own pixel of the lane: own row, lanes 1 .. 30
  bool fit;          // mine, both Constraints channels >= 0
};

// The reg residual centred at c reading the neighbour's Offset (n0, n1),
// UrShape (nu0, nu1) and (model cost) delta's Offset (nd0, nd1):
// r = w_reg ((O_c - O_n) - R(a_c) (U_c - U_n)), plus J delta in the model
// cost.  r^2 goes into c's ssq and, in full mode, c's halves into its sums:
// w_reg r on O_c, -w_reg G^T r on A_c and w_reg^2 |G|^2 on diag's A_c, with
// G = R'(a_c) (U_c - U_n), and two w_reg^2 on diag's O_c: its own, and the
// one of the neighbour's residual reading c, which is valid exactly when
// this one is.  Returns r; the caller routes its half -w_reg r to the
// neighbour.
template <int kMode>
__device__ __forceinline__ void lin_centre(LinPix& c, float n0, float n1,
                                           float nu0, float nu1, float nd0,
                                           float nd1, float w_reg, float* r0,
                                           float* r1) {
  const float e0 = c.u0 - nu0, e1 = c.u1 - nu1;
  float q0 = w_reg * ((c.o0 - n0) - (c.cs * e0 - c.sn * e1));
  float q1 = w_reg * ((c.o1 - n1) - (c.sn * e0 + c.cs * e1));
  if (kMode != kCostOnly) {
    float g0, g1;
    drot(c.sn, c.cs, e0, e1, &g0, &g1);
    if (kMode == kModelCost) {
      q0 += w_reg * ((c.d0 - nd0) - g0 * c.dA);
      q1 += w_reg * ((c.d1 - nd1) - g1 * c.dA);
    } else {
      g0 *= -w_reg;
      g1 *= -w_reg;
      c.j0 += w_reg * q0;
      c.j1 += w_reg * q1;
      c.jA += g0 * q0 + g1 * q1;
      c.gA += g0 * g0 + g1 * g1;
      c.nreg += 2;
    }
  }
  c.ssq += q0 * q0 + q1 * q1;
  *r0 = q0;
  *r1 = q1;
}

// What K3's loads bring of a pixel: Offset, Angle (pixels that centre a
// residual), UrShape, Mask, Constraints (own pixels) and delta (the model
// cost; its Angle at own pixels)
struct LinRaw {
  float o0, o1, ang, u0, u1, m, c0, c1, d0, d1, dA;
};

// K3's march: one warp over own rows [c0, c1) of the slab array g, lane
// column j = w0 - 1 + lane, as warp_tile_march walks them (loads a row
// ahead, rows c0 - 1 and c1 read for the pair that crosses the chunk's
// faces, the W neighbours by shuffles), forming each reg residual once, by
// its centre.  In full mode the residuals the lanes 0 and 31 and the face
// rows centre hand their halves into the strip's own pixels; in the cost
// modes only own pixels form residuals.  x and delta are the slab's flat
// unknown vectors, jtf and diag the local layout (own pixel (i, j) at
// ko0 + i W + j of No, full mode).  Returns the lane's sum of its own
// pixels' squared residuals, reg and fit, where Mask is 0: the masked cost
// (of F + J delta in the model cost) times 2.
template <int kMode>
__device__ __forceinline__ float warp_linearize_march(
    const Grid& g, int c0, int c1, int j, const float* __restrict__ x,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ mask, const float* __restrict__ delta,
    float* __restrict__ jtf, float* __restrict__ diag, int ko0, int No,
    float w_fit, float w_reg, bool pairs) {
  constexpr bool full = kMode == kFull, model = kMode == kModelCost;
  const int lane = threadIdx.x;
  const bool first = lane == 0, last = lane == kStrip - 1;
  const bool writes = !first && !last;  // an own column
  const int HW = g.H * g.W;

  auto fetch = [&](int i, bool in, bool mine, LinRaw& r) {
    if (!in) return;
    const int k = i * g.W + j;
    ld_pair(x, k, pairs, &r.o0, &r.o1);
    if (full || mine) r.ang = __ldg(x + 2 * HW + k);
    ld_pair(ur, k, pairs, &r.u0, &r.u1);
    r.m = __ldg(mask + k);
    if (mine) ld_pair(cons, k, pairs, &r.c0, &r.c1);
    if (model) {
      ld_pair(delta, k, pairs, &r.d0, &r.d1);
      if (mine) r.dA = __ldg(delta + 2 * HW + k);
    }
  };
  auto unpack = [&](const LinRaw& r, bool in, bool mine) {
    LinPix px;
    px.o0 = r.o0, px.o1 = r.o1;
    px.d0 = r.d0, px.d1 = r.d1, px.dA = r.dA;
    px.u0 = r.u0, px.u1 = r.u1;
    px.keep = in && r.m == 0.f;
    px.mine = mine;
    px.sn = px.cs = 0.f;
    if (px.keep && (full || mine)) sincosf(r.ang, &px.sn, &px.cs);
    px.fit = mine && r.c0 >= 0.f && r.c1 >= 0.f;
    px.f0 = px.f1 = 0.f;
    if (px.fit) {
      px.f0 = w_fit * (r.o0 - r.c0);
      px.f1 = w_fit * (r.o1 - r.c1);
      if (model) {
        px.f0 += w_fit * r.d0;
        px.f1 += w_fit * r.d1;
      }
    }
    px.j0 = px.j1 = px.jA = px.gA = px.ssq = 0.f;
    px.nreg = 0;
    return px;
  };

  LinRaw nxt = {};
  bool nin = g.inside(c0 - 1, j);
  fetch(c0 - 1, nin, false, nxt);
  LinPix prev = unpack(nxt, false, false);
  bool pin = false;  // the row before is inside the grid at this column
  float ssq = 0.f;
  for (int i = c0 - 1; i <= c1; ++i) {
    const bool own = i >= c0 && i < c1;
    const bool cin = nin;
    const LinRaw cr = nxt;
    if (i < c1) {
      // the next row's loads, in flight under this row's math
      nin = g.inside(i + 1, j);
      fetch(i + 1, nin, i + 1 < c1 && writes, nxt);
    }
    LinPix cur = unpack(cr, cin, own && writes);
    if (prev.keep && cur.keep) {
      // the H pair: r_{i-1,+H}, then r_{i,-H}
      float r0 = 0.f, r1 = 0.f;
      if (full || prev.mine)
        lin_centre<kMode>(prev, cur.o0, cur.o1, cur.u0, cur.u1, cur.d0,
                          cur.d1, w_reg, &r0, &r1);
      if (full) {
        cur.j0 -= w_reg * r0;
        cur.j1 -= w_reg * r1;
      }
      if (full || cur.mine)
        lin_centre<kMode>(cur, prev.o0, prev.o1, prev.u0, prev.u1, prev.d0,
                          prev.d1, w_reg, &r0, &r1);
      if (full) {
        prev.j0 -= w_reg * r0;
        prev.j1 -= w_reg * r1;
      }
    }
    if (i - 1 >= c0 && pin && writes) {
      // the row before is whole: its cost, then its fit term and output
      if (prev.keep)
        ssq += prev.ssq + (prev.f0 * prev.f0 + prev.f1 * prev.f1);
      if (full) {
        const int ko = ko0 + (i - 1) * g.W + j;
        const float gO = prev.nreg * (w_reg * w_reg) +
                         (prev.fit ? w_fit * w_fit : 0.f);
        st_pair(jtf, ko, pairs, prev.j0 + w_fit * prev.f0,
                prev.j1 + w_fit * prev.f1);
        jtf[2 * No + ko] = prev.jA;
        st_pair(diag, ko, pairs, gO, gO);
        diag[2 * No + ko] = prev.gA;
      }
    }
    if (own) {
      // the W pair.  The right neighbour j + 1 is the next lane's pixel
      // (lane 31 has none in the warp)
      float n0 = __shfl_down_sync(kLanes, cur.o0, 1);
      float n1 = __shfl_down_sync(kLanes, cur.o1, 1);
      float nu0 = __shfl_down_sync(kLanes, cur.u0, 1);
      float nu1 = __shfl_down_sync(kLanes, cur.u1, 1);
      float nd0 = 0.f, nd1 = 0.f;
      if (model) {
        nd0 = __shfl_down_sync(kLanes, cur.d0, 1);
        nd1 = __shfl_down_sync(kLanes, cur.d1, 1);
      }
      bool nk = __shfl_down_sync(kLanes, (int)cur.keep, 1) != 0 && !last;
      float jr0 = 0.f, jr1 = 0.f;
      if (cur.keep && nk && (full || cur.mine))
        lin_centre<kMode>(cur, n0, n1, nu0, nu1, nd0, nd1, w_reg, &jr0,
                          &jr1);
      // the left neighbour j - 1, the lane before's (lane 0 has none)
      n0 = __shfl_up_sync(kLanes, cur.o0, 1);
      n1 = __shfl_up_sync(kLanes, cur.o1, 1);
      nu0 = __shfl_up_sync(kLanes, cur.u0, 1);
      nu1 = __shfl_up_sync(kLanes, cur.u1, 1);
      if (model) {
        nd0 = __shfl_up_sync(kLanes, cur.d0, 1);
        nd1 = __shfl_up_sync(kLanes, cur.d1, 1);
      }
      nk = __shfl_up_sync(kLanes, (int)cur.keep, 1) != 0 && !first;
      float jl0 = 0.f, jl1 = 0.f;
      if (cur.keep && nk && (full || cur.mine))
        lin_centre<kMode>(cur, n0, n1, nu0, nu1, nd0, nd1, w_reg, &jl0,
                          &jl1);
      if (full) {
        // the neighbours' halves: r_{j-1,+W} from the lane before, then
        // r_{j+1,-W} from the next lane
        cur.j0 -= w_reg * __shfl_up_sync(kLanes, jr0, 1);
        cur.j1 -= w_reg * __shfl_up_sync(kLanes, jr1, 1);
        cur.j0 -= w_reg * __shfl_down_sync(kLanes, jl0, 1);
        cur.j1 -= w_reg * __shfl_down_sync(kLanes, jl1, 1);
      }
    }
    prev = cur;
    pin = cin;
  }
  return ssq;
}

// K3 on the row-marching core over S extended slabs (Slabs in
// warp_energy.cuh; a whole grid is one slab with no halo): blockIdx.z is
// the slab, blockIdx.y a chunk of `rows` own rows (a chunk's face rows
// read from the slab's own halo, he >= 1, or past the grid's edge, where
// Grid::inside makes them no neighbour), each warp a strip of kOwn own
// columns; one cost partial a block, slab by slab.  The cost counts the
// residuals centred on own pixels only, so a residual centred in a halo
// row, a face row or a column beside the strip, which its own block
// counts, is counted once.
template <int kMode>
__global__ void __launch_bounds__(kStripThreads)
warp_linearize_kernel(const float* __restrict__ x,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ mask,
                      const float* __restrict__ params,
                      const float* __restrict__ delta,
                      float* __restrict__ jtf, float* __restrict__ diag,
                      float* __restrict__ cost_partials, int W, Slabs sl,
                      int rows, bool pairs) {
  __shared__ float sh[kStripWarps];
  const int sb = blockIdx.z;
  const Grid g = sl.grid(sb, W);
  const int HW = g.H * W;
  const int w0 = (blockIdx.x * kStripWarps + threadIdx.y) * kOwn;
  const int c0 = sl.he + blockIdx.y * rows;
  const int c1 = sl.he + min((int)(blockIdx.y + 1) * rows, sl.n);
  float ssq = 0.f;
  if (w0 < W) {
    const size_t s3 = (size_t)sb * 3 * HW, s2 = (size_t)sb * 2 * HW;
    ssq = warp_linearize_march<kMode>(
        g, c0, c1, w0 - 1 + (int)threadIdx.x, x + s3, ur + s2, cons + s2,
        mask + (size_t)sb * HW, delta != nullptr ? delta + s3 : nullptr, jtf,
        diag, (sb * sl.n - sl.he) * W, sl.S * sl.n * W, params[0],
        params[1], pairs);
  }
  const float s = strip_block_sum(ssq, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) cost_partials[block_rank()] =
      0.5f * s;
}

// K3's chunk of own rows in mode kMode over S slabs of n rows, W columns
// on the current device (one wave of its own occupancy, which differs by
// mode), or minus the CUDA error of the occupancy query
template <int kMode>
int linearize_rows(int S, int n, int W) {
  const int capacity = warp_tile_capacity(warp_linearize_kernel<kMode>);
  return capacity < 0 ? capacity : warp_tile_rows(S, n, W, capacity);
}

template <int kMode>
int linearize_launch(const float* x, const float* ur, const float* cons,
                     const float* mask, const float* params,
                     const float* delta, float* jtf, float* diag,
                     float* cost_partials, int W, Slabs sl, void* stream) {
  const int rows = linearize_rows<kMode>(sl.S, sl.n, W);
  if (rows < 0) return -rows;
  const long slab = 3L * (sl.n + 2 * sl.he) * W;
  warp_linearize_kernel<kMode><<<warp_tile_grid(sl.S, sl.n, W, rows),
                                 dim3(kStrip, kStripWarps), 0,
                                 (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, delta, jtf, diag, cost_partials, W, sl,
      rows, tile_pairs(slab, sl.S, x, ur, cons, delta, jtf, diag));
  return (int)cudaGetLastError();
}

// K3 in `mode` (0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum mask(F + J delta)^2 alone) over the slabs sl
int linearize(const float* x, const float* ur, const float* cons,
              const float* mask, const float* params, const float* delta,
              float* jtf, float* diag, float* cost_partials, int W, Slabs sl,
              int mode, void* stream) {
  return with_mode(mode, (int)cudaErrorInvalidValue, [&](auto m) {
    return linearize_launch<decltype(m)::value>(x, ur, cons, mask, params,
                                                delta, jtf, diag,
                                                cost_partials, W, sl, stream);
  });
}

// K1's chunk of own rows on the current device, or minus the CUDA error
// of the occupancy query
int jtj_apply_rows(int H, int W) {
  const int capacity = warp_tile_capacity(warp_jtj_apply_kernel);
  return capacity < 0 ? capacity : warp_tile_rows(1, H, W, capacity);
}

}  // namespace

extern "C" int opt_warp_blocks(int H, int W) {
  const dim3 gr = warp_grid(H, W);
  return (int)(gr.x * gr.y);
}

// K1's dot partials: one a block of its march (minus the CUDA error where
// the occupancy query fails)
extern "C" int opt_warp_apply_blocks(int H, int W) {
  const int rows = jtj_apply_rows(H, W);
  if (rows < 0) return rows;
  const dim3 gr = warp_tile_grid(1, H, W, rows);
  return (int)(gr.x * gr.y);
}

extern "C" int opt_warp_jtj_apply(const float* x, const float* p,
                                  const float* ur, const float* cons,
                                  const float* mask, const float* params,
                                  const float* ctc, float* ap,
                                  float* partials, int H, int W,
                                  void* stream) {
  const int rows = jtj_apply_rows(H, W);
  if (rows < 0) return -rows;
  warp_jtj_apply_kernel<<<warp_tile_grid(1, H, W, rows),
                          dim3(kStrip, kStripWarps), 0,
                          (cudaStream_t)stream>>>(
      x, p, ur, cons, mask, params, ctc, ap, partials, H, W, rows,
      tile_pairs(0, 1, p, ctc, ur, cons, ap));
  return (int)cudaGetLastError();
}

// K3's cost partials over S slabs of n own rows, W columns, in `mode`:
// one a block of its march (minus the CUDA error where the occupancy query
// fails); a whole grid is S = 1, n = H
extern "C" int opt_warp_linearize_blocks(int S, int n, int W, int mode) {
  return with_mode(mode, -(int)cudaErrorInvalidValue, [&](auto m) {
    const int rows = linearize_rows<decltype(m)::value>(S, n, W);
    if (rows < 0) return rows;
    const dim3 gr = warp_tile_grid(S, n, W, rows);
    return (int)(gr.x * gr.y * gr.z);
  });
}

// mode: 0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum mask(F + J delta)^2 alone.  delta is read only in mode 2, jtf
// and diag written only in mode 0; the cost partials are
// opt_warp_linearize_blocks(1, H, W, mode)
extern "C" int opt_warp_linearize(const float* x, const float* ur,
                                  const float* cons, const float* mask,
                                  const float* params, const float* delta,
                                  float* jtf, float* diag,
                                  float* cost_partials, int H, int W,
                                  int mode, void* stream) {
  return linearize(x, ur, cons, mask, params, delta, jtf, diag,
                   cost_partials, W, Slabs{1, H, 0, 0, H}, mode, stream);
}

// K3's global-offset mode over S extended slabs (Slabs in
// warp_energy.cuh): the arrays hold S slabs of n + 2 he rows, slab s's row
// 0 at global row row0 + s * n of Hg; jtf and diag cover the own rows in
// the local layout, the cost partials (opt_warp_linearize_blocks(S, n, W,
// mode)) come slab by slab
extern "C" int opt_warp_slab_linearize(const float* x, const float* ur,
                                       const float* cons, const float* mask,
                                       const float* params,
                                       const float* delta, float* jtf,
                                       float* diag, float* cost_partials,
                                       int S, int n, int he, int W, int row0,
                                       int Hg, int mode, void* stream) {
  return linearize(x, ur, cons, mask, params, delta, jtf, diag,
                   cost_partials, W, Slabs{S, n, he, row0, Hg}, mode,
                   stream);
}
