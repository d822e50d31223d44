// K4 warp_hat_apply and K5 warp_pipelined_sweep: the image_warping
// energy's PCG sweeps in the Jacobi-scaled ("hat") space, for grids past
// the whole-grid engine's sizes.
//
// Replace the work of the TPU kernels in opt_tpu/ops/stream_solver.py:
//   K4  StreamSolverHBM._build_backend_kernel (classic PCG, three streamed
//       sweeps per iteration): its sweep 1, the apply A_hat p over row
//       windows, with the beta step p = r + beta p_prev fused in
//       (fuse_beta), and LM's scs diagonal;
//   K5  StreamSolverHBM._build_pipelined_kernel (Ghysels-Vanroose
//       pipelined PCG, one sweep per iteration): the whole sweep,
//       n = A_hat w, the five recurrences and the two next dots, and in
//       LM mode the scs diagonal and the per-sweep
//       q = 0.5 <delta, r + b_hat> (the same LM mode as K7's,
//       stream3d_kernels.cu).
// In the hat space A_hat = S (J^T J [+ CtC]) S with S = diag(sq),
// sq = sqrt(pre), M_hat = I, so z == r and no preconditioner is read;
// excluded unknowns have sq = 0, which zeroes their rows and columns
// (stream_solver.py:17-28).  A_hat v = sq . J^T J (sq . v) + scs . v with
// scs = sq^2 . ctc (LM) or absent (GN).
//
// The TPU kernels stream row-tile windows with a halo through VMEM and
// run their tiles in order; here the blocks read their halo straight
// from device memory (L1/L2 serve the overlap) and run in parallel in no
// order.  So no sweep updates in place across a halo: K4 forms
// p = r + beta p_prev at every pixel it reads and writes p to a buffer
// other than p_prev; K5 reads w_in with its halo and writes w_out, the
// two buffers swapping each iteration (the TPU kernel's A/B w slots,
// stream_solver.py:1232-1234).  K5's z, s, p, delta and r are read and
// written only at the thread's own pixel, so they are updated in place.
//
// The cross-block sums (<p, A_hat p> for K4; gamma = <r, r> and
// dd = <w, r> for K5) are per-block partials from a fixed tree, summed by
// the caller: repeated solves match bit for bit.  alpha and beta are read
// from device memory, so the host never waits on the reductions that made
// them.
//
// Bound on the card: device memory.  At 2048^2 a flat vector is 50 MB, so
// nothing stays in the 50 MB L2 between sweeps.  K4 reads the Angle,
// UrShape, Constraints, Mask, sq, r and p_prev (60 B per pixel, 72 B with
// scs) and writes p and A_hat p (24 B): 352.3 MB, 105.2 us at 3.35 TB/s
// (GN with p_prev); K5 reads x, sq, w_in and the constants and reads and
// writes z, s, p, delta, r (about 100 B in, 72 B out per pixel; in LM also
// scs and b_hat, 24 B in).
//
// K4 and K15 run on warp_tile.cuh's row-marching core, as K1 does (a warp
// of 32 lanes marches a strip of 30 own columns down a chunk of rows
// sized to one wave, each pixel's data read once, its sincosf taken once,
// each residual formed once; warp_tile.cuh says what bounded the gather
// form, in which K4 took 210.3 us at 2048^2, 50% of its bound).  K4's Io
// forms the operand sq . (r + beta p_prev) in registers at each pixel the
// lane loads, as K13's L2 form does (resident_kernels.cu), and one kernel
// template a mode (p_prev or not, scs or not) keeps the modes' loads and
// stores out of one another's registers.  K5 keeps the gather form
// (warp_energy.cuh jtj_at, one thread a pixel of a 32x8 block).

#include "warp_energy.cuh"
#include "warp_tile.cuh"

namespace {

// sq . (r + beta p_prev) at a pixel: the gather form's scaled operand
// (K5 reads its w_in so, p_prev null: then beta is taken as 0)
struct HatRead {
  const float* r;
  const float* pprev;
  const float* sq;
  float beta;
  int HW;
  __device__ void operator()(int idx, float* v0, float* v1,
                             float* vA) const {
    const int i0 = 2 * idx, i1 = 2 * idx + 1, iA = 2 * HW + idx;
    if (pprev != nullptr) {
      *v0 = sq[i0] * (r[i0] + beta * pprev[i0]);
      *v1 = sq[i1] * (r[i1] + beta * pprev[i1]);
      *vA = sq[iA] * (r[iA] + beta * pprev[iA]);
    } else {
      *v0 = sq[i0] * r[i0];
      *v1 = sq[i1] * r[i1];
      *vA = sq[iA] * r[iA];
    }
  }
};

// A_hat v at a pixel whose Mask is 0, for v(k) = (vk0, vk1, vkA): K5's
// gather-form apply
__device__ __forceinline__ void hat_apply_at(
    const Grid& g, int i, int j, const float* __restrict__ x,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ mask, const float* __restrict__ params,
    const float* __restrict__ sq, const float* __restrict__ scs,
    const HatRead& read, float vk0, float vk1, float vkA, float* a) {
  const int HW = g.H * g.W;
  const int k = i * g.W + j;
  const int idx[3] = {2 * k, 2 * k + 1, 2 * HW + k};
  const float v[3] = {vk0, vk1, vkA};
  float jv[3];
  jtj_at(g, i, j, x + 2 * HW, ur, cons, mask, params[0], params[1],
         sq[idx[0]] * vk0, sq[idx[1]] * vk1, sq[idx[2]] * vkA, read, &jv[0],
         &jv[1], &jv[2]);
  for (int c = 0; c < 3; ++c) {
    a[c] = sq[idx[c]] * jv[c];
    if (scs != nullptr) a[c] += scs[idx[c]] * v[c];
  }
}

// K4's operand and output on the march: p = r + beta p_prev (kBeta: one
// __fmaf_rn, the same float at every lane that forms it) or p = r,
// v = sq . p; at an own pixel A_hat p = sq . J^T J v (+ scs . p in LM,
// scs read at own pixels only), 0 where masked, and (kBeta) p are
// written, and p . A_hat p is the dot.  Its raw data: sq, r and (kBeta)
// p_prev.  The launch writes none of the arrays it reads (p_out is a
// buffer of its own), so all go through the read-only path.
template <bool kBeta, bool kScs>
struct HatApplyIo {
  static constexpr int kRaw = kBeta ? 9 : 6;
  const float* __restrict__ sq;
  const float* __restrict__ r;
  const float* __restrict__ pp;
  const float* __restrict__ scs;
  float* __restrict__ pn;
  float* __restrict__ ap;
  float beta;
  int W, HW;
  __device__ void fetch(int k, bool, bool pairs, float* raw) const {
    ld_pair(sq, k, pairs, &raw[0], &raw[1]);
    raw[2] = __ldg(sq + 2 * HW + k);
    ld_pair(r, k, pairs, &raw[3], &raw[4]);
    raw[5] = __ldg(r + 2 * HW + k);
    if constexpr (kBeta) {
      ld_pair(pp, k, pairs, &raw[6], &raw[7]);
      raw[8] = __ldg(pp + 2 * HW + k);
    }
  }
  __device__ void operand(const float* raw, Pix& px) const {
    px.x0 = raw[0], px.x1 = raw[1], px.xA = raw[2];
    if constexpr (kBeta) {
      px.y0 = __fmaf_rn(beta, raw[6], raw[3]);
      px.y1 = __fmaf_rn(beta, raw[7], raw[4]);
      px.yA = __fmaf_rn(beta, raw[8], raw[5]);
    } else {
      px.y0 = raw[3], px.y1 = raw[4], px.yA = raw[5];
    }
    px.v0 = px.x0 * px.y0, px.v1 = px.x1 * px.y1, px.vA = px.xA * px.yA;
  }
  __device__ float store(int i, int j, const Pix& px, bool pairs) const {
    const int k = i * W + j;
    float a0 = 0.f, a1 = 0.f, aA = 0.f;
    if (px.keep) {
      a0 = px.x0 * px.a0, a1 = px.x1 * px.a1, aA = px.xA * px.aA;
      if constexpr (kScs) {
        float s0, s1;
        ld_pair(scs, k, pairs, &s0, &s1);
        a0 += s0 * px.y0;
        a1 += s1 * px.y1;
        aA += __ldg(scs + 2 * HW + k) * px.yA;
      }
    }
    st_pair(ap, k, pairs, a0, a1);
    ap[2 * HW + k] = aA;
    if constexpr (kBeta) {
      st_pair(pn, k, pairs, px.y0, px.y1);
      pn[2 * HW + k] = px.yA;
    }
    return px.y0 * a0 + px.y1 * a1 + px.yA * aA;
  }
};

// K4 on the row-marching core: blockIdx.y is a chunk of `rows` own rows
// (hat_apply_rows), each warp a strip of kOwn own columns; one dot
// partial a block.  kBeta: p_prev and beta are given (the classic loop's
// iterations), else the operand is r (a plain A_hat r: the pipelined
// loop's w_0, LM's resets); kScs: LM's scs diagonal
template <bool kBeta, bool kScs>
__global__ void __launch_bounds__(kStripThreads)
warp_hat_apply_kernel(const float* __restrict__ x,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ mask,
                      const float* __restrict__ params,
                      const float* __restrict__ sq,
                      const float* __restrict__ scs,
                      const float* __restrict__ r,
                      const float* __restrict__ pprev,
                      const float* __restrict__ beta_ptr,
                      float* __restrict__ p_out, float* __restrict__ ap,
                      float* __restrict__ partials, int H, int W, int rows,
                      bool pairs) {
  __shared__ float sh[kStripWarps];
  const int w0 = (blockIdx.x * kStripWarps + threadIdx.y) * kOwn;
  const int c0 = blockIdx.y * rows, c1 = min(c0 + rows, H);
  const int HW = H * W;
  float dot = 0.f;
  if (w0 < W) {
    const HatApplyIo<kBeta, kScs> io{sq, r, pprev, scs, p_out, ap,
                                     kBeta ? *beta_ptr : 0.f, W, HW};
    dot = warp_tile_march(Grid{H, W}, c0, c1, w0 - 1 + (int)threadIdx.x,
                          x + 2 * HW, ur, cons, mask, params[0], params[1],
                          pairs, io);
  }
  const float s = strip_block_sum(dot, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
warp_pipelined_sweep_kernel(const float* __restrict__ x,
                            const float* __restrict__ ur,
                            const float* __restrict__ cons,
                            const float* __restrict__ mask,
                            const float* __restrict__ params,
                            const float* __restrict__ sq,
                            const float* __restrict__ scs,
                            const float* __restrict__ b_hat,
                            const float* __restrict__ w_in,
                            float* __restrict__ w_out, float* __restrict__ z,
                            float* __restrict__ s, float* __restrict__ p,
                            float* __restrict__ delta, float* __restrict__ r,
                            const float* __restrict__ alpha_ptr,
                            const float* __restrict__ beta_ptr,
                            float* __restrict__ gamma_partials,
                            float* __restrict__ dd_partials,
                            float* __restrict__ q_partials, int H, int W) {
  __shared__ float sh[kThreads];
  const Grid g{H, W};
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int HW = H * W;
  const float alpha = *alpha_ptr, beta = *beta_ptr;
  const HatRead read{w_in, nullptr, sq, 0.f, HW};
  float gam = 0.f, dd = 0.f, q = 0.f;
  if (g.inside(i, j)) {
    const int k = i * W + j;
    const int idx[3] = {2 * k, 2 * k + 1, 2 * HW + k};
    float wk[3], n[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 3; ++c) wk[c] = w_in[idx[c]];
    if (mask[k] == 0.f)
      hat_apply_at(g, i, j, x, ur, cons, mask, params, sq, scs, read, wk[0],
                   wk[1], wk[2], n);
    for (int c = 0; c < 3; ++c) {
      const int e = idx[c];
      const float zn = n[c] + beta * z[e];
      const float sn = wk[c] + beta * s[e];
      const float pn = r[e] + beta * p[e];
      const float dn = delta[e] + alpha * pn;
      const float rn = r[e] - alpha * sn;
      const float wn = wk[c] - alpha * zn;
      z[e] = zn;
      s[e] = sn;
      p[e] = pn;
      delta[e] = dn;
      r[e] = rn;
      w_out[e] = wn;
      gam += rn * rn;
      dd += wn * rn;
      if (b_hat != nullptr) q += 0.5f * (dn * (rn + b_hat[e]));
    }
  }
  const float gs = block_sum(gam, sh);
  const float ds = block_sum(dd, sh);
  if (thread_rank() == 0) {
    gamma_partials[block_rank()] = gs;
    dd_partials[block_rank()] = ds;
  }
  if (b_hat != nullptr) {
    const float qs = block_sum(q, sh);
    if (thread_rank() == 0) q_partials[block_rank()] = qs;
  }
}

// K15's operand and output: v = sq . p in slab sb's arrays; A_hat p =
// sq . J^T J (sq . p) at an own row, written to the local layout.  Its raw
// data: sq and p.
struct SlabApplyIo {
  static constexpr int kRaw = 6;
  const float* __restrict__ sq;
  const float* __restrict__ p;
  float* __restrict__ ap;
  int W, HW;
  int row_off;  // local row of array row 0: sb n - he
  int No;       // own pixels of all slabs: S n W
  __device__ void fetch(int k, bool, bool pairs, float* r) const {
    ld_pair(sq, k, pairs, &r[0], &r[1]);
    r[2] = __ldg(sq + 2 * HW + k);
    ld_pair(p, k, pairs, &r[3], &r[4]);
    r[5] = __ldg(p + 2 * HW + k);
  }
  __device__ void operand(const float* r, Pix& px) const {
    px.v0 = r[0] * r[3], px.v1 = r[1] * r[4], px.vA = r[2] * r[5];
    px.x0 = r[0], px.x1 = r[1], px.xA = r[2];
  }
  __device__ float store(int i, int j, const Pix& px, bool pairs) const {
    const int ko = (row_off + i) * W + j;
    float a0 = 0.f, a1 = 0.f, aA = 0.f;
    if (px.keep) a0 = px.x0 * px.a0, a1 = px.x1 * px.a1, aA = px.xA * px.aA;
    st_pair(ap, ko, pairs, a0, a1);
    ap[2 * No + ko] = aA;
    return 0.f;
  }
};

// K15: A_hat p = sq . J^T J (sq . p) at the own rows of S extended slabs
// (Slabs in warp_energy.cuh), on the row-marching core: blockIdx.z is the
// slab, blockIdx.y a chunk of `rows` own rows, the chunk's face rows read
// from the slab's own halo (he >= 1).  K4's apply without the beta step,
// scs or the dot: the slab loop adds scs . p and takes the dots outside
// (opt_tpu/parallel/stream_shard.py:313-329).
__global__ void __launch_bounds__(kStripThreads)
warp_slab_apply_kernel(const float* __restrict__ x,
                       const float* __restrict__ ur,
                       const float* __restrict__ cons,
                       const float* __restrict__ mask,
                       const float* __restrict__ params,
                       const float* __restrict__ sq,
                       const float* __restrict__ p, float* __restrict__ ap,
                       int W, Slabs sl, int rows, bool pairs) {
  const int sb = blockIdx.z;
  const int w0 = (blockIdx.x * kStripWarps + threadIdx.y) * kOwn;
  if (w0 >= W) return;
  const Grid g = sl.grid(sb, W);
  const int HW = g.H * W;
  const int ch = blockIdx.y;
  const int c0 = sl.he + ch * rows;
  const int c1 = sl.he + min((ch + 1) * rows, sl.n);
  // this slab's arrays
  const size_t s3 = (size_t)sb * 3 * HW, s2 = (size_t)sb * 2 * HW;
  const SlabApplyIo io{sq + s3, p + s3, ap, W, HW, sb * sl.n - sl.he,
                       sl.S * sl.n * W};
  warp_tile_march(g, c0, c1, w0 - 1 + (int)threadIdx.x, x + s3 + 2 * HW,
                  ur + s2, cons + s2, mask + (size_t)sb * HW, params[0],
                  params[1], pairs, io);
}

// K4's chunk of own rows on the current device: one wave of the fewest
// blocks any of its four modes holds at once, so that the modes share one
// grid and one partial count (minus the CUDA error of an occupancy query)
int hat_apply_rows(int H, int W) {
  int capacity = INT_MAX;
  for (const int c : {warp_tile_capacity(warp_hat_apply_kernel<true, false>),
                      warp_tile_capacity(warp_hat_apply_kernel<true, true>),
                      warp_tile_capacity(warp_hat_apply_kernel<false, false>),
                      warp_tile_capacity(warp_hat_apply_kernel<false, true>)}) {
    if (c < 0) return c;
    capacity = std::min(capacity, c);
  }
  return warp_tile_rows(1, H, W, capacity);
}

}  // namespace

// K4's dot partials: one a block of its march (minus the CUDA error where
// the occupancy query fails)
extern "C" int opt_warp_hat_apply_blocks(int H, int W) {
  const int rows = hat_apply_rows(H, W);
  if (rows < 0) return rows;
  const dim3 gr = warp_tile_grid(1, H, W, rows);
  return (int)(gr.x * gr.y);
}

// pprev, beta and p_out come together or not at all: without them the
// operand is r itself (a plain A_hat r, for the LM reset and the
// pipelined w_0); scs is null for GN.  The partials are
// opt_warp_hat_apply_blocks(H, W)
extern "C" int opt_warp_hat_apply(const float* x, const float* ur,
                                  const float* cons, const float* mask,
                                  const float* params, const float* sq,
                                  const float* scs, const float* r,
                                  const float* pprev, const float* beta,
                                  float* p_out, float* ap, float* partials,
                                  int H, int W, void* stream) {
  const bool prev = pprev != nullptr;
  if (prev != (beta != nullptr) || prev != (p_out != nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = hat_apply_rows(H, W);
  if (rows < 0) return -rows;
  const bool pairs = tile_pairs(0, 1, sq, scs, r, pprev, p_out, ap, ur, cons);
  auto launch = [&](auto kernel) {
    kernel<<<warp_tile_grid(1, H, W, rows), dim3(kStrip, kStripWarps), 0,
             (cudaStream_t)stream>>>(x, ur, cons, mask, params, sq, scs, r,
                                     pprev, beta, p_out, ap, partials, H, W,
                                     rows, pairs);
    return (int)cudaGetLastError();
  };
  if (prev)
    return scs != nullptr ? launch(warp_hat_apply_kernel<true, true>)
                          : launch(warp_hat_apply_kernel<true, false>);
  return scs != nullptr ? launch(warp_hat_apply_kernel<false, true>)
                        : launch(warp_hat_apply_kernel<false, false>);
}

// scs is null for GN; b_hat and q_partials are null together outside LM
extern "C" int opt_warp_pipelined_sweep(
    const float* x, const float* ur, const float* cons, const float* mask,
    const float* params, const float* sq, const float* scs,
    const float* b_hat, const float* w_in, float* w_out, float* z, float* s,
    float* p, float* delta, float* r, const float* alpha, const float* beta,
    float* gamma_partials, float* dd_partials, float* q_partials, int H,
    int W, void* stream) {
  warp_pipelined_sweep_kernel<<<warp_grid(H, W), dim3(kBX, kBY), 0,
                                (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, sq, scs, b_hat, w_in, w_out, z, s, p, delta,
      r, alpha, beta, gamma_partials, dd_partials, q_partials, H, W);
  return (int)cudaGetLastError();
}

// K15: the arrays hold S extended slabs of n + 2 he rows, slab s's row 0
// at global row row0 + s * n of Hg; ap covers the own rows in the local
// layout
extern "C" int opt_warp_slab_apply(const float* x, const float* ur,
                                   const float* cons, const float* mask,
                                   const float* params, const float* sq,
                                   const float* p, float* ap, int S, int n,
                                   int he, int W, int row0, int Hg,
                                   void* stream) {
  const int capacity = warp_tile_capacity(warp_slab_apply_kernel);
  if (capacity < 0) return -capacity;
  const int rows = warp_tile_rows(S, n, W, capacity);
  const long slab = 3L * (n + 2 * he) * W;
  warp_slab_apply_kernel<<<warp_tile_grid(S, n, W, rows),
                           dim3(kStrip, kStripWarps), 0,
                           (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, sq, p, ap, W, Slabs{S, n, he, row0, Hg},
      rows, tile_pairs(slab, S, sq, p, ur, cons, ap));
  return (int)cudaGetLastError();
}
