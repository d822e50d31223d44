// K6 vol_hat_apply and K7 vol_pipelined_sweep: the volumetric ARAP
// energy's PCG sweeps in the Jacobi-scaled ("hat") space.
//
// Replace the work of the TPU kernels in opt_tpu/ops/stream3d.py:
//   K6  StreamSolver3D._build_classic_kernel (classic PCG, three streamed
//       sweeps per iteration over (D, H) tiles): its sweep A, the apply
//       A_hat p, with its sweep C's p = r + beta p_prev fused in, and LM's
//       scs diagonal.  With p_prev absent it is the plain A_hat r: the
//       pipelined kernel's w_0 sweep and the LM resets (stream3d.py
//       :714-793) use it so;
//   K7  StreamSolver3D._build_pipelined_kernel (Ghysels-Vanroose pipelined
//       PCG, one sweep per iteration): n = A_hat w, the five recurrences,
//       the next gamma = <r, r> and dd = <w, r>, and in LM mode the scs
//       diagonal and the per-sweep q = 0.5 <delta, r + b_hat>
//       (stream3d.py:414-419, :764-804).
// In the hat space A_hat = S (J^T J [+ CtC]) S with S = diag(sq),
// sq = sqrt(pre), M_hat = I, so z == r and no preconditioner is read
// (stream3d.py:51-54).  A_hat v = sq . J^T J (sq . v) + scs . v with
// scs = sq^2 . ctc (LM) or absent (GN).
//
// The TPU kernels stream (D, H) tile windows with a halo through VMEM, on
// extents padded to (8, 128), and run their tiles in order; here the
// blocks run in parallel in no order, on the unpadded extents.  So no
// sweep updates in place across a halo: K6 writes p to a buffer other than
// p_prev; K7 reads w_in with its halo and writes w_out, the two swapping
// each iteration (the TPU kernel's A/B w slots).  K7's z, s, p, delta and
// r are read and written only at the thread's own voxel, so they are
// updated in place.
//
// K6 (and K16 below) run on vol_tile.cuh's shared-memory core: a block
// marches a 32 (W) x 8 (H) tile along D, reads each plane once, takes each
// voxel's sincosf once and forms each residual once (the source note there
// says what bounded the gather form and what the core does about it).  K7 keeps vol_energy.cuh's gather form, vol_jtj_at: one thread a
// voxel of a 32 x 8 block of one D plane, its one-voxel halo read in place
// from device memory (L1/L2 serve the overlap), the InBounds guards as the
// zero fill, the operand formed at each neighbour it reads.
//
// The cross-block sums are per-block partials from a fixed shared-memory
// tree, summed by the caller: repeated solves match bit for bit.  alpha and
// beta are read from device memory, so the host never waits on the
// reductions that made them.
//
// Bound on the card: device memory.  At 128^3 a flat vector is 50 MB, so
// nothing stays in the 50 MB L2 between sweeps.  K6 reads the angles,
// UrShape and Constraints' channel 0 (28 B per voxel: the applies test
// only it), sq, r, p_prev (72 B) and, in LM, scs (24 B), and writes p and
// A_hat p (48 B): 148-172 B per voxel, 310-361 MB, 93-108 us at
// 3.35 TB/s.  K7 reads the same 28 B, sq and w_in (48 B), reads and
// writes z, s, p, delta, r (240 B), writes w_out (24 B), and in LM reads
// scs and b_hat (48 B): 340-388 B per voxel, 713-814 MB, 213-243 us.

#include "vol_tile.cuh"

namespace {

// sq . w at a voxel: K7's operand at the neighbours vol_jtj_at reads
struct VolHatRead {
  const float* w;
  const float* sq;
  int N;
  __device__ void operator()(int k, float vO[3], float vA[3]) const {
    for (int c = 0; c < 3; ++c) {
      const int iO = 3 * k + c, iA = 3 * N + 3 * k + c;
      vO[c] = sq[iO] * w[iO];
      vA[c] = sq[iA] * w[iA];
    }
  }
};

// the six flat indices of voxel k's unknowns: Offset, then Angle
__device__ __forceinline__ void unknown_idx(int k, int N, int idx[6]) {
  for (int c = 0; c < 3; ++c) {
    idx[c] = 3 * k + c;
    idx[3 + c] = 3 * N + 3 * k + c;
  }
}

// a = A_hat v at voxel (d, h, w), for v(k) given in the six unknowns
__device__ __forceinline__ void vol_hat_at(
    const Vol& g, int d, int h, int w, const float* __restrict__ x,
    const float* __restrict__ ur, const float* __restrict__ cons,
    const float* __restrict__ params, const float* __restrict__ sq,
    const float* __restrict__ scs, const VolHatRead& read, const int idx[6],
    const float v[6], float a[6]) {
  float sv[6], jv[6];
  for (int c = 0; c < 6; ++c) sv[c] = sq[idx[c]] * v[c];
  vol_jtj_at(g, d, h, w, x + 3 * g.n(), ur, cons, params[0], params[1], sv,
             sv + 3, read, jv, jv + 3);
  for (int c = 0; c < 6; ++c) {
    a[c] = sq[idx[c]] * jv[c];
    if (scs != nullptr) a[c] += scs[idx[c]] * v[c];
  }
}

// K6's operand and output: v = r + beta p_prev (r alone with p_prev
// null), a = sq . J^T J (sq . v) + scs . v, p_out = v, and <v, a>.  Its
// raw data: r, p_prev and sq.
struct HatIo {
  static constexpr int kVecs = 3;
  const float* __restrict__ r;
  const float* __restrict__ pprev;
  const float* __restrict__ sq;
  const float* __restrict__ scs;
  float* __restrict__ p_out;
  float* __restrict__ ap;
  float beta;
  int N;
  __device__ void fetch(int k, float* dst, int stride) const {
    int idx[6];
    unknown_idx(k, N, idx);
    for (int c = 0; c < 6; ++c) {
      tile_copy(dst, c, stride, r, idx[c]);
      if (pprev != nullptr) tile_copy(dst, 6 + c, stride, pprev, idx[c]);
      tile_copy(dst, 12 + c, stride, sq, idx[c]);
    }
  }
  __device__ void operand(const float* src, int stride, float v[6],
                          float s[6]) const {
    for (int c = 0; c < 6; ++c) {
      v[c] = pprev != nullptr
                 ? src[c * stride] + beta * src[(6 + c) * stride]
                 : src[c * stride];
      s[c] = src[(12 + c) * stride];
    }
  }
  __device__ float store(int, int, int, int k, const float jtj[6],
                         const float v[6], const float s[6]) const {
    int idx[6];
    unknown_idx(k, N, idx);
    float dot = 0.f;
    for (int c = 0; c < 6; ++c) {
      float a = s[c] * jtj[c];
      if (scs != nullptr) a += scs[idx[c]] * v[c];
      dot += v[c] * a;
      if (p_out != nullptr) p_out[idx[c]] = v[c];
      ap[idx[c]] = a;
    }
    return dot;
  }
};

// K6 on the tile core (vol_tile.cuh): blockIdx.z is a chunk of kTileD
// planes
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
vol_hat_apply_kernel(const float* __restrict__ x,
                     const float* __restrict__ ur,
                     const float* __restrict__ cons,
                     const float* __restrict__ params,
                     const float* __restrict__ sq,
                     const float* __restrict__ scs,
                     const float* __restrict__ r,
                     const float* __restrict__ pprev,
                     const float* __restrict__ beta_ptr,
                     float* __restrict__ p_out, float* __restrict__ ap,
                     float* __restrict__ partials, int D, int H, int W) {
  __shared__ float sh[kTileThreads];
  const Vol g{D, H, W};
  const int N = g.n();
  const int c0 = blockIdx.z * kTileD, c1 = min(c0 + kTileD, D);
  const HatIo io{r, pprev, sq, scs, p_out, ap,
                 pprev != nullptr ? *beta_ptr : 0.f, N};
  const float dot = vol_tile_march(g, c0, c1, x + 3 * N, ur, cons,
                                   params[0], params[1], io);
  const float s = vblock_sum<kTileThreads>(dot, sh);
  if (vthread_rank() == 0) partials[vblock_rank()] = s;
}

__global__ void __launch_bounds__(kVThreads)
vol_pipelined_sweep_kernel(const float* __restrict__ x,
                           const float* __restrict__ ur,
                           const float* __restrict__ cons,
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
                           float* __restrict__ q_partials, int D, int H,
                           int W) {
  __shared__ float sh[kVThreads];
  const Vol g{D, H, W};
  const int w = blockIdx.x * kVX + threadIdx.x;
  const int h = blockIdx.y * kVY + threadIdx.y;
  const int d = blockIdx.z;
  const int N = g.n();
  const float alpha = *alpha_ptr, beta = *beta_ptr;
  const VolHatRead read{w_in, sq, N};
  float gam = 0.f, dd = 0.f, q = 0.f;
  if (g.inside(d, h, w)) {
    int idx[6];
    unknown_idx(g.idx(d, h, w), N, idx);
    float wk[6], n[6];
    for (int c = 0; c < 6; ++c) wk[c] = w_in[idx[c]];
    vol_hat_at(g, d, h, w, x, ur, cons, params, sq, scs, read, idx, wk, n);
    for (int c = 0; c < 6; ++c) {
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
  const float gs = vblock_sum(gam, sh);
  const float ds = vblock_sum(dd, sh);
  if (vthread_rank() == 0) {
    gamma_partials[vblock_rank()] = gs;
    dd_partials[vblock_rank()] = ds;
  }
  if (b_hat != nullptr) {
    const float qs = vblock_sum(q, sh);
    if (vthread_rank() == 0) q_partials[vblock_rank()] = qs;
  }
}

// K16's operand and output: v = p in slab sb's arrays, a = sq . J^T J
// (sq . p) at an own plane, written to the local layout.  Its raw data: p
// and sq.
struct SlabIo {
  static constexpr int kVecs = 2;
  const float* __restrict__ p;
  const float* __restrict__ sq;
  float* __restrict__ ap;
  int N, sb, he, n, S, H, W;
  __device__ void fetch(int k, float* dst, int stride) const {
    int idx[6];
    unknown_idx(k, N, idx);
    for (int c = 0; c < 6; ++c) {
      tile_copy(dst, c, stride, p, idx[c]);
      tile_copy(dst, 6 + c, stride, sq, idx[c]);
    }
  }
  __device__ void operand(const float* src, int stride, float v[6],
                          float s[6]) const {
    for (int c = 0; c < 6; ++c) {
      v[c] = src[c * stride];
      s[c] = src[(6 + c) * stride];
    }
  }
  __device__ float store(int d, int h, int w, int, const float jtj[6],
                         const float[6], const float s[6]) const {
    const int ko = ((sb * n + d - he) * H + h) * W + w;
    const int No = S * n * H * W;
    for (int c = 0; c < 3; ++c) {
      ap[3 * ko + c] = s[c] * jtj[c];
      ap[3 * No + 3 * ko + c] = s[3 + c] * jtj[3 + c];
    }
    return 0.f;
  }
};

// K16: A_hat p = sq . J^T J (sq . p) at the own planes of S extended D
// slabs (VolSlabs in vol_energy.cuh), on the tile core: blockIdx.z =
// slab * chunks + chunk of kTileD own planes, the chunk's face planes read
// from the slab's own halo (he >= 1).  K6's apply without the beta step,
// scs or the dot: the slab loop adds scs . p and takes the dots outside
// (opt_tpu/parallel/stream_shard.py:762-776).
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
vol_slab_apply_kernel(const float* __restrict__ x,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ params,
                      const float* __restrict__ sq,
                      const float* __restrict__ p, float* __restrict__ ap,
                      int H, int W, VolSlabs sl) {
  const int chunks = (sl.n + kTileD - 1) / kTileD;
  const int sb = blockIdx.z / chunks, ch = blockIdx.z % chunks;
  const Vol g = sl.vol(sb, H, W);
  const int N = g.n();
  const int c0 = sl.he + ch * kTileD;
  const int c1 = sl.he + min((ch + 1) * kTileD, sl.n);
  const float* xs = x + (size_t)sb * 6 * N;
  const SlabIo io{p + (size_t)sb * 6 * N, sq + (size_t)sb * 6 * N, ap, N,
                  sb, sl.he, sl.n, sl.S, H, W};
  vol_tile_march(g, c0, c1, xs + 3 * N, ur + (size_t)sb * 3 * N,
                 cons + (size_t)sb * 3 * N, params[0], params[1], io);
}

}  // namespace

// p_out, pprev, beta and scs may be null: with pprev null the operand is r
// itself (a plain A_hat r, for the pipelined w_0 and the LM resets), and
// with p_out null it is not written back
extern "C" int opt_vol_hat_apply(const float* x, const float* ur,
                                 const float* cons, const float* params,
                                 const float* sq, const float* scs,
                                 const float* r, const float* pprev,
                                 const float* beta, float* p_out, float* ap,
                                 float* partials, int D, int H, int W,
                                 void* stream) {
  constexpr size_t smem = vol_tile_smem<HatIo>();
  const cudaError_t err = vol_tile_prepare(vol_hat_apply_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  vol_hat_apply_kernel<<<vol_tile_grid(1, D, H, W), dim3(kTileW, kTileH),
                         smem, (cudaStream_t)stream>>>(
      x, ur, cons, params, sq, scs, r, pprev, beta, p_out, ap, partials, D,
      H, W);
  return (int)cudaGetLastError();
}

// K6's dot partials: one a block of its grid
extern "C" int opt_vol_hat_blocks(int D, int H, int W) {
  const dim3 gr = vol_tile_grid(1, D, H, W);
  return (int)(gr.x * gr.y * gr.z);
}

// scs is null for GN; b_hat and q_partials are null together outside LM
extern "C" int opt_vol_pipelined_sweep(
    const float* x, const float* ur, const float* cons, const float* params,
    const float* sq, const float* scs, const float* b_hat, const float* w_in,
    float* w_out, float* z, float* s, float* p, float* delta, float* r,
    const float* alpha, const float* beta, float* gamma_partials,
    float* dd_partials, float* q_partials, int D, int H, int W,
    void* stream) {
  vol_pipelined_sweep_kernel<<<vol_grid(D, H, W), dim3(kVX, kVY), 0,
                               (cudaStream_t)stream>>>(
      x, ur, cons, params, sq, scs, b_hat, w_in, w_out, z, s, p, delta, r,
      alpha, beta, gamma_partials, dd_partials, q_partials, D, H, W);
  return (int)cudaGetLastError();
}

// K16: the arrays hold S extended D slabs of n + 2 he planes, slab s's
// plane 0 at global plane d0 + s * n of Dg; ap covers the own planes in
// the local layout
extern "C" int opt_vol_slab_apply(const float* x, const float* ur,
                                  const float* cons, const float* params,
                                  const float* sq, const float* p, float* ap,
                                  int S, int n, int he, int H, int W, int d0,
                                  int Dg, void* stream) {
  constexpr size_t smem = vol_tile_smem<SlabIo>();
  const cudaError_t err = vol_tile_prepare(vol_slab_apply_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  vol_slab_apply_kernel<<<vol_tile_grid(S, n, H, W), dim3(kTileW, kTileH),
                          smem, (cudaStream_t)stream>>>(
      x, ur, cons, params, sq, p, ap, H, W, VolSlabs{S, n, he, d0, Dg});
  return (int)cudaGetLastError();
}
