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
// scs = sq^2 . ctc (LM) or absent (GN); J^T J is vol_energy.cuh's
// vol_jtj_at.
//
// The TPU kernels stream (D, H) tile windows with a halo through VMEM, on
// extents padded to (8, 128), and run their tiles in order; here every
// block of 32 (W) x 8 (H) voxels of one D plane reads its one-voxel halo
// in place from device memory (L1/L2 serve the overlap), on the unpadded
// extents, with the InBounds guards as the zero fill, and the blocks run
// in parallel in no order.  So no sweep updates in place across a halo: K6
// forms p = r + beta p_prev at the centre and at the six neighbours it
// reads, and writes p to a buffer other than p_prev; K7 reads w_in with its
// halo and writes w_out, the two swapping each iteration (the TPU kernel's
// A/B w slots).  K7's z, s, p, delta and r are read and written only at
// the thread's own voxel, so they are updated in place.
//
// The cross-block sums are per-block partials from a fixed shared-memory
// tree, summed by the caller: repeated solves match bit for bit.  alpha and
// beta are read from device memory, so the host never waits on the
// reductions that made them.
//
// Bound on the card: device memory.  At 128^3 a flat vector is 50 MB, so
// nothing stays in the 50 MB L2 between sweeps.  K6 reads the angles,
// UrShape, Constraints (36 B per voxel), sq, r, p_prev (72 B) and, in LM,
// scs (24 B), and writes p and A_hat p (48 B): 156-180 B per voxel,
// 327-377 MB, 98-113 us at 3.35 TB/s.  K7 reads the angles and constants
// (36 B), sq and w_in (48 B), reads and writes z, s, p, delta, r (240 B),
// writes w_out (24 B), and in LM reads scs and b_hat (48 B): 348-396 B per
// voxel, 730-830 MB, 218-248 us.  One thread per voxel keeps each vector
// to one pass per sweep; the operand formed at a neighbour costs a few
// extra flops and sincosf, not extra passes.

#include "vol_energy.cuh"

namespace {

// sq . (r + beta p_prev) at a voxel (p_prev may be null: then beta is
// taken as 0)
struct VolHatRead {
  const float* r;
  const float* pprev;
  const float* sq;
  float beta;
  int N;
  __device__ void operator()(int k, float vO[3], float vA[3]) const {
    for (int c = 0; c < 3; ++c) {
      const int iO = 3 * k + c, iA = 3 * N + 3 * k + c;
      if (pprev != nullptr) {
        vO[c] = sq[iO] * (r[iO] + beta * pprev[iO]);
        vA[c] = sq[iA] * (r[iA] + beta * pprev[iA]);
      } else {
        vO[c] = sq[iO] * r[iO];
        vA[c] = sq[iA] * r[iA];
      }
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

__global__ void __launch_bounds__(kVThreads)
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
  __shared__ float sh[kVThreads];
  const Vol g{D, H, W};
  const int w = blockIdx.x * kVX + threadIdx.x;
  const int h = blockIdx.y * kVY + threadIdx.y;
  const int d = blockIdx.z;
  const int N = g.n();
  const float beta = pprev != nullptr ? *beta_ptr : 0.f;
  const VolHatRead read{r, pprev, sq, beta, N};
  float dot = 0.f;
  if (g.inside(d, h, w)) {
    int idx[6];
    unknown_idx(g.idx(d, h, w), N, idx);
    float pk[6], a[6];
    for (int c = 0; c < 6; ++c)
      pk[c] = pprev != nullptr ? r[idx[c]] + beta * pprev[idx[c]]
                               : r[idx[c]];
    vol_hat_at(g, d, h, w, x, ur, cons, params, sq, scs, read, idx, pk, a);
    for (int c = 0; c < 6; ++c) {
      dot += pk[c] * a[c];
      if (p_out != nullptr) p_out[idx[c]] = pk[c];
      ap[idx[c]] = a[c];
    }
  }
  const float s = vblock_sum(dot, sh);
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
  const VolHatRead read{w_in, nullptr, sq, 0.f, N};
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

// K16: A_hat p = sq . J^T J (sq . p) at the own planes of S extended D
// slabs (VolSlabs in vol_energy.cuh; blockIdx.z = slab * n + own plane).
// K6's apply without the beta step, scs or the dot: the slab loop adds
// scs . p and takes the dots outside (opt_tpu/parallel/stream_shard.py:
// 762-776).
__global__ void __launch_bounds__(kVThreads)
vol_slab_apply_kernel(const float* __restrict__ x,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ params,
                      const float* __restrict__ sq,
                      const float* __restrict__ p, float* __restrict__ ap,
                      int H, int W, VolSlabs sl) {
  const int sb = blockIdx.z / sl.n, dc = blockIdx.z % sl.n;
  const Vol g = sl.vol(sb, H, W);
  const int w = blockIdx.x * kVX + threadIdx.x;
  const int h = blockIdx.y * kVY + threadIdx.y;
  if (h >= H || w >= W) return;
  const int N = g.n();
  // this slab's arrays
  const float* xs = x + (size_t)sb * 6 * N;
  const float* urs = ur + (size_t)sb * 3 * N;
  const float* cs = cons + (size_t)sb * 3 * N;
  const float* sqs = sq + (size_t)sb * 6 * N;
  const float* ps = p + (size_t)sb * 6 * N;
  const int d = sl.he + dc;
  int idx[6];
  unknown_idx(g.idx(d, h, w), N, idx);
  float pk[6], a[6];
  for (int c = 0; c < 6; ++c) pk[c] = ps[idx[c]];
  vol_hat_at(g, d, h, w, xs, urs, cs, params, sqs, nullptr,
             VolHatRead{ps, nullptr, sqs, 0.f, N}, idx, pk, a);
  // the own voxel in the local layout
  const int ko = ((sb * sl.n + dc) * H + h) * W + w;
  const int No = sl.S * sl.n * H * W;
  for (int c = 0; c < 3; ++c) {
    ap[3 * ko + c] = a[c];
    ap[3 * No + 3 * ko + c] = a[3 + c];
  }
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
  vol_hat_apply_kernel<<<vol_grid(D, H, W), dim3(kVX, kVY), 0,
                         (cudaStream_t)stream>>>(
      x, ur, cons, params, sq, scs, r, pprev, beta, p_out, ap, partials, D,
      H, W);
  return (int)cudaGetLastError();
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
  vol_slab_apply_kernel<<<vol_grid(S * n, H, W), dim3(kVX, kVY), 0,
                          (cudaStream_t)stream>>>(
      x, ur, cons, params, sq, p, ap, H, W, VolSlabs{S, n, he, d0, Dg});
  return (int)cudaGetLastError();
}
