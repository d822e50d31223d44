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
// scs = sq^2 . ctc (LM) or absent (GN); J^T J is warp_energy.cuh's jtj_at.
//
// The TPU kernels stream row-tile windows with a halo through VMEM and
// run their tiles in order; here every block of 32x8 pixels reads its
// one-pixel halo straight from device memory (L1/L2 serve the overlap),
// and the blocks run in parallel in no order.  So no sweep updates in
// place across a halo: K4 forms p = r + beta p_prev at the centre and at
// the neighbours it reads, and writes p to a buffer other than p_prev;
// K5 reads w_in with its halo and writes w_out, the two buffers swapping
// each iteration (the TPU kernel's A/B w slots, stream_solver.py:
// 1232-1234).  K5's z, s, p, delta and r are read and written only at the
// thread's own pixel, so they are updated in place.
//
// The cross-block sums (<p, A_hat p> for K4; gamma = <r, r> and
// dd = <w, r> for K5) are per-block partials from a fixed shared-memory
// tree, summed by the caller: repeated solves match bit for bit.  alpha
// and beta are read from device memory, so the host never waits on the
// reductions that made them.
//
// Bound on the card: device memory.  At 2048^2 a flat vector is 50 MB, so
// nothing stays in the 50 MB L2 between sweeps.  K4 reads x, sq, r, p_prev
// and the constants (about 60 B per pixel, 72 B with scs) and writes p and
// A_hat p (24 B); K5 reads x, sq, w_in and the constants and reads and
// writes z, s, p, delta, r (about 100 B in, 72 B out per pixel; in LM
// also scs and b_hat, 24 B in).  One thread per pixel with neighbour reads from L1/L2 keeps each vector to one
// pass per sweep; the operand formed at a neighbour costs a few extra
// flops, not extra passes.

#include "warp_energy.cuh"

namespace {

// sq . (r + beta p_prev) at a pixel: K4's scaled operand (p_prev may be
// null: then beta is taken as 0)
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

// A_hat v at a pixel whose Mask is 0, for v(k) = (vk0, vk1, vkA)
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

__global__ void __launch_bounds__(kThreads)
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
                      float* __restrict__ partials, int H, int W) {
  __shared__ float sh[kThreads];
  const Grid g{H, W};
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int HW = H * W;
  const float beta = pprev != nullptr ? *beta_ptr : 0.f;
  const HatRead read{r, pprev, sq, beta, HW};
  float dot = 0.f;
  if (g.inside(i, j)) {
    const int k = i * W + j;
    const int idx[3] = {2 * k, 2 * k + 1, 2 * HW + k};
    float pk[3], a[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 3; ++c)
      pk[c] = pprev != nullptr ? r[idx[c]] + beta * pprev[idx[c]]
                               : r[idx[c]];
    if (mask[k] == 0.f) {
      hat_apply_at(g, i, j, x, ur, cons, mask, params, sq, scs, read, pk[0],
                   pk[1], pk[2], a);
      dot = pk[0] * a[0] + pk[1] * a[1] + pk[2] * a[2];
    }
    for (int c = 0; c < 3; ++c) {
      if (p_out != nullptr) p_out[idx[c]] = pk[c];
      ap[idx[c]] = a[c];
    }
  }
  const float s = block_sum(dot, sh);
  if (thread_rank() == 0) partials[block_rank()] = s;
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

// K15: A_hat p = sq . J^T J (sq . p) at the own rows of S extended slabs,
// one slab per blockIdx.z (Slabs in warp_energy.cuh).  K4's apply without
// the beta step, scs or the dot: the slab loop adds scs . p and takes the
// dots outside (opt_tpu/parallel/stream_shard.py:313-329).
__global__ void __launch_bounds__(kThreads)
warp_slab_apply_kernel(const float* __restrict__ x,
                       const float* __restrict__ ur,
                       const float* __restrict__ cons,
                       const float* __restrict__ mask,
                       const float* __restrict__ params,
                       const float* __restrict__ sq,
                       const float* __restrict__ p, float* __restrict__ ap,
                       int W, Slabs sl) {
  const int sb = blockIdx.z;
  const Grid g = sl.grid(sb, W);
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int ic = blockIdx.y * kBY + threadIdx.y;
  if (ic >= sl.n || j >= W) return;
  const int HW = g.H * W;
  // this slab's arrays
  const float* xs = x + (size_t)sb * 3 * HW;
  const float* urs = ur + (size_t)sb * 2 * HW;
  const float* cs = cons + (size_t)sb * 2 * HW;
  const float* ms = mask + (size_t)sb * HW;
  const float* sqs = sq + (size_t)sb * 3 * HW;
  const float* ps = p + (size_t)sb * 3 * HW;
  const int i = sl.he + ic;
  const int k = i * W + j;
  float a[3] = {0.f, 0.f, 0.f};
  if (ms[k] == 0.f)
    hat_apply_at(g, i, j, xs, urs, cs, ms, params, sqs, nullptr,
                 HatRead{ps, nullptr, sqs, 0.f, HW}, ps[2 * k],
                 ps[2 * k + 1], ps[2 * HW + k], a);
  // the own pixel in the local layout
  const int ko = (sb * sl.n + ic) * W + j;
  const int No = sl.S * sl.n * W;
  ap[2 * ko] = a[0];
  ap[2 * ko + 1] = a[1];
  ap[2 * No + ko] = a[2];
}

}  // namespace

// p_out, pprev, beta and scs may be null: with pprev null the operand is r
// itself (a plain A_hat r, for the LM reset and the pipelined w_0), and
// with p_out null it is not written back
extern "C" int opt_warp_hat_apply(const float* x, const float* ur,
                                  const float* cons, const float* mask,
                                  const float* params, const float* sq,
                                  const float* scs, const float* r,
                                  const float* pprev, const float* beta,
                                  float* p_out, float* ap, float* partials,
                                  int H, int W, void* stream) {
  warp_hat_apply_kernel<<<warp_grid(H, W), dim3(kBX, kBY), 0,
                          (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, sq, scs, r, pprev, beta, p_out, ap,
      partials, H, W);
  return (int)cudaGetLastError();
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
  warp_slab_apply_kernel<<<warp_grid(n, W, S), dim3(kBX, kBY), 0,
                           (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, sq, p, ap, W, Slabs{S, n, he, row0, Hg});
  return (int)cudaGetLastError();
}
