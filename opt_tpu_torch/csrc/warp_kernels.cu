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
// states the energy and holds the J^T J apply shared with K4 and K5.
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
// which sits in the 50 MB L2 across PCG iterations.  K3 reads x and the
// constants (36 B, 48 B with delta) and writes J^T F and diag (24 B).  The
// neighbour reads are served by L1/L2 (a 32x8 block touches a 34x10
// footprint), so the design is one thread per pixel in 32x8 blocks with x
// on the contiguous W axis and no shared-memory staging; the ~40 flops per
// pixel leave the kernels memory-bound.  Sums across blocks are per-block
// partials from a fixed shared-memory tree (no float atomics: repeated
// runs match bit for bit).  sincosf is the full-precision version: the
// build uses no --use_fast_math, since __sinf and __cosf would cost
// Rotate2D accuracy over 3,200 applies.

#include "warp_energy.cuh"

namespace {

enum LinearizeMode { kFull = 0, kCostOnly = 1, kModelCost = 2 };

__global__ void __launch_bounds__(kThreads)
warp_jtj_apply_kernel(const float* __restrict__ x,
                      const float* __restrict__ p,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ mask,
                      const float* __restrict__ params,
                      const float* __restrict__ ctc,
                      float* __restrict__ ap, float* __restrict__ partials,
                      int H, int W) {
  __shared__ float sh[kThreads];
  const Grid g{H, W};
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int HW = H * W;
  float dot = 0.f;
  if (g.inside(i, j)) {
    const int k = i * W + j;
    float a0 = 0.f, a1 = 0.f, aA = 0.f;
    if (mask[k] == 0.f) {
      const float pk0 = p[2 * k], pk1 = p[2 * k + 1], pkA = p[2 * HW + k];
      jtj_at(g, i, j, x + 2 * HW, ur, cons, mask, params[0], params[1], pk0,
             pk1, pkA, FlatRead{p, HW}, &a0, &a1, &aA);
      if (ctc != nullptr) {
        a0 += ctc[2 * k] * pk0;
        a1 += ctc[2 * k + 1] * pk1;
        aA += ctc[2 * HW + k] * pkA;
      }
      dot = pk0 * a0 + pk1 * a1 + pkA * aA;
    }
    ap[2 * k] = a0;
    ap[2 * k + 1] = a1;
    ap[2 * HW + k] = aA;
  }
  const float s = block_sum(dot, sh);
  if (thread_rank() == 0) partials[block_rank()] = s;
}

// K3 over S extended slabs (Slabs in warp_energy.cuh; a whole grid is one
// slab with no halo): thread (ic, j) of slab blockIdx.z is own row ic, at
// array row he + ic of its slab.  Neighbour reads stay inside the slab's
// array (they reach one row; he >= 1 in the offset mode), and Grid's
// inside() makes a halo row past the global edge no neighbour.  The cost
// counts the residuals centred on own rows only, so a residual in a halo
// row, which its own slab counts, is counted once.
__global__ void __launch_bounds__(kThreads)
warp_linearize_kernel(const float* __restrict__ x,
                      const float* __restrict__ ur,
                      const float* __restrict__ cons,
                      const float* __restrict__ mask,
                      const float* __restrict__ params,
                      const float* __restrict__ delta,
                      float* __restrict__ jtf, float* __restrict__ diag,
                      float* __restrict__ cost_partials, int W, Slabs sl,
                      int mode) {
  __shared__ float sh[kThreads];
  const int sb = blockIdx.z;
  const Grid g = sl.grid(sb, W);
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int ic = blockIdx.y * kBY + threadIdx.y;
  const int HW = g.H * W;
  // this slab's arrays
  const float* xs = x + (size_t)sb * 3 * HW;
  const float* urs = ur + (size_t)sb * 2 * HW;
  const float* cs = cons + (size_t)sb * 2 * HW;
  const float* ms = mask + (size_t)sb * HW;
  const float* ds = delta != nullptr ? delta + (size_t)sb * 3 * HW : nullptr;
  const float* angle = xs + 2 * HW;
  const bool derivs = mode == kFull;
  const bool model = mode == kModelCost;
  float cost = 0.f;
  if (ic < sl.n && j < W) {
    const int i = sl.he + ic;
    const int k = i * W + j;
    const float w_fit = params[0], w_reg = params[1];
    const bool keep = ms[k] == 0.f;
    const float ok0 = xs[2 * k], ok1 = xs[2 * k + 1];
    const float uk0 = urs[2 * k], uk1 = urs[2 * k + 1];
    float dk0 = 0.f, dk1 = 0.f, dkA = 0.f;
    if (model) {
      dk0 = ds[2 * k];
      dk1 = ds[2 * k + 1];
      dkA = ds[2 * HW + k];
    }
    float sk, ck;
    sincosf(angle[k], &sk, &ck);
    float j0 = 0.f, j1 = 0.f, jA = 0.f, d0 = 0.f, d1 = 0.f, dA = 0.f;
    float ssq = 0.f;
    if (keep) {
      for (int t = 0; t < 4; ++t) {
        // residual centred at k, reading n = k + s
        const int ni = i + kDY[t], nj = j + kDX[t];
        if (g.inside(ni, nj)) {
          const int n = ni * W + nj;
          if (ms[n] == 0.f) {
            const float e0 = uk0 - urs[2 * n], e1 = uk1 - urs[2 * n + 1];
            float r0 = w_reg * ((ok0 - xs[2 * n]) - (ck * e0 - sk * e1));
            float r1 = w_reg * ((ok1 - xs[2 * n + 1]) - (sk * e0 + ck * e1));
            float g0, g1;
            drot(sk, ck, e0, e1, &g0, &g1);
            if (model) {
              // r + J delta: the linear model of this residual
              r0 += w_reg * ((dk0 - ds[2 * n]) - g0 * dkA);
              r1 += w_reg * ((dk1 - ds[2 * n + 1]) - g1 * dkA);
            }
            ssq += r0 * r0 + r1 * r1;
            if (derivs) {
              g0 *= -w_reg;
              g1 *= -w_reg;
              j0 += w_reg * r0;
              j1 += w_reg * r1;
              jA += g0 * r0 + g1 * r1;
              d0 += w_reg * w_reg;
              d1 += w_reg * w_reg;
              dA += g0 * g0 + g1 * g1;
            }
          }
        }
        if (!derivs) continue;
        // residual centred at m = k - s, reading k
        const int mi = i - kDY[t], mj = j - kDX[t];
        if (g.inside(mi, mj)) {
          const int m = mi * W + mj;
          if (ms[m] == 0.f) {
            float sm, cm;
            sincosf(angle[m], &sm, &cm);
            const float e0 = urs[2 * m] - uk0, e1 = urs[2 * m + 1] - uk1;
            const float r0 =
                w_reg * ((xs[2 * m] - ok0) - (cm * e0 - sm * e1));
            const float r1 =
                w_reg * ((xs[2 * m + 1] - ok1) - (sm * e0 + cm * e1));
            j0 -= w_reg * r0;
            j1 -= w_reg * r1;
            d0 += w_reg * w_reg;
            d1 += w_reg * w_reg;
          }
        }
      }
    }
    if (cs[2 * k] >= 0.f && cs[2 * k + 1] >= 0.f) {
      float f0 = w_fit * (ok0 - cs[2 * k]);
      float f1 = w_fit * (ok1 - cs[2 * k + 1]);
      if (model) {
        f0 += w_fit * dk0;
        f1 += w_fit * dk1;
      }
      ssq += f0 * f0 + f1 * f1;
      j0 += w_fit * f0;
      j1 += w_fit * f1;
      d0 += w_fit * w_fit;
      d1 += w_fit * w_fit;
    }
    if (keep) cost = 0.5f * ssq;
    if (derivs) {
      // the own pixel in the local layout
      const int ko = (sb * sl.n + ic) * W + j;
      const int No = sl.S * sl.n * W;
      jtf[2 * ko] = j0;
      jtf[2 * ko + 1] = j1;
      jtf[2 * No + ko] = jA;
      diag[2 * ko] = d0;
      diag[2 * ko + 1] = d1;
      diag[2 * No + ko] = dA;
    }
  }
  const float s = block_sum(cost, sh);
  if (thread_rank() == 0) cost_partials[block_rank()] = s;
}

}  // namespace

extern "C" int opt_warp_blocks(int H, int W) {
  const dim3 gr = warp_grid(H, W);
  return (int)(gr.x * gr.y);
}

extern "C" int opt_warp_jtj_apply(const float* x, const float* p,
                                  const float* ur, const float* cons,
                                  const float* mask, const float* params,
                                  const float* ctc, float* ap,
                                  float* partials, int H, int W,
                                  void* stream) {
  warp_jtj_apply_kernel<<<warp_grid(H, W), dim3(kBX, kBY), 0,
                          (cudaStream_t)stream>>>(
      x, p, ur, cons, mask, params, ctc, ap, partials, H, W);
  return (int)cudaGetLastError();
}

// mode: 0 J^T F, diag and cost; 1 the cost alone; 2 the model cost
// 0.5 sum mask(F + J delta)^2 alone
extern "C" int opt_warp_linearize(const float* x, const float* ur,
                                  const float* cons, const float* mask,
                                  const float* params, const float* delta,
                                  float* jtf, float* diag,
                                  float* cost_partials, int H, int W,
                                  int mode, void* stream) {
  warp_linearize_kernel<<<warp_grid(H, W), dim3(kBX, kBY), 0,
                          (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, delta, jtf, diag, cost_partials, W,
      Slabs{1, H, 0, 0, H}, mode);
  return (int)cudaGetLastError();
}

extern "C" int opt_warp_slab_blocks(int S, int n, int W) {
  const dim3 gr = warp_grid(n, W, S);
  return (int)(gr.x * gr.y * gr.z);
}

// K3's global-offset mode over S extended slabs (Slabs in
// warp_energy.cuh): the arrays hold S slabs of n + 2 he rows, slab s's row
// 0 at global row row0 + s * n of Hg; jtf and diag cover the own rows in
// the local layout, the cost partials come slab by slab
extern "C" int opt_warp_slab_linearize(const float* x, const float* ur,
                                       const float* cons, const float* mask,
                                       const float* params,
                                       const float* delta, float* jtf,
                                       float* diag, float* cost_partials,
                                       int S, int n, int he, int W, int row0,
                                       int Hg, int mode, void* stream) {
  warp_linearize_kernel<<<warp_grid(n, W, S), dim3(kBX, kBY), 0,
                          (cudaStream_t)stream>>>(
      x, ur, cons, mask, params, delta, jtf, diag, cost_partials, W,
      Slabs{S, n, he, row0, Hg}, mode);
  return (int)cudaGetLastError();
}
