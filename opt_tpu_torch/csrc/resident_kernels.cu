// K13 resident_pcg: one Gauss-Newton outer step's whole hat-space PCG, in
// one cooperative launch.
//
// Replaces the TPU kernel opt_tpu/ops/stream_solver.py
// StreamSolver._build_kernel: lIterations of classic PCG on
// A_hat = S J^T J S, S = diag(sq), sq = sqrt(pre), M_hat = I, from
// r = p = r0_hat and an = <r0_hat, r0_hat> (:424-447), with one alpha and
// beta for the whole vector and the guards of :514-515 and :533-534.  The
// TPU kernel keeps p, r, Ap and delta in VMEM and streams the
// linearization point, the constants and sq in row-tile windows; here the
// loop is resident_pcg.cuh's, its vectors in device memory (in L2 at
// 512^2) and the energy's J^T J recomputed at every apply, as PCGStep1
// and the TPU kernel do:
//   image_warping         warp_energy.cuh's jtj_at, from x, UrShape,
//                         Constraints and Mask (the flat layout Offset
//                         (H, W, 2) then Angle (H, W, 1)); A_hat p = 0 at
//                         a masked pixel;
//   poisson_image_editing poisson_energy.cuh on the flat (H, W, C) vector;
//                         sq is 0 at excluded pixels and 1 elsewhere (no
//                         preconditioner), which folds the exclusion into
//                         A_hat (stream_solver.py:21-28, :612-620).
// Out: d_hat; the caller forms delta = sq d_hat.
//
// Bound on the card: arithmetic.  The function moves its inputs once (the
// constants, x, sq and b_hat) and writes d_hat; each iteration the kernel
// moves about 10 planes an unknown channel through L2 (device memory past
// L2's 50 MB) and, for image_warping, evaluates five rotations a pixel.
// Poisson needs 18 flops an element an iteration: K12's 17
// (poisson_kernels.cu) with sq on the way in and on the way out in place
// of the keep multiply.

#include "poisson_energy.cuh"
#include "resident_pcg.cuh"
#include "warp_energy.cuh"

namespace {

// sq . p at a pixel, p read through L2 (other threads write it)
struct WarpScaledRead {
  const float* sq;
  const float* p;
  int HW;
  __device__ void operator()(int idx, float* v0, float* v1,
                             float* vA) const {
    *v0 = sq[2 * idx] * __ldcg(p + 2 * idx);
    *v1 = sq[2 * idx + 1] * __ldcg(p + 2 * idx + 1);
    *vA = sq[2 * HW + idx] * __ldcg(p + 2 * HW + idx);
  }
};

// image_warping for resident_pcg.cuh: three components a pixel
struct WarpHat {
  static constexpr int kComp = 3;
  const float* x;
  const float* ur;
  const float* cons;
  const float* mask;
  const float* params;
  int H, W;
  __device__ int comps() const { return 3; }
  __device__ int idx(int k, int c) const {
    return c < 2 ? 2 * k + c : 2 * H * W + k;
  }
  __device__ int sq_idx(int k, int c) const { return idx(k, c); }
  __device__ void hat(int k, const float* sq, const float* p,
                      float* a) const {
    a[0] = a[1] = a[2] = 0.f;
    if (mask[k] != 0.f) return;
    const int HW = H * W;
    const int i = k / W, j = k - i * W;
    const WarpScaledRead read{sq, p, HW};
    float v0, v1, vA, jv[3];
    read(k, &v0, &v1, &vA);
    jtj_at(Grid{H, W}, i, j, x + 2 * HW, ur, cons, mask, params[0],
           params[1], v0, v1, vA, read, &jv[0], &jv[1], &jv[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = sq[idx(k, c)] * jv[c];
  }
};

}  // namespace

// the grids of the two modes over n_pix pixels (or minus the CUDA error
// of the occupancy query)
extern "C" int opt_resident_warp_blocks(int n_pix) {
  return coop::grid_blocks(coop::pcg_kernel<WarpHat, false, false>, n_pix);
}

extern "C" int opt_resident_poisson_blocks(int n_pix) {
  return coop::grid_blocks(coop::pcg_kernel<PoissonHat, false, false>,
                           n_pix);
}

// image_warping: x, sq, b_hat, delta, r, p, ap are flat (3 H W); parts
// holds 2 blocks floats of scratch
extern "C" int opt_resident_warp(const float* x, const float* ur,
                                 const float* cons, const float* mask,
                                 const float* params, const float* sq,
                                 const float* b_hat, float* delta, float* r,
                                 float* p, float* ap, float* parts, int H,
                                 int W, int n_iters, int blocks,
                                 void* stream) {
  const WarpHat e{x, ur, cons, mask, params, H, W};
  return coop::launch<WarpHat, false, false>(e, sq, b_hat, delta, r, p, ap,
                                             parts, H * W, n_iters, blocks,
                                             stream);
}

// poisson_image_editing: sq, b_hat, delta, r, p, ap are flat (H W C)
extern "C" int opt_resident_poisson(const float* sq, const float* b_hat,
                                    float* delta, float* r, float* p,
                                    float* ap, float* parts, int H, int W,
                                    int C, int n_iters, int blocks,
                                    void* stream) {
  if (C < 1 || C > PoissonHat::kComp) return (int)cudaErrorInvalidValue;
  const PoissonHat e{H, W, C, C, 1, C, 1};
  return coop::launch<PoissonHat, false, false>(e, sq, b_hat, delta, r, p,
                                                ap, parts, H * W, n_iters,
                                                blocks, stream);
}
