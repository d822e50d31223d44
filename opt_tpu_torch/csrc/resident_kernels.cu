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
// loop is resident_pcg.cuh's (two grid syncs an iteration, p formed on the
// fly from r and p_prev), its vectors in device memory (in L2 at 512^2)
// and the energy's J^T J recomputed at every apply, as PCGStep1 and the
// TPU kernel do:
//   image_warping         warp_tile.cuh's row-marching core, as K1 runs
//                         it: a warp of 32 lanes marches a strip of 30 own
//                         columns (and one on each side) down a chunk of
//                         rows, each pixel's data read once, its sincosf
//                         taken once, each residual formed once; the
//                         operand sq . (r + beta p_prev) formed from r and
//                         p_prev through L2, the output scaled by sq, 0 at
//                         a masked pixel.  The chunks are sized to one
//                         wave of this kernel's own occupancy
//                         (warp_tile_rows), and where the tiles outnumber
//                         the blocks the grid strides over them.  The flat
//                         layout: Offset (H, W, 2) then Angle (H, W, 1);
//   poisson_image_editing poisson_energy.cuh's loop on (C, H, W) planes,
//                         as K12 runs it: the wrapper transposes sq and
//                         b_hat in and d_hat out, once a launch; sq is 0 at
//                         excluded pixels and 1 elsewhere (no
//                         preconditioner), which folds the exclusion into
//                         A_hat (stream_solver.py:21-28, :612-620).
// Out: d_hat; the caller forms delta = sq d_hat.
//
// Bound on the card: arithmetic.  The function moves its inputs once (the
// constants, x, sq and b_hat) and writes d_hat; each iteration the kernel
// moves about 9 planes an unknown channel through L2 (device memory past
// L2's 50 MB: the apply reads r, p_prev and delta and writes p, Ap and
// delta, the update reads r and Ap and writes r) and, for image_warping,
// one rotation a pixel.  Poisson needs 18 flops an element an iteration:
// K12's 17 (poisson_kernels.cu) with sq on the way in and on the way out
// in place of the keep multiply.
//
// ptxas (CUDA 12.8, sm_90a): the warp mode 94 registers, a 32-byte stack
// frame, no spills (5 blocks of 128 threads an SM; 6, at 80 registers,
// spilled and ran slower at 2048^2); the poisson mode 60 registers, no
// spills.
//
// The image_warping mode has two forms, picked by the grid's shape alone
// (ops/stream_cuda.py onchip_tiles): where the grid's 32 x 64 tiles number
// no more than the card's SMs and a tile's state fits a block's shared
// memory, the on-chip form (resident_onchip.cuh, opt_resident_warp_onchip:
// one block a tile and an SM, r, p, A_hat p and delta on chip for the
// whole launch, only the tiles' edges through L2); elsewhere the L2 form
// below (opt_resident_warp).  The two share warp_energy.cuh's math.

#include "poisson_energy.cuh"
#include "resident_onchip.cuh"
#include "resident_pcg.cuh"
#include "warp_tile.cuh"

namespace {

// a[2k], a[2k + 1] plainly: the calling thread wrote them
__device__ __forceinline__ void ld_own_pair(const float* a, int k, bool pairs,
                                            float* x0, float* x1) {
  if (pairs) {
    const float2 t = reinterpret_cast<const float2*>(a)[k];
    *x0 = t.x;
    *x1 = t.y;
  } else {
    *x0 = a[2 * k];
    *x1 = a[2 * k + 1];
  }
}

// a[2k], a[2k + 1] through L2 (another thread wrote them)
__device__ __forceinline__ void ldcg_pair(const float* a, int k, bool pairs,
                                          float* x0, float* x1) {
  if (pairs) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(a) + k);
    *x0 = t.x;
    *x1 = t.y;
  } else {
    *x0 = __ldcg(a + 2 * k);
    *x1 = __ldcg(a + 2 * k + 1);
  }
}

// K13's operand and output on the march: p = r + beta p_prev (one
// __fmaf_rn, the same float at every pixel that reads it), v = sq . p;
// at an own pixel A_hat p = sq . J^T J v (0 where masked) and p are
// written, p . A_hat p is the dot, and the last iteration's step
// delta += alpha p_prev is taken (p_prev read again there: the fetch a
// row before brought it to L2).  Its raw data: sq, r and p_prev.
struct ResidentIo {
  static constexpr int kRaw = 9;
  const float* __restrict__ sq;
  const float* r;
  const float* pp;
  float* pn;
  float* ap;
  float* delta;
  float beta, alpha;
  int W, HW;
  __device__ void fetch(int k, bool, bool pairs, float* raw) const {
    ld_pair(sq, k, pairs, &raw[0], &raw[1]);
    raw[2] = __ldg(sq + 2 * HW + k);
    ldcg_pair(r, k, pairs, &raw[3], &raw[4]);
    raw[5] = __ldcg(r + 2 * HW + k);
    ldcg_pair(pp, k, pairs, &raw[6], &raw[7]);
    raw[8] = __ldcg(pp + 2 * HW + k);
  }
  __device__ void operand(const float* raw, Pix& px) const {
    px.x0 = raw[0], px.x1 = raw[1], px.xA = raw[2];
    px.y0 = __fmaf_rn(beta, raw[6], raw[3]);
    px.y1 = __fmaf_rn(beta, raw[7], raw[4]);
    px.yA = __fmaf_rn(beta, raw[8], raw[5]);
    px.v0 = px.x0 * px.y0, px.v1 = px.x1 * px.y1, px.vA = px.xA * px.yA;
  }
  __device__ float store(int i, int j, const Pix& px, bool pairs) const {
    const int k = i * W + j;
    float a0 = 0.f, a1 = 0.f, aA = 0.f;
    if (px.keep) a0 = px.x0 * px.a0, a1 = px.x1 * px.a1, aA = px.xA * px.aA;
    st_pair(ap, k, pairs, a0, a1);
    ap[2 * HW + k] = aA;
    st_pair(pn, k, pairs, px.y0, px.y1);
    pn[2 * HW + k] = px.yA;
    float q0, q1, d0, d1;
    ldcg_pair(pp, k, pairs, &q0, &q1);
    ld_own_pair(delta, k, pairs, &d0, &d1);
    st_pair(delta, k, pairs, d0 + alpha * q0, d1 + alpha * q1);
    delta[2 * HW + k] = delta[2 * HW + k] + alpha * __ldcg(pp + 2 * HW + k);
    return px.y0 * a0 + px.y1 * a1 + px.yA * aA;
  }
};

// image_warping for resident_pcg.cuh on the march: a block of
// kStripWarps strips; tile t is strip group t % gx and chunk t / gx of
// `rows` own rows; block b takes tiles b, b + G, ...  A thread's own
// pixels (the ones its march writes) are its lane's column at its tiles'
// rows, lanes 1 .. 30.
struct WarpLoop {
  static constexpr int kThreads = kStripThreads;
  static constexpr int kMinBlocks = 4;  // 128 registers at most
  static constexpr int kGroups = 1;
  const float* __restrict__ x;
  const float* __restrict__ ur;
  const float* __restrict__ cons;
  const float* __restrict__ mask;
  const float* __restrict__ params;
  const float* __restrict__ sq;
  const float* __restrict__ b;
  float* delta;
  float* r;
  float* p[2];
  float* ap;
  float* parts;
  int H, W, rows, gx, tiles;
  bool pairs;

  __device__ int groups() const { return 1; }

  __device__ int strip(int t) const {
    return ((t % gx) * kStripWarps + (int)threadIdx.y) * kOwn;
  }

  // f(i) for each own component i of this thread's pixels
  template <class F>
  __device__ __forceinline__ void own(F f) const {
    const int lane = threadIdx.x;
    if (lane == 0 || lane == kStrip - 1) return;
    const int HW = H * W;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int j = strip(t) - 1 + lane;
      if (j >= W) continue;
      const int c0 = (t / gx) * rows, c1 = min(c0 + rows, H);
      for (int i = c0; i < c1; ++i) {
        const int k = i * W + j;
        f(2 * k);
        f(2 * k + 1);
        f(2 * HW + k);
      }
    }
  }

  template <int KG>
  __device__ __forceinline__ void start(float (&acc)[KG]) const {
    own([&](int i) {
      const float v = b[i];
      r[i] = v;
      p[0][i] = 0.f;
      delta[i] = 0.f;
      acc[0] += v * v;
    });
  }

  template <int KG>
  __device__ __forceinline__ void apply(const float* pp, float* pn,
                                        const float (&beta)[KG],
                                        const float (&alpha)[KG],
                                        float (&acc)[KG]) const {
    const int HW = H * W;
    const float w_fit = params[0], w_reg = params[1];
    const ResidentIo io{sq, r, pp, pn, ap, delta, beta[0], alpha[0], W, HW};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int w0 = strip(t);
      if (w0 >= W) continue;  // the whole warp
      const int c0 = (t / gx) * rows, c1 = min(c0 + rows, H);
      acc[0] += warp_tile_march(Grid{H, W}, c0, c1,
                                w0 - 1 + (int)threadIdx.x, x + 2 * HW, ur,
                                cons, mask, w_fit, w_reg, pairs, io);
    }
  }

  template <int KG>
  __device__ __forceinline__ void update(const float (&alpha)[KG],
                                         float (&acc)[KG]) const {
    const float al = alpha[0];
    own([&](int i) {
      const float rn = r[i] - al * ap[i];
      r[i] = rn;
      acc[0] += rn * rn;
    });
  }

  template <int KG>
  __device__ __forceinline__ void finish(const float* pl,
                                         const float (&alpha)[KG]) const {
    const float al = alpha[0];
    own([&](int i) { delta[i] = delta[i] + al * pl[i]; });
  }
};

using PoissonHat = PoissonLoop<false, false>;

// The march's chunk of rows and its tiles on a card that holds `cap`
// blocks of the kernel at once
struct WarpTiles {
  int rows, gx, tiles;
};

WarpTiles warp_tiles(int H, int W, int cap) {
  const int rows = warp_tile_rows(1, H, W, cap);
  const int gx = warp_tile_gx(W);
  return {rows, gx, gx * ((H + rows - 1) / rows)};
}

int warp_capacity() {
  return coop::capacity(coop::pcg_kernel<WarpLoop>, WarpLoop::kThreads);
}

}  // namespace

// The grids of the two modes (or minus the CUDA error of the occupancy
// query)
extern "C" int opt_resident_warp_blocks(int H, int W) {
  const int cap = warp_capacity();
  return cap <= 0 ? cap : coop::grid_blocks(cap, warp_tiles(H, W, cap).tiles);
}

extern "C" int opt_resident_poisson_blocks(int n_pix) {
  return coop::grid_blocks(
      coop::capacity(coop::pcg_kernel<PoissonHat>, PoissonHat::kThreads),
      (n_pix + PoissonHat::kThreads - 1) / PoissonHat::kThreads);
}

// image_warping: x, sq, b_hat, delta, r, p0, p1, ap are flat (3 H W);
// parts holds 2 blocks floats of scratch
extern "C" int opt_resident_warp(const float* x, const float* ur,
                                 const float* cons, const float* mask,
                                 const float* params, const float* sq,
                                 const float* b_hat, float* delta, float* r,
                                 float* p0, float* p1, float* ap,
                                 float* parts, int H, int W, int n_iters,
                                 int blocks, void* stream) {
  const int cap = warp_capacity();
  if (cap <= 0) return -cap;
  const WarpTiles t = warp_tiles(H, W, cap);
  const WarpLoop loop{x,      ur,     cons,   mask,    params,  sq,
                      b_hat,  delta,  r,      {p0, p1}, ap,     parts,
                      H,      W,      t.rows, t.gx,    t.tiles,
                      tile_pairs(0, 1, sq, b_hat, delta, r, p0, p1, ap, ur,
                                 cons)};
  return coop::launch(loop, n_iters, blocks, stream);
}

// poisson_image_editing: sq, b_hat, delta, r, p0, p1, ap are (C, H, W)
// planes
extern "C" int opt_resident_poisson(const float* sq, const float* b_hat,
                                    float* delta, float* r, float* p0,
                                    float* p1, float* ap, float* parts, int H,
                                    int W, int C, int n_iters, int blocks,
                                    void* stream) {
  if (C < 1 || C > PoissonHat::kComp) return (int)cudaErrorInvalidValue;
  const PoissonHat loop{H,     W, C, H * W,    sq,
                        b_hat, delta, r, {p0, p1}, ap, parts};
  return coop::launch(loop, n_iters, blocks, stream);
}

// The on-chip form's grid at H x W: one block a tile
extern "C" int opt_resident_warp_onchip_blocks(int H, int W) {
  return onchip::tiles(H, W);
}

// The current card's SMs and the shared memory a block may take (opted
// in), which the on-chip form's rule reads; the CUDA error, or 0
extern "C" int opt_card_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) cudaGetLastError();  // this query's, not a launch's
  return (int)err;
}

// image_warping's on-chip form: x, sq, b_hat, delta, r, p0, p1 are flat
// (3 H W), of which r, p0 and p1 carry only the tiles' edges; parts holds
// 4 blocks floats of scratch (two 8-byte slots a block), which the entry
// zeroes on the stream.  blocks (opt_resident_warp_onchip_blocks) may not
// be fewer than the tiles, nor more than the kernel's barrier reads; a grid
// the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), as is a block's shared memory past
// what the card grants
extern "C" int opt_resident_warp_onchip(
    const float* x, const float* ur, const float* cons, const float* mask,
    const float* params, const float* sq, const float* b_hat, float* delta,
    float* r, float* p0, float* p1, float* parts, int H, int W, int n_iters,
    int blocks, void* stream) {
  if (blocks < onchip::tiles(H, W) || blocks > onchip::kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      onchip::warp_pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)onchip::kSmemBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: it is this call's, not a later one's
    return (int)err;
  }
  auto* slots = reinterpret_cast<unsigned long long*>(parts);
  err = cudaMemsetAsync(slots, 0, sizeof(*slots) * 2 * blocks,
                        (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  onchip::Params q{x,     ur, cons,     mask,  params, sq, b_hat,
                   delta, r,  {p0, p1}, slots, H,      W};
  void* args[] = {&q, &n_iters};
  err = cudaLaunchCooperativeKernel((const void*)onchip::warp_pcg_kernel,
                                    dim3(blocks), dim3(onchip::kThreads),
                                    args, onchip::kSmemBytes,
                                    (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? (int)err : (int)last;
}
