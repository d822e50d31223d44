// K14 stencil_apply: out[i, j] = sum_k w_k img[i + dy_k, j + dx_k], zero
// outside the H x W image.
//
// Replaces the TPU kernel opt_tpu/ops/halo_stencil.py:_kernel
// (stencil_apply): each grid step DMAs its row tile plus a halo into VMEM
// and writes its tile.  Here each block takes `tile` rows by kCols
// columns, loads that window plus the exact halo (max |dy| rows above and
// below, max |dx| columns left and right; zero outside the image) into
// shared memory with coalesced plain loads, syncs, and writes its tile
// from shared memory.  The halo rounded up to 8 rows and the width padded
// to 128 lanes are TPU scaffolding and are not ported.  The taps are
// kernel arguments, at most kMaxTaps of them.
//
// Bound on the card: device memory.  The image is read once (plus the
// halo rows and columns, which neighbouring blocks read again, mostly
// from L2) and out written once: 8 bytes a pixel against 2 flops a tap.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;
constexpr int kMaxTaps = 32;

struct Taps {
  int n, rx, ry;
  int dx[kMaxTaps];
  int dy[kMaxTaps];
  float w[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ img, float* __restrict__ out,
               int H, int W, int tile, Taps taps) {
  extern __shared__ float win[];  // (tile + 2 ry) x (kCols + 2 rx)
  const int row0 = blockIdx.y * tile, col0 = blockIdx.x * kCols;
  const int ww = kCols + 2 * taps.rx;
  const int wh = tile + 2 * taps.ry;
  for (int e = threadIdx.x; e < wh * ww; e += kThreads) {
    const int gi = row0 - taps.ry + e / ww;
    const int gj = col0 - taps.rx + e % ww;
    win[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W) ? img[gi * W + gj]
                                                       : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tile * kCols; e += kThreads) {
    const int ti = e / kCols, tj = e % kCols;
    const int gi = row0 + ti, gj = col0 + tj;
    if (gi >= H || gj >= W) continue;
    const float* centre = win + (ti + taps.ry) * ww + tj + taps.rx;
    float acc = 0.f;
    for (int k = 0; k < taps.n; ++k)
      acc += taps.w[k] * centre[taps.dy[k] * ww + taps.dx[k]];
    out[gi * W + gj] = acc;
  }
}

}  // namespace

// dx, dy, w: host arrays of n_taps taps; tile: rows per block
extern "C" int opt_stencil_apply(const float* img, float* out, int H, int W,
                                 int tile, int n_taps, const int* dx,
                                 const int* dy, const float* w,
                                 void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1)
    return (int)cudaErrorInvalidValue;
  Taps taps{};
  taps.n = n_taps;
  for (int k = 0; k < n_taps; ++k) {
    taps.dx[k] = dx[k];
    taps.dy[k] = dy[k];
    taps.w[k] = w[k];
    const int ax = dx[k] < 0 ? -dx[k] : dx[k];
    const int ay = dy[k] < 0 ? -dy[k] : dy[k];
    if (ax > taps.rx) taps.rx = ax;
    if (ay > taps.ry) taps.ry = ay;
  }
  const size_t smem = sizeof(float) * (size_t)(tile + 2 * taps.ry) *
                      (size_t)(kCols + 2 * taps.rx);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: it is this call's, not a later one's
    return (int)err;
  }
  const dim3 grid((W + kCols - 1) / kCols, (H + tile - 1) / tile);
  stencil_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, out, H, W, tile, taps);
  return (int)cudaGetLastError();
}
