// K2 pcg_update: PCG Step2 in one pass over the flat unknown vectors.
//
// Replaces the TPU kernel opt_tpu/ops/pcg_pallas.py:_fused_update_kernel
// (fused_pcg_update), which is the Step2 inside the whole-solve kernel
// opt_tpu/ops/vmem_solver.py:VmemSolver._build:
//
//     delta' = delta + alpha p
//     r'     = r - alpha Ap
//     z'     = pre r'
//     rz_b   = sum over block b of z' r'              (beta numerator)
//     q_b    = sum over block b of 0.5 delta' (r' + b) (LM only)
//
// Hat mode (pre null): the streamed engine's Step2 in the Jacobi-scaled
// space, where M = I (opt_tpu/ops/stream_solver.py StreamSolverHBM's
// sweep 2): z' = r', so pre is not read and z' is not written; the caller
// uses r' in its place, and rz_b sums r' r'.
//
// Bound on the card: device memory.  GN reads p, Ap, delta, r, pre (20 B
// per element) and writes delta', r', z' (12 B); LM reads b as well (36 B
// in all; hat mode drops pre and z', 12 B).  Two flops per byte at most,
// far under the H100's ridge, so the
// design keeps to one read and one write of every vector: one thread per
// element, 256 threads a block, neighbouring threads on neighbouring
// addresses.  The cross-block sums are per-block partials written by a
// fixed shared-memory tree; the caller sums the short partials vector, so
// repeated runs match bit for bit (no float atomics).  alpha is read from
// device memory, so the host never waits on the reduction that made it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  float out = sh[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
pcg_update_kernel(const float* __restrict__ alpha_ptr,
                  const float* __restrict__ p, const float* __restrict__ ap,
                  const float* __restrict__ delta,
                  const float* __restrict__ r, const float* __restrict__ pre,
                  const float* __restrict__ b, float* __restrict__ delta_out,
                  float* __restrict__ r_out, float* __restrict__ z_out,
                  float* __restrict__ rz_partials,
                  float* __restrict__ q_partials, int n, int uses_lambda) {
  __shared__ float sh[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float alpha = *alpha_ptr;
  float rz = 0.f, q = 0.f;
  if (i < n) {
    const float d = delta[i] + alpha * p[i];
    const float rr = r[i] - alpha * ap[i];
    const float z = pre != nullptr ? pre[i] * rr : rr;
    delta_out[i] = d;
    r_out[i] = rr;
    if (z_out != nullptr) z_out[i] = z;
    rz = z * rr;
    if (uses_lambda) q = 0.5f * (d * (rr + b[i]));
  }
  const float rz_sum = block_sum(rz, sh);
  if (threadIdx.x == 0) rz_partials[blockIdx.x] = rz_sum;
  if (uses_lambda) {
    const float q_sum = block_sum(q, sh);
    if (threadIdx.x == 0) q_partials[blockIdx.x] = q_sum;
  }
}

}  // namespace

// pre and z_out are null together in hat mode; b is read only when
// uses_lambda
extern "C" int opt_pcg_update_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

extern "C" int opt_pcg_update(const float* alpha, const float* p,
                              const float* ap, const float* delta,
                              const float* r, const float* pre, const float* b,
                              float* delta_out, float* r_out, float* z_out,
                              float* rz_partials, float* q_partials, int n,
                              int uses_lambda, void* stream) {
  const int blocks = opt_pcg_update_blocks(n);
  pcg_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      alpha, p, ap, delta, r, pre, b, delta_out, r_out, z_out, rz_partials,
      q_partials, n, uses_lambda);
  return (int)cudaGetLastError();
}

extern "C" const char* opt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
