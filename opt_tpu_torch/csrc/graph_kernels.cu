// K9 graph_gather, K10 graph_scatter and K11 graph_hat_apply: the graph
// path's vertex <-> edge movement and its inner PCG apply.
//
// Replace the TPU kernels
//   K9   opt_tpu/ops/onehot_pallas.py _gather_kernel / onehot_gather_blocks:
//        out[b, e] = windows[b, loc[b, e]], a vertex -> edge gather done as
//        one-hot matmuls on split-bf16 windows of a banded (RCM-reordered)
//        vertex layout, because the TPU's matrix unit can only gather by
//        matmul.  Here a gather is a load: out[r, c] = V[idx[r], c] on the
//        flat vertex order, one thread per (row, channel), channels
//        fastest, so the writes are coalesced and the reads of a row share
//        its cache lines;
//   K10  onehot_pallas.py _scatter_kernel / onehot_scatter_windows: the
//        transpose, edge -> vertex with duplicates accumulated.  Here a
//        segmented sum over the slot's incidence in CSR form (order: the
//        edges sorted by vertex, stably; rowptr: where each vertex's run
//        starts), one thread per (vertex, channel) summing its run in edge
//        order.  No atomics, so repeated solves match bit for bit;
//   K11  opt_tpu/ops/graph_pcg_kernel.py GraphPcgKernel._build: the whole
//        graph PCG in one VMEM-resident kernel, whose apply is
//            J p   = sum_a D_a * gather_slot(a)(p)[unk(a)]
//            J^T v = sum_a scatter_slot(a)(D_a * v)   into unk(a)
//        over the materialized per-leaf partials D_a = dr/da.  Here the
//        PCG loop runs on the host (ops/stream_cuda.py classic_pcg) and K11
//        is its apply in the hat space with the beta step fused:
//            p = r + beta p_prev,  A_hat p = sq . J^T J (sq . p) + scs . p
//        and the block partials of <p, A_hat p>.  Like the TPU kernel it
//        never traces the energy: the energy enters only through D and
//        small int tables (meta below), so it holds every graph energy of
//        this shape (one vertex space, pointwise vertex terms).
//
// K11 is vertex-centred: the thread of vertex v walks, for each slot s, the
// edges whose slot-s end is v (the slot's CSR run), recomputes each edge's
// tangent t[cr] = sum_a D[a n_res + cr, e] ps(unk(a), idx_slot(a)[e]) from
// the neighbours' r, p_prev and sq (ps = sq . p, formed where it is read),
// and adds sum_cr D[a n_res + cr, e] t[cr] into v's channel unk(a) for the
// leaves a on slot s.  Then the pointwise vertex terms, then p, A_hat p and
// the partial.  p goes to its own buffer, never over p_prev: other threads
// read p_prev.  Every edge's D is read once per slot side (twice for two
// slots); a two-phase form (edge tangents to memory, then a vertex pass)
// reads D twice as well, and writes and reads t besides, in two launches.
//
// Bound on the card: device memory.  At arap's 10k vertices (61,610 edges,
// 27 D rows a graph edge) D is 6.6 MB and everything sits in the 50 MB L2;
// each call is a few tens of microseconds and the host's per-iteration
// work is larger.  On a 512 x 512 mesh D is 169 MB and the per-vertex
// walks read it scattered, below the HBM rate.
//
// The cross-block sums are per-block partials from a fixed shared-memory
// tree, summed by the caller.  beta is read from device memory, so the host
// never waits on the reduction that made it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // K9, K10
constexpr int kGThreads = 64;   // K11: 10k vertices still make 163 blocks
constexpr int kMetaMax = 1024;  // ints of K11's table (ops/graph_cuda.py)
constexpr int kMaxUnk = 16;     // unknown channels
constexpr int kMaxRes = 16;     // residual channels of one term group

template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_gather_kernel(const T* __restrict__ v, const int* __restrict__ idx,
                    T* __restrict__ out, int rows, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * C) return;
  const long long row = i / C;
  const int c = (int)(i - row * C);
  out[i] = v[(long long)idx[row] * C + c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_scatter_kernel(const T* __restrict__ x, const int* __restrict__ order,
                     const int* __restrict__ rowptr, T* __restrict__ out,
                     int n, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n * C) return;
  const int vtx = (int)(i / C);
  const int c = (int)(i - (long long)vtx * C);
  T s = T(0);
  for (int j = rowptr[vtx]; j < rowptr[vtx + 1]; ++j)
    s += x[(long long)order[j] * C + c];
  out[i] = s;
}

__device__ __forceinline__ float gblock_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kGThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// p = r + beta p_prev (r where p_prev is null), the same rounding wherever
// it is formed
__device__ __forceinline__ float hat_p(const float* __restrict__ r,
                                       const float* __restrict__ pprev,
                                       float beta, long long i) {
  return pprev != nullptr ? fmaf(beta, pprev[i], r[i]) : r[i];
}

// meta (int32), as ops/graph_cuda.py HatTables writes it:
//   [0] n_unk  [1] n_graph  [2] has_fit
//   per unknown channel u: base_u, stride_u (element i of channel u at
//     vertex w is base_u + w stride_u in the flat vectors)
//   per graph group: E, n_slots, n_res, n_leaves, d_off (into D), i_off
//     (into idx and order: slot s at i_off + s E), rp_off (into rowptr:
//     slot s at rp_off + s (N + 1)), leaf_slot[n_leaves], leaf_unk[n_leaves]
//   if has_fit: n_res, n_leaves, d_off, leaf_unk[n_leaves]
// D rows are a n_res + cr for leaf a and residual channel cr, each row E
// (graph group) or N (vertex group) long.
__global__ void __launch_bounds__(kGThreads)
graph_hat_apply_kernel(const float* __restrict__ D,
                       const int* __restrict__ idx,
                       const int* __restrict__ order,
                       const int* __restrict__ rowptr,
                       const int* __restrict__ meta_in, int n_meta,
                       const float* __restrict__ sq,
                       const float* __restrict__ scs,
                       const float* __restrict__ r,
                       const float* __restrict__ pprev,
                       const float* __restrict__ beta_ptr,
                       float* __restrict__ p_out, float* __restrict__ ap,
                       float* __restrict__ partials, int N) {
  __shared__ int meta[kMetaMax];
  __shared__ float acc[kMaxUnk][kGThreads];
  __shared__ float sh[kGThreads];
  for (int k = threadIdx.x; k < n_meta; k += kGThreads) meta[k] = meta_in[k];
  __syncthreads();
  const int tid = threadIdx.x;
  const int v = blockIdx.x * kGThreads + tid;
  const int n_unk = meta[0];
  const int* bs = meta + 3;  // base_u, stride_u pairs
  const float beta = pprev != nullptr ? *beta_ptr : 0.f;
  for (int u = 0; u < n_unk; ++u) acc[u][tid] = 0.f;
  float dot = 0.f;
  if (v < N) {
    int pos = 3 + 2 * n_unk;
    for (int g = 0; g < meta[1]; ++g) {
      const int E = meta[pos], n_slots = meta[pos + 1];
      const int n_res = meta[pos + 2], n_leaves = meta[pos + 3];
      const float* Dg = D + meta[pos + 4];
      const int* ig = idx + meta[pos + 5];
      const int* og = order + meta[pos + 5];
      const int* rg = rowptr + meta[pos + 6];
      const int* lslot = meta + pos + 7;
      const int* lunk = lslot + n_leaves;
      for (int s = 0; s < n_slots; ++s) {
        const int* rp = rg + (long long)s * (N + 1);
        const int jb = rp[v], je = rp[v + 1];
        for (int j = jb; j < je; ++j) {
          const int e = og[(long long)s * E + j];
          float t[kMaxRes];
#pragma unroll
          for (int cr = 0; cr < kMaxRes; ++cr) t[cr] = 0.f;
          for (int a = 0; a < n_leaves; ++a) {
            const int u = lunk[a];
            const long long w = ig[(long long)lslot[a] * E + e];
            const long long i = bs[2 * u] + w * bs[2 * u + 1];
            const float x = sq[i] * hat_p(r, pprev, beta, i);
            const float* Da = Dg + (long long)a * n_res * E + e;
#pragma unroll
            for (int cr = 0; cr < kMaxRes; ++cr)
              if (cr < n_res) t[cr] = fmaf(Da[(long long)cr * E], x, t[cr]);
          }
          for (int a = 0; a < n_leaves; ++a) {
            if (lslot[a] != s) continue;
            const float* Da = Dg + (long long)a * n_res * E + e;
            float c = 0.f;
#pragma unroll
            for (int cr = 0; cr < kMaxRes; ++cr)
              if (cr < n_res) c = fmaf(Da[(long long)cr * E], t[cr], c);
            acc[lunk[a]][tid] += c;
          }
        }
      }
      pos += 7 + 2 * n_leaves;
    }
    if (meta[2]) {  // the pointwise vertex terms
      const int n_res = meta[pos], n_leaves = meta[pos + 1];
      const float* Df = D + meta[pos + 2];
      const int* lunk = meta + pos + 3;
      float t[kMaxRes];
#pragma unroll
      for (int cr = 0; cr < kMaxRes; ++cr) t[cr] = 0.f;
      for (int a = 0; a < n_leaves; ++a) {
        const int u = lunk[a];
        const long long i = bs[2 * u] + (long long)v * bs[2 * u + 1];
        const float x = sq[i] * hat_p(r, pprev, beta, i);
        const float* Da = Df + (long long)a * n_res * N + v;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) t[cr] = fmaf(Da[(long long)cr * N], x, t[cr]);
      }
      for (int a = 0; a < n_leaves; ++a) {
        const float* Da = Df + (long long)a * n_res * N + v;
        float c = 0.f;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) c = fmaf(Da[(long long)cr * N], t[cr], c);
        acc[lunk[a]][tid] += c;
      }
    }
    for (int u = 0; u < n_unk; ++u) {
      const long long i = bs[2 * u] + (long long)v * bs[2 * u + 1];
      const float pk = hat_p(r, pprev, beta, i);
      float a = sq[i] * acc[u][tid];
      if (scs != nullptr) a = fmaf(scs[i], pk, a);
      if (p_out != nullptr) p_out[i] = pk;
      ap[i] = a;
      dot = fmaf(pk, a, dot);
    }
  }
  const float s = gblock_sum(dot, sh);
  if (tid == 0) partials[blockIdx.x] = s;
}

int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// is_double picks the element type (float or double) of v and out
extern "C" int opt_graph_gather(const void* v, const int* idx, void* out,
                                int rows, int C, int is_double,
                                void* stream) {
  const int blocks = blocks_for((long long)rows * C, kThreads);
  if (is_double)
    graph_gather_kernel<double><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)v, idx, (double*)out, rows, C);
  else
    graph_gather_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)v, idx, (float*)out, rows, C);
  return (int)cudaGetLastError();
}

extern "C" int opt_graph_scatter(const void* x, const int* order,
                                 const int* rowptr, void* out, int n, int C,
                                 int is_double, void* stream) {
  const int blocks = blocks_for((long long)n * C, kThreads);
  if (is_double)
    graph_scatter_kernel<double>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)x, order, rowptr, (double*)out, n, C);
  else
    graph_scatter_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, order, rowptr, (float*)out, n, C);
  return (int)cudaGetLastError();
}

extern "C" int opt_graph_blocks(int n) { return blocks_for(n, kGThreads); }

// pprev, beta and p_out are null together (then p = r is not written back);
// scs is null for GN
extern "C" int opt_graph_hat_apply(const float* D, const int* idx,
                                   const int* order, const int* rowptr,
                                   const int* meta, int n_meta,
                                   const float* sq, const float* scs,
                                   const float* r, const float* pprev,
                                   const float* beta, float* p_out, float* ap,
                                   float* partials, int N, void* stream) {
  if (n_meta > kMetaMax) return (int)cudaErrorInvalidValue;
  graph_hat_apply_kernel<<<opt_graph_blocks(N), kGThreads, 0,
                           (cudaStream_t)stream>>>(
      D, idx, order, rowptr, meta, n_meta, sq, scs, r, pprev, beta, p_out, ap,
      partials, N);
  return (int)cudaGetLastError();
}
