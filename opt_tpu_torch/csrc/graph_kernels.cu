// K9 graph_gather, K10 graph_scatter and K11 graph_hat_apply: the graph
// path's vertex <-> edge movement and its inner PCG apply.
//
// Replace the TPU kernels
//   K9   opt_tpu/ops/onehot_pallas.py _gather_kernel / onehot_gather_blocks:
//        out[b, e] = windows[b, loc[b, e]], a vertex -> edge gather done as
//        one-hot matmuls on split-bf16 windows of a banded (RCM-reordered)
//        vertex layout, because the TPU's matrix unit can only gather by
//        matmul.  Here a gather is a load: out[r, :] = V[idx[r], :] on the
//        flat vertex order;
//   K10  onehot_pallas.py _scatter_kernel / onehot_scatter_windows: the
//        transpose, edge -> vertex with duplicates accumulated.  Here a
//        segmented sum over the slot's incidence in CSR form (order: the
//        edges sorted by vertex, stably; rowptr: where each vertex's run
//        starts), each vertex's run summed in edge order from zero.  No
//        atomics, so the sum is the same on every call;
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
// K9 and K10 are bound by device memory: each moves whole rows of C
// values (C the channel count, 1-16 on the graph paths) and does no
// arithmetic but K10's adds.  C is a template parameter for C = 1..8 (one
// generic instantiation takes any other C), so a row's offset is a 32-bit
// multiply by a constant and no thread divides by a runtime C; every index
// is 32-bit (the wrappers refuse 2^31 elements).  A row moves as the
// widest vectors its size allows (16 bytes where 16 | C * sizeof(T), else
// 8 or 4), when both base pointers are aligned to that width; otherwise
// the generic kernel moves it one value at a time.  The vertex block is
// read through the read-only path: on the 262k mesh it is 6.3 MB and stays
// in the 50 MB L2 while the edge rows stream to and from HBM.
//   K9 runs a warp over 32 rows: each lane reads one row's index, and the
// warp writes the tile's vectors lane after lane (the source row taken by
// a shuffle, the row of a vector found by a division by the compile-time
// C), so consecutive lanes write consecutive vectors.  A gather moves
// values: the output is the plain version's bit for bit.
//   K10 runs one thread per vertex: it reads rowptr[w] and rowptr[w + 1]
// once and order[j] once per edge, loads the edge's row as vectors and
// keeps the C sums in registers, four edges' loads in flight before their
// adds, which stay in edge order.
//
// K11 is two kernels, launched in turn by one C entry on the caller's
// stream.  The JAX kernel is edge-centred (one loop over edge blocks: J p
// over the edges, then J^T v scattered to the vertices); so is the first
// pass here, and the scatter is K10's segmented sum, so nothing is atomic:
//   the edge pass (graph_hat_edge_kernel), a thread per edge e of a graph
//     group: ps = sq . (r + beta p_prev) at the edge's slot endpoints for
//     each leaf, the tangent t[cr] = sum_a D[a n_res + cr, e] ps once,
//     then c_a = sum_cr D[a n_res + cr, e] t[cr] for every leaf a, written
//     as row e of its slot's (E, L_s) buffer (L_s the leaves on slot s, in
//     leaf order).  D is (rows, E), so adjacent lanes read adjacent e: every
//     load of D is coalesced and D is read once.  The rows go through a
//     shared tile, and the block writes each slot's rows, one contiguous
//     run, as 16-byte vectors.  n_res and the leaf count are template
//     parameters for arap's shape (3, 9: D kept in registers between the
//     two loops); one generic instantiation takes any other shape up to
//     kMaxRes and kMaxLeaves and reads D again for c.  Both sum t over a
//     in leaf order and c over cr, with fused multiply-adds;
//   the vertex pass (graph_hat_vertex_kernel), a thread per vertex: per
//     group and slot, in slot order, K10's segmented sum of the slot's c
//     rows over the vertex's CSR run (L_s a template parameter for 1-8, a
//     generic chunked loop above; 2 edges' rows in flight, not K10's 4,
//     to stay inside 128 registers), added into the vertex's unknown channels
//     in column order; then the pointwise vertex terms, then p (only where
//     p_prev is given: to its own buffer, since other threads of the edge
//     pass read p_prev), A_hat p and the block partial of <p, A_hat p>.
// The edge pass's per-group constants come from the host's copy of the
// table, as a kernel argument (EdgeGroup); the vertex pass reads the device
// copy into shared memory.
//
// Bound on the card: device memory.  At 262k vertices (1,568,770 edges,
// 27 D rows an edge) D is 169.4 MB, the c rows 56.5 MB written and read
// once, idx and order 12.5 MB each: about 376 MB an apply, 112 us at 3.35
// TB/s; the vertex vectors (6.3 MB each) stay in the 50 MB L2.  At 10k
// (61,610 edges) everything sits in L2 and the two launches' latency sets
// the time.
//
// The cross-block sums are per-block partials from a fixed shared-memory
// tree, summed by the caller.  beta is read from device memory, so the host
// never waits on the reduction that made it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // K9, K10
constexpr int kEThreads = 128;  // K11's edge pass
constexpr int kGThreads = 64;   // K11's vertex pass: 10k makes 163 blocks
// K11's vertex pass holds 8 blocks (16 warps) an SM, at most 128 registers
// a thread, and keeps 2 edges' rows in flight: uncapped, its switch over
// the slot widths took 206 registers and left 8 warps an SM to hide the
// chain rowptr -> order -> row of each slot
constexpr int kGMinBlocks = 8;
constexpr int kGAhead = 2;
constexpr int kMetaMax = 1024;  // ints of K11's table (ops/graph_cuda.py)
constexpr int kMaxUnk = 16;     // unknown channels
constexpr int kMaxRes = 16;     // residual channels of one term group
constexpr int kMaxLeaves = 32;  // unknown leaves of one graph group
constexpr int kMaxSlots = 8;    // slots of one graph
constexpr int kAhead = 4;       // edges' loads in flight in a segmented sum

// the vector type that moves W values of T at once
template <typename T, int W> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

// the widest vector (at most 16 bytes) whose width divides C
template <typename T, int C> constexpr int vec_width() {
  int w = 16 / (int)sizeof(T);
  while (C % w != 0) w /= 2;
  return w;
}

template <typename T, int C> struct Row {
  static constexpr int W = vec_width<T, C>();
  static constexpr int NV = C / W;  // vectors a row
  using V = typename VecOf<T, W>::type;
};

// K9: warp k of the grid moves rows [32 k, 32 k + 32)
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
graph_gather_kernel(const T* __restrict__ v, const int* __restrict__ idx,
                         T* __restrict__ out, int rows) {
  using R = Row<T, C>;
  using V = typename R::V;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  if (r0 >= rows) return;  // the whole warp
  const int src = r0 + lane < rows ? __ldg(idx + r0 + lane) : 0;
  const int n = min(32, rows - r0) * R::NV;  // vectors in this tile
  const V* vv = reinterpret_cast<const V*>(v);
  V* dst = reinterpret_cast<V*>(out) + r0 * R::NV;
#pragma unroll
  for (int i = 0; i < R::NV; ++i) {
    const int k = lane + 32 * i;
    const int row = k / R::NV;
    const int s = __shfl_sync(0xffffffffu, src, row);
    if (k < n) dst[k] = __ldg(vv + s * R::NV + (k - row * R::NV));
  }
}

// K9 for any C, or pointers not aligned to a row's vector: thread r moves
// row r one value at a time
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_gather_generic_kernel(const T* __restrict__ v,
                            const int* __restrict__ idx, T* __restrict__ out,
                            int rows, int C) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const T* src = v + __ldg(idx + r) * C;
  T* dst = out + r * C;
  for (int c = 0; c < C; ++c) dst[c] = __ldg(src + c);
}

// K10's segmented sum of one vertex's run order[jb:je] of C-wide rows x
// into s[C], from zero in edge order; Ahead edges' rows are loaded before
// they are added.  Rows move as R::V vectors (x aligned to them)
template <typename T, int C, int Ahead = kAhead>
__device__ __forceinline__ void segment_sum(const T* __restrict__ x,
                                            const int* __restrict__ order,
                                            int jb, int je, T (&s)[C]) {
  using R = Row<T, C>;
  using V = typename R::V;
  const V* xv = reinterpret_cast<const V*>(x);
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = T(0);
  for (int j = jb; j < je; j += Ahead) {
    V q[Ahead][R::NV];
#pragma unroll
    for (int a = 0; a < Ahead; ++a) {
      if (j + a < je) {
        const V* src = xv + __ldg(order + j + a) * R::NV;
#pragma unroll
        for (int i = 0; i < R::NV; ++i) q[a][i] = __ldg(src + i);
      }
    }
#pragma unroll
    for (int a = 0; a < Ahead; ++a) {
      if (j + a < je) {
#pragma unroll
        for (int i = 0; i < R::NV; ++i) {
          const T* e = reinterpret_cast<const T*>(&q[a][i]);
#pragma unroll
          for (int u = 0; u < R::W; ++u) s[i * R::W + u] += e[u];
        }
      }
    }
  }
}

// the same for any C, kChunk channels [c0, c0 + kChunk) of the rows at a
// time, one value at a time (order[j] read once per edge and chunk)
constexpr int kChunk = 8;
template <typename T>
__device__ __forceinline__ void segment_sum_chunk(
    const T* __restrict__ x, const int* __restrict__ order, int jb, int je,
    int C, int c0, T (&s)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) s[c] = T(0);
  for (int j = jb; j < je; ++j) {
    const T* src = x + __ldg(order + j) * C + c0;
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (c0 + c < C) s[c] += __ldg(src + c);
  }
}

// K10: thread w sums vertex w's run
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
graph_scatter_kernel(const T* __restrict__ x, const int* __restrict__ order,
                     const int* __restrict__ rowptr, T* __restrict__ out,
                     int n) {
  using R = Row<T, C>;
  using V = typename R::V;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= n) return;
  T s[C];
  segment_sum<T, C>(x, order, __ldg(rowptr + w), __ldg(rowptr + w + 1), s);
  V* dst = reinterpret_cast<V*>(out) + w * R::NV;
#pragma unroll
  for (int i = 0; i < R::NV; ++i) {
    V q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int u = 0; u < R::W; ++u) e[u] = s[i * R::W + u];
    dst[i] = q;
  }
}

// K10 for any C, or pointers not aligned to a row's vector: thread w sums
// vertex w's run kChunk channels at a time
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_scatter_generic_kernel(const T* __restrict__ x,
                             const int* __restrict__ order,
                             const int* __restrict__ rowptr,
                             T* __restrict__ out, int n, int C) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= n) return;
  const int jb = __ldg(rowptr + w), je = __ldg(rowptr + w + 1);
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    T s[kChunk];
    segment_sum_chunk<T>(x, order, jb, je, C, c0, s);
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (c0 + c < C) out[w * C + c0 + c] = s[c];
  }
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
                                       float beta, int i) {
  return pprev != nullptr ? fmaf(beta, pprev[i], r[i]) : r[i];
}

// meta (int32), as ops/graph_cuda.py HatTables writes it:
//   [0] n_unk  [1] n_graph  [2] has_fit
//   per unknown channel u: base_u, stride_u (element i of channel u at
//     vertex w is base_u + w stride_u in the flat vectors)
//   per graph group: E, n_slots, n_res, n_leaves, d_off (into D), i_off
//     (into idx and order: slot s at i_off + s E), rp_off (into rowptr:
//     slot s at rp_off + s (N + 1)), leaf_slot[n_leaves],
//     leaf_unk[n_leaves], then per slot s: c_off (into the c rows, a
//     multiple of 4), L_s, and the unknown channel of each of its L_s
//     columns (the slot's leaves in leaf order)
//   if has_fit: n_res, n_leaves, d_off, leaf_unk[n_leaves]
// D rows are a n_res + cr for leaf a and residual channel cr, each row E
// (graph group) or N (vertex group) long.

// one graph group as the edge pass reads it, from the host's table
struct EdgeGroup {
  int E, n_res, n_leaves, n_slots, d_off, i_off;
  // per leaf: its slot, where its value lies in the block's tile (thread
  // tid's at ltile + tid lwidth), and where its unknown channel lies in the
  // flat vectors (base + w stride)
  int lslot[kMaxLeaves], ltile[kMaxLeaves], lwidth[kMaxLeaves],
      lbase[kMaxLeaves], lstride[kMaxLeaves];
  // per slot: L_s, c_off, and where its rows start in the block's tile
  int width[kMaxSlots], c_off[kMaxSlots], tile_off[kMaxSlots];
};

// K11's edge pass: thread e of the group forms e's tangent and its leaves'
// c_a; NR and NL are n_res and n_leaves, or 0 for any (the generic kernel)
template <int NR, int NL>
__global__ void __launch_bounds__(kEThreads)
graph_hat_edge_kernel(const __grid_constant__ EdgeGroup g,
                      const float* __restrict__ D,
                      const int* __restrict__ idx,
                      const float* __restrict__ sq,
                      const float* __restrict__ r,
                      const float* __restrict__ pprev,
                      const float* __restrict__ beta_ptr,
                      float* __restrict__ c) {
  __shared__ __align__(16) float tile[kEThreads * (NL > 0 ? NL : kMaxLeaves)];
  const int E = g.E;
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kEThreads;
  const int e = e0 + tid;
  const float beta = pprev != nullptr ? __ldg(beta_ptr) : 0.f;
  if (e < E) {
    const float* De = D + g.d_off + e;
    const int* ie = idx + g.i_off + e;
    if constexpr (NR > 0 && NL > 0) {
      float d[NL][NR], t[NR];
#pragma unroll
      for (int cr = 0; cr < NR; ++cr) t[cr] = 0.f;
#pragma unroll
      for (int a = 0; a < NL; ++a) {
        const int i = g.lbase[a] + __ldg(ie + g.lslot[a] * E) * g.lstride[a];
        const float x = __ldg(sq + i) * hat_p(r, pprev, beta, i);
#pragma unroll
        for (int cr = 0; cr < NR; ++cr) {
          d[a][cr] = __ldg(De + (a * NR + cr) * E);
          t[cr] = fmaf(d[a][cr], x, t[cr]);
        }
      }
#pragma unroll
      for (int a = 0; a < NL; ++a) {
        float ca = 0.f;
#pragma unroll
        for (int cr = 0; cr < NR; ++cr) ca = fmaf(d[a][cr], t[cr], ca);
        tile[g.ltile[a] + tid * g.lwidth[a]] = ca;
      }
    } else {
      const int n_res = g.n_res;
      float t[kMaxRes];
#pragma unroll
      for (int cr = 0; cr < kMaxRes; ++cr) t[cr] = 0.f;
      for (int a = 0; a < g.n_leaves; ++a) {
        const int i = g.lbase[a] + __ldg(ie + g.lslot[a] * E) * g.lstride[a];
        const float x = __ldg(sq + i) * hat_p(r, pprev, beta, i);
        const float* Da = De + a * n_res * E;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) t[cr] = fmaf(__ldg(Da + cr * E), x, t[cr]);
      }
      for (int a = 0; a < g.n_leaves; ++a) {
        const float* Da = De + a * n_res * E;
        float ca = 0.f;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) ca = fmaf(__ldg(Da + cr * E), t[cr], ca);
        tile[g.ltile[a] + tid * g.lwidth[a]] = ca;
      }
    }
  }
  __syncthreads();
  // each slot's rows [e0, e0 + rows) are one contiguous run of its buffer;
  // both ends 16-byte aligned (c_off % 4 == 0, kEThreads % 4 == 0)
  const int rows = min(kEThreads, E - e0);
  for (int s = 0; s < g.n_slots; ++s) {
    const int n = rows * g.width[s];
    const float* src = tile + g.tile_off[s];
    float* dst = c + g.c_off[s] + e0 * g.width[s];
    const int n4 = n / 4;
    for (int k = tid; k < n4; k += kEThreads)
      reinterpret_cast<float4*>(dst)[k] =
          reinterpret_cast<const float4*>(src)[k];
    for (int k = 4 * n4 + tid; k < n; k += kEThreads) dst[k] = src[k];
  }
}

// add the vertex's segmented sums of one slot's (E, L) c rows into its
// unknown channels' accumulators, column k into channel col_unk[k]
template <int L>
__device__ __forceinline__ void add_slot(const float* __restrict__ cs,
                                         const int* __restrict__ order,
                                         int jb, int je, const int* col_unk,
                                         float (*acc)[kGThreads], int tid) {
  float s[L];
  segment_sum<float, L, kGAhead>(cs, order, jb, je, s);
#pragma unroll
  for (int k = 0; k < L; ++k) acc[col_unk[k]][tid] += s[k];
}

__device__ __forceinline__ void add_slot_any(const float* __restrict__ cs,
                                             const int* __restrict__ order,
                                             int jb, int je, int L,
                                             const int* col_unk,
                                             float (*acc)[kGThreads],
                                             int tid) {
  switch (L) {
    case 0: return;
    case 1: return add_slot<1>(cs, order, jb, je, col_unk, acc, tid);
    case 2: return add_slot<2>(cs, order, jb, je, col_unk, acc, tid);
    case 3: return add_slot<3>(cs, order, jb, je, col_unk, acc, tid);
    case 4: return add_slot<4>(cs, order, jb, je, col_unk, acc, tid);
    case 5: return add_slot<5>(cs, order, jb, je, col_unk, acc, tid);
    case 6: return add_slot<6>(cs, order, jb, je, col_unk, acc, tid);
    case 7: return add_slot<7>(cs, order, jb, je, col_unk, acc, tid);
    case 8: return add_slot<8>(cs, order, jb, je, col_unk, acc, tid);
    default:
      for (int k0 = 0; k0 < L; k0 += kChunk) {
        float s[kChunk];
        segment_sum_chunk<float>(cs, order, jb, je, L, k0, s);
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k0 + k < L) acc[col_unk[k0 + k]][tid] += s[k];
      }
  }
}

// K11's vertex pass: thread v sums its slots' c rows, adds the pointwise
// vertex terms, and writes p, A_hat p and the block partial of <p, A_hat p>
__global__ void __launch_bounds__(kGThreads, kGMinBlocks)
graph_hat_vertex_kernel(const float* __restrict__ D,
                        const int* __restrict__ order,
                        const int* __restrict__ rowptr,
                        const float* __restrict__ c,
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
      const int n_leaves = meta[pos + 3];
      const int* og = order + meta[pos + 5];
      const int* rg = rowptr + meta[pos + 6];
      pos += 7 + 2 * n_leaves;
      for (int s = 0; s < n_slots; ++s) {
        const int L = meta[pos + 1];
        const int* rp = rg + s * (N + 1);
        add_slot_any(c + meta[pos], og + s * E, __ldg(rp + v),
                     __ldg(rp + v + 1), L, meta + pos + 2, acc, tid);
        pos += 2 + L;
      }
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
        const int i = bs[2 * u] + v * bs[2 * u + 1];
        const float x = sq[i] * hat_p(r, pprev, beta, i);
        const float* Da = Df + a * n_res * N + v;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) t[cr] = fmaf(Da[cr * N], x, t[cr]);
      }
      for (int a = 0; a < n_leaves; ++a) {
        const float* Da = Df + a * n_res * N + v;
        float ca = 0.f;
#pragma unroll
        for (int cr = 0; cr < kMaxRes; ++cr)
          if (cr < n_res) ca = fmaf(Da[cr * N], t[cr], ca);
        acc[lunk[a]][tid] += ca;
      }
    }
    for (int u = 0; u < n_unk; ++u) {
      const int i = bs[2 * u] + v * bs[2 * u + 1];
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

bool aligned(const void* a, const void* b, int bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          bytes) == 0;
}

template <typename T, int C>
void gather_rows(const T* v, const int* idx, T* out, int rows,
                 cudaStream_t st) {
  constexpr int bytes = Row<T, C>::W * (int)sizeof(T);
  const int blocks = blocks_for(rows, kThreads);
  if (aligned(v, out, bytes))
    graph_gather_kernel<T, C><<<blocks, kThreads, 0, st>>>(v, idx, out, rows);
  else
    graph_gather_generic_kernel<T><<<blocks, kThreads, 0, st>>>(v, idx, out,
                                                                rows, C);
}

template <typename T>
void gather_any(const T* v, const int* idx, T* out, int rows, int C,
                cudaStream_t st) {
  switch (C) {
    case 1: return gather_rows<T, 1>(v, idx, out, rows, st);
    case 2: return gather_rows<T, 2>(v, idx, out, rows, st);
    case 3: return gather_rows<T, 3>(v, idx, out, rows, st);
    case 4: return gather_rows<T, 4>(v, idx, out, rows, st);
    case 5: return gather_rows<T, 5>(v, idx, out, rows, st);
    case 6: return gather_rows<T, 6>(v, idx, out, rows, st);
    case 7: return gather_rows<T, 7>(v, idx, out, rows, st);
    case 8: return gather_rows<T, 8>(v, idx, out, rows, st);
    default:
      graph_gather_generic_kernel<T>
          <<<blocks_for(rows, kThreads), kThreads, 0, st>>>(v, idx, out, rows,
                                                            C);
  }
}

template <typename T, int C>
void scatter_rows(const T* x, const int* order, const int* rowptr, T* out,
                  int n, cudaStream_t st) {
  constexpr int bytes = Row<T, C>::W * (int)sizeof(T);
  const int blocks = blocks_for(n, kThreads);
  if (aligned(x, out, bytes))
    graph_scatter_kernel<T, C><<<blocks, kThreads, 0, st>>>(x, order, rowptr,
                                                            out, n);
  else
    graph_scatter_generic_kernel<T><<<blocks, kThreads, 0, st>>>(
        x, order, rowptr, out, n, C);
}

template <typename T>
void scatter_any(const T* x, const int* order, const int* rowptr, T* out,
                 int n, int C, cudaStream_t st) {
  switch (C) {
    case 1: return scatter_rows<T, 1>(x, order, rowptr, out, n, st);
    case 2: return scatter_rows<T, 2>(x, order, rowptr, out, n, st);
    case 3: return scatter_rows<T, 3>(x, order, rowptr, out, n, st);
    case 4: return scatter_rows<T, 4>(x, order, rowptr, out, n, st);
    case 5: return scatter_rows<T, 5>(x, order, rowptr, out, n, st);
    case 6: return scatter_rows<T, 6>(x, order, rowptr, out, n, st);
    case 7: return scatter_rows<T, 7>(x, order, rowptr, out, n, st);
    case 8: return scatter_rows<T, 8>(x, order, rowptr, out, n, st);
    default:
      graph_scatter_generic_kernel<T>
          <<<blocks_for(n, kThreads), kThreads, 0, st>>>(x, order, rowptr,
                                                         out, n, C);
  }
}

}  // namespace

// is_double picks the element type (float or double) of v and out
extern "C" int opt_graph_gather(const void* v, const int* idx, void* out,
                                int rows, int C, int is_double,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    gather_any((const double*)v, idx, (double*)out, rows, C, st);
  else
    gather_any((const float*)v, idx, (float*)out, rows, C, st);
  return (int)cudaGetLastError();
}

extern "C" int opt_graph_scatter(const void* x, const int* order,
                                 const int* rowptr, void* out, int n, int C,
                                 int is_double, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    scatter_any((const double*)x, order, rowptr, (double*)out, n, C, st);
  else
    scatter_any((const float*)x, order, rowptr, (float*)out, n, C, st);
  return (int)cudaGetLastError();
}

extern "C" int opt_graph_blocks(int n) { return blocks_for(n, kGThreads); }

namespace {

// K11's edge pass over every graph group of the host's table hm: one
// launch a group, arap's shape on its own instantiation
int hat_edge(const float* D, const int* idx, const int* hm, int n_meta,
             const float* sq, const float* r, const float* pprev,
             const float* beta, float* c, cudaStream_t st) {
  if (n_meta > kMetaMax) return (int)cudaErrorInvalidValue;
  const int n_unk = hm[0];
  const int* bs = hm + 3;
  int pos = 3 + 2 * n_unk;
  for (int gi = 0; gi < hm[1]; ++gi) {
    EdgeGroup g;
    g.E = hm[pos];
    g.n_slots = hm[pos + 1];
    g.n_res = hm[pos + 2];
    g.n_leaves = hm[pos + 3];
    g.d_off = hm[pos + 4];
    g.i_off = hm[pos + 5];
    if (g.n_res > kMaxRes || g.n_leaves > kMaxLeaves ||
        g.n_slots > kMaxSlots)
      return (int)cudaErrorInvalidValue;
    const int* lslot = hm + pos + 7;
    const int* lunk = lslot + g.n_leaves;
    pos += 7 + 2 * g.n_leaves;
    int tile = 0;
    for (int s = 0; s < g.n_slots; ++s) {
      g.c_off[s] = hm[pos];
      g.width[s] = hm[pos + 1];
      g.tile_off[s] = tile;
      tile += kEThreads * g.width[s];
      pos += 2 + g.width[s];
    }
    int col[kMaxSlots] = {};
    for (int a = 0; a < g.n_leaves; ++a) {
      const int s = lslot[a];
      g.lslot[a] = s;
      g.ltile[a] = g.tile_off[s] + col[s]++;
      g.lwidth[a] = g.width[s];
      g.lbase[a] = bs[2 * lunk[a]];
      g.lstride[a] = bs[2 * lunk[a] + 1];
    }
    const int blocks = blocks_for(g.E, kEThreads);
    if (blocks == 0) continue;
    if (g.n_res == 3 && g.n_leaves == 9)
      graph_hat_edge_kernel<3, 9><<<blocks, kEThreads, 0, st>>>(
          g, D, idx, sq, r, pprev, beta, c);
    else
      graph_hat_edge_kernel<0, 0><<<blocks, kEThreads, 0, st>>>(
          g, D, idx, sq, r, pprev, beta, c);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

int hat_vertex(const float* D, const int* order, const int* rowptr,
               const float* c, const int* meta, int n_meta, const float* sq,
               const float* scs, const float* r, const float* pprev,
               const float* beta, float* p_out, float* ap, float* partials,
               int N, cudaStream_t st) {
  if (n_meta > kMetaMax || !aligned(c, c, 16))
    return (int)cudaErrorInvalidValue;
  graph_hat_vertex_kernel<<<blocks_for(N, kGThreads), kGThreads, 0, st>>>(
      D, order, rowptr, c, meta, n_meta, sq, scs, r, pprev, beta, p_out, ap,
      partials, N);
  return (int)cudaGetLastError();
}

}  // namespace

// K11's two passes alone (the checks hold each against its plain version):
// the edge pass writes c; the vertex pass reads it.  meta is the table on
// the device, meta_host the same table on the host.  pprev, beta and p_out
// are null together (then p = r is not written back); scs is null for GN.
extern "C" int opt_graph_hat_edge(const float* D, const int* idx,
                                  const int* meta_host, int n_meta,
                                  const float* sq, const float* r,
                                  const float* pprev, const float* beta,
                                  float* c, void* stream) {
  return hat_edge(D, idx, meta_host, n_meta, sq, r, pprev, beta, c,
                  (cudaStream_t)stream);
}

extern "C" int opt_graph_hat_vertex(const float* D, const int* order,
                                    const int* rowptr, const float* c,
                                    const int* meta, int n_meta,
                                    const float* sq, const float* scs,
                                    const float* r, const float* pprev,
                                    const float* beta, float* p_out,
                                    float* ap, float* partials, int N,
                                    void* stream) {
  return hat_vertex(D, order, rowptr, c, meta, n_meta, sq, scs, r, pprev,
                    beta, p_out, ap, partials, N, (cudaStream_t)stream);
}

// the apply: both passes in turn on the caller's stream, c (the edge
// rows) and partials (opt_graph_blocks(N) floats) scratch that the caller
// owns; the first launch error is returned, and a failed edge pass
// launches no vertex pass
extern "C" int opt_graph_hat_apply(const float* D, const int* idx,
                                   const int* order, const int* rowptr,
                                   const int* meta, const int* meta_host,
                                   int n_meta, const float* sq,
                                   const float* scs, const float* r,
                                   const float* pprev, const float* beta,
                                   float* p_out, float* ap, float* c,
                                   float* partials, int N, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = hat_edge(D, idx, meta_host, n_meta, sq, r, pprev, beta, c,
                           st);
  if (err != 0) return err;
  return hat_vertex(D, order, rowptr, c, meta, n_meta, sq, scs, r, pprev,
                    beta, p_out, ap, partials, N, st);
}
