// GAT's message passing over the CSR on Hopper: the edge softmax, its
// backward, and the SDDMM of the attention weights' gradient. (The per-head
// weighted sum itself is spmm.cu::spmm_csr_heads.)
//
// These are not ports of a TPU kernel: the JAX package computes the same
// functions outside any Pallas kernel, with segment_max / segment_sum
// (src/repro/models/gnn/blocks.py:132 edge_softmax, and the gathers and
// leaky_relu of src/repro/models/gnn/models.py:131-142), and their gradients
// by autodiff. Per destination row r and head h, over the row's CSR edges e
// (source col[e]):
//
//   gat_softmax      x_e = s_src[col_e, h] + s_dst[r, h],
//                    score_e = x_e >= 0 ? x_e : 0.2 * x_e,
//                    m = max_e score_e, ex_e = exp(score_e - m),
//                    z = sum_e ex_e, alpha_e = ex_e / max(z, 1e-16)
//   gat_softmax_bwd  mode 0 (the forward CSR): c = sum_e alpha_e * dalpha_e,
//                    dx_e = alpha_e * (dalpha_e - c) * (x_e >= 0 ? 1 : 0.2),
//                    d s_dst[r, h] = sum_e dx_e;
//                    mode 1 (the transposed CSR, edge e' of row c standing
//                    for forward edge perm[e']): d s_src[c, h] =
//                    sum_e' dx[perm[e'], h]
//   sddmm_heads      dalpha[e, h] = sum_{k < dh} dout[r, h*dh + k] *
//                                   table[col_e, h*dh + k], k in order.
//
// What bounds them on an H100: bytes. Per edge and head the softmax does a
// handful of flops and an expf against 4-byte gathers and writes. The SDDMM
// does 2*dh flops per (edge, head) against the dh floats of the gathered
// row table[col_e]: nnz * d * 4 bytes of gathers (1.66 GB for GAT 4x64 on
// reddit_like@paper), 0.5 flop/byte. Its least traffic (one read of the
// table, g and the CSR, one write of dalpha) is some 10x less, but a row is
// read once per edge that names it, and only what L2 (50 MB) still holds of
// the 100 MB table comes back cheaply: the rate to aim at is that of
// spmm_csr_heads, which gathers the same bytes.
//
// Design. The rules of spmm.cu: no atomics, and every sum in an order the
// CSR alone fixes, through the same host work plan (ref.py::split_plan). A
// row of at most SEGMENT edges sums from 0 edge by edge in CSR order; a
// longer (hub) row sums each SEGMENT-edge segment so and adds the partials
// left to right. The plain versions in repro_torch/kernels/gat/ref.py follow
// the same order, and the products and adds round separately (__fmul_rn,
// __fadd_rn; the library is built with -fmad=false). expf, not __expf.
//   * rows of at most SEGMENT edges: one warp per work unit. The lanes take
//     32 edges at a time (all H heads each) and compute their terms in
//     parallel; a maximum is a warp reduction (exact in any order); a sum
//     runs edge by edge over the 32 lanes' terms by shuffles, every lane
//     keeping the same running sum;
//   * hub rows (their units are segments): one block of kHubWarps warps per
//     row, a warp per segment. Each segment's maximum or sum goes to a
//     partial slot of the plan, the block combines the partials (left to
//     right for a sum) and, for the softmax, every warp then normalizes its
//     own segments. So a hub no longer runs serially on one warp, and needs
//     no second launch;
//   * SDDMM: a block of one warp per work unit. A thread that read its own
//     (edge, head) slice from global memory made a warp's load touch 32
//     rows, 16 bytes each, so every 32-byte sector came through L1 once per
//     16 iterations: 2.6 TB/s of gathers. Instead the warp stages batches
//     of 32 / H edges' rows in shared memory, double-buffered so one batch
//     is in flight while the last is summed, and g's row once per unit;
//     thread (edge, head) then sums its dh products in k order from shared
//     memory, the rows padded so that the 8 lanes of a cycle, 8 edges of
//     one head, read 8 different bank groups. The copies are bulk copies
//     of the Tensor Memory Accelerator, one per edge's row, completing on
//     an mbarrier per stage: with 16-byte cp.async copies (neighbouring
//     lanes on neighbouring pieces) the copies alone took the kernel's
//     whole time, also from a table that L2 held; and one warp per block,
//     not four, lets a finished unit's slot refill without waiting for its
//     block's longest unit. Head slices longer than kChunk floats are
//     staged in chunks, the sum carried over, so shared memory stays
//     bounded. dh not a multiple of 4, or pointers not 16-byte aligned,
//     take 4-byte cp.async copies. A segment unit finds its row through the
//     plan's long rows.
// The kernels allocate nothing; the wrappers pass outputs and the partials'
// workspace (n_partials, H).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kHubWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSoftmax = 0, kSoftmaxBwd = 1, kRowSum = 2 };

struct RowArgs {
  const int* row_ptr;
  const int* col;
  const int* units;
  int n_units;
  const int* long_rows;
  const int* long_ptr;
  int n_long;
  int segment;
  int n_rows;
  const float* s_src;   // kSoftmax, kSoftmaxBwd: (n_src, H)
  const float* s_dst;   // kSoftmax, kSoftmaxBwd: (n_rows, H)
  const float* alpha;   // kSoftmaxBwd: (nnz, H)
  const float* dalpha;  // kSoftmaxBwd: (nnz, H)
  const float* vals;    // kRowSum: (nnz, H), forward edge order
  const int* perm;      // kRowSum: (nnz,) edge -> forward edge
  float* edge_out;      // kSoftmax: alpha; kSoftmaxBwd: dx   (nnz, H)
  float* row_out;       // kSoftmaxBwd: d s_dst; kRowSum: d s_src (n_rows, H)
  float* part;          // (n_partials, H)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : __fmul_rn(0.2f, x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// x = s_src[col_e] + s_dst[r], all heads.
template <int H>
__device__ __forceinline__ void load_x(const RowArgs& a, int e, int r,
                                       float (&x)[H]) {
  const int64_t c = __ldg(a.col + e);
#pragma unroll
  for (int h = 0; h < H; ++h)
    x[h] = __fadd_rn(__ldg(a.s_src + c * H + h),
                     __ldg(a.s_dst + (int64_t)r * H + h));
}

// acc[h] = (...(acc[h] + v[h] of lane 0) + v[h] of lane 1) ... + lane n-1.
template <int H>
__device__ __forceinline__ void add_in_order(float (&acc)[H],
                                             const float (&v)[H], int n) {
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      acc[h] = __fadd_rn(acc[h], __shfl_sync(kFull, v[h], j));
  }
}

// One warp over the edges [e0, e1) of row r (a whole row or a segment).
// PASS 1: the first reduction (kSoftmax: max of the scores; kSoftmaxBwd:
//   sum of alpha * dalpha). PASS 2: the per-edge terms, written to edge_out
//   (kSoftmax: exp(score - red[h]); kSoftmaxBwd: dx), and their sum
//   (kRowSum: the sum of vals[perm[e]]). PASS 3 (kSoftmax): edge_out /= red.
// Every lane returns the same acc.
template <int OP, int H, int PASS>
__device__ void run_range(const RowArgs& a, int e0, int e1, int r,
                          const float (&red)[H], float (&acc)[H]) {
  const int lane = threadIdx.x & 31;
  const bool is_max = OP == kSoftmax && PASS == 1;
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = is_max ? neg_inf() : 0.f;
  for (int eb = e0; eb < e1; eb += 32) {
    const int n = e1 - eb < 32 ? e1 - eb : 32;
    const int e = eb + lane;
    float v[H];
#pragma unroll
    for (int h = 0; h < H; ++h) v[h] = 0.f;
    if (lane < n) {
      const int64_t eh = (int64_t)e * H;
      if constexpr (OP == kRowSum) {
        const int64_t ph = (int64_t)__ldg(a.perm + e) * H;
#pragma unroll
        for (int h = 0; h < H; ++h) v[h] = __ldg(a.vals + ph + h);
      } else if constexpr (OP == kSoftmax && PASS == 3) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          a.edge_out[eh + h] = __fdiv_rn(a.edge_out[eh + h], red[h]);
      } else if constexpr (OP == kSoftmaxBwd && PASS == 1) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          v[h] = __fmul_rn(__ldg(a.alpha + eh + h), __ldg(a.dalpha + eh + h));
      } else {
        float x[H];
        load_x<H>(a, e, r, x);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if constexpr (OP == kSoftmax && PASS == 1) {
            acc[h] = fmaxf(acc[h], leaky(x[h]));
          } else if constexpr (OP == kSoftmax) {
            v[h] = expf(__fsub_rn(leaky(x[h]), red[h]));
            a.edge_out[eh + h] = v[h];
          } else {
            float dx = __fmul_rn(__ldg(a.alpha + eh + h),
                                 __fsub_rn(__ldg(a.dalpha + eh + h), red[h]));
            if (x[h] < 0.f) dx = __fmul_rn(0.2f, dx);
            v[h] = dx;
            a.edge_out[eh + h] = dx;
          }
        }
      }
    }
    if constexpr (!(OP == kSoftmax && PASS != 2)) add_in_order<H>(acc, v, n);
  }
  if constexpr (OP == kSoftmax && PASS == 1) {
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = warp_max(acc[h]);
  }
}

// The whole-row units (target < n_rows), one warp each; segment units are
// left to rows_hub_kernel.
template <int OP, int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rows_unit_kernel(RowArgs a) {
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= a.n_units) return;
  const int e0 = __ldg(a.units + 3 * unit);
  const int e1 = __ldg(a.units + 3 * unit + 1);
  const int r = __ldg(a.units + 3 * unit + 2);
  if (r >= a.n_rows) return;
  float red1[H] = {}, red2[H];
  if constexpr (OP != kRowSum) run_range<OP, H, 1>(a, e0, e1, r, red1, red1);
  run_range<OP, H, 2>(a, e0, e1, r, red1, red2);
  if constexpr (OP == kSoftmax) {
#pragma unroll
    for (int h = 0; h < H; ++h) red2[h] = fmaxf(red2[h], 1e-16f);
    run_range<OP, H, 3>(a, e0, e1, r, red2, red1);
  } else if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) a.row_out[(int64_t)r * H + h] = red2[h];
  }
}

// Hub row long_rows[blockIdx.x]: its segments k = 0, 1, ... (edges
// [rb + k*segment, min(rb + (k+1)*segment, re))), partial slots
// long_ptr[i] + k; warp w takes segments w, w + kHubWarps, ...
template <int OP, int H>
__global__ void __launch_bounds__(kHubWarps * 32)
rows_hub_kernel(RowArgs a) {
  __shared__ float red_s[H];
  const int i = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = __ldg(a.long_rows + i);
  const int s0 = __ldg(a.long_ptr + i), ns = __ldg(a.long_ptr + i + 1) - s0;
  const int rb = __ldg(a.row_ptr + r), re = __ldg(a.row_ptr + r + 1);
  float red1[H] = {}, p[H];
  if constexpr (OP != kRowSum) {
    for (int k = warp; k < ns; k += kHubWarps) {
      const int e0 = rb + k * a.segment;
      const int e1 = e0 + a.segment < re ? e0 + a.segment : re;
      run_range<OP, H, 1>(a, e0, e1, r, red1, p);
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < H; ++h) a.part[(int64_t)(s0 + k) * H + h] = p[h];
      }
    }
    __syncthreads();
    if (threadIdx.x < H) {
      const int h = threadIdx.x;
      float acc = a.part[(int64_t)s0 * H + h];
      for (int k = 1; k < ns; ++k) {
        const float q = a.part[(int64_t)(s0 + k) * H + h];
        acc = OP == kSoftmax ? fmaxf(acc, q) : __fadd_rn(acc, q);
      }
      red_s[h] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < H; ++h) red1[h] = red_s[h];
    __syncthreads();  // red_s is written again below
  }
  for (int k = warp; k < ns; k += kHubWarps) {
    const int e0 = rb + k * a.segment;
    const int e1 = e0 + a.segment < re ? e0 + a.segment : re;
    run_range<OP, H, 2>(a, e0, e1, r, red1, p);
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) a.part[(int64_t)(s0 + k) * H + h] = p[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < H) {
    const int h = threadIdx.x;
    float acc = a.part[(int64_t)s0 * H + h];
    for (int k = 1; k < ns; ++k)
      acc = __fadd_rn(acc, a.part[(int64_t)(s0 + k) * H + h]);
    if (OP == kSoftmax) red_s[h] = fmaxf(acc, 1e-16f);
    else a.row_out[(int64_t)r * H + h] = acc;
  }
  if constexpr (OP == kSoftmax) {
    __syncthreads();
    float z[H];
#pragma unroll
    for (int h = 0; h < H; ++h) z[h] = red_s[h];
    for (int k = warp; k < ns; k += kHubWarps) {
      const int e0 = rb + k * a.segment;
      const int e1 = e0 + a.segment < re ? e0 + a.segment : re;
      run_range<OP, H, 3>(a, e0, e1, r, z, p);
    }
  }
}

template <int OP, int H>
int launch_rows(const RowArgs& a, cudaStream_t s) {
  if (a.n_units > 0) {
    const unsigned grid = (unsigned)((a.n_units + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
    rows_unit_kernel<OP, H><<<grid, kWarpsPerBlock * 32, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_long > 0)
    rows_hub_kernel<OP, H><<<(unsigned)a.n_long, kHubWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int OP>
int dispatch_heads(const RowArgs& a, int n_heads, cudaStream_t s) {
  switch (n_heads) {
    case 1: return launch_rows<OP, 1>(a, s);
    case 2: return launch_rows<OP, 2>(a, s);
    case 4: return launch_rows<OP, 4>(a, s);
    case 8: return launch_rows<OP, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

RowArgs plan_args(const int* row_ptr, const int* col, const int* units,
                  int n_units, const int* long_rows, const int* long_ptr,
                  int n_long, int segment, int n_rows, float* part) {
  RowArgs a = {};
  a.row_ptr = row_ptr;
  a.col = col;
  a.units = units;
  a.n_units = n_units;
  a.long_rows = long_rows;
  a.long_ptr = long_ptr;
  a.n_long = n_long;
  a.segment = segment;
  a.n_rows = n_rows;
  a.part = part;
  return a;
}

// --- SDDMM ------------------------------------------------------------------
constexpr int kChunk = 64;        // floats of a head slice staged at a time
constexpr int kStages = 2;        // batches staged at once (a ring)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// The floats from one staged piece of len floats to the next. The aligned
// path reads float4, 8 lanes a shared-memory cycle: an odd number of 16-byte
// units puts 8 neighbouring pieces in 8 different groups of 4 banks. The
// scalar path reads floats: an odd pitch puts neighbouring pieces in
// different banks.
__host__ __device__ __forceinline__ int slice_pitch(int len, int vec) {
  return vec == 4 ? 4 * (((len + 3) / 4) | 1) : (len | 1);
}

// A block's shared memory, in floats: kStages mbarriers (16 bytes kept for
// each), g's row (H slices of dh, padded) and kStages batches of 32 / H
// edges, each edge's H chunks of kc floats side by side, padded.
__host__ __device__ __forceinline__ int sddmm_smem_floats(int n_heads, int dh,
                                                          int vec) {
  const int kc = dh < kChunk ? dh : kChunk;
  return 4 * kStages + n_heads * slice_pitch(dh, vec) +
         kStages * (32 / n_heads) * slice_pitch(n_heads * kc, vec);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The scalar path: a 4-byte asynchronous copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// The aligned path: one bulk copy by the Tensor Memory Accelerator, bytes a
// multiple of 16, both addresses 16-byte aligned; its completion counts
// against the mbarrier bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// dalpha[e, h] = sum_k g[r, h*dh + k] * table[col_e, h*dh + k] for the
// edges of the block's unit; the block is one warp. A stage is a batch of
// kEdges = 32 / H edges and one chunk [k0, k0 + kc) of every head: 32 (edge,
// head) slices, thread t's that of edge t % kEdges, head t / kEdges, so the
// 8 lanes of a shared-memory cycle read 8 edges' rows. The warp stages the
// gathered rows kStages batches ahead while it sums: on the aligned path
// (VEC 4) with bulk copies, a lane per edge (its whole row, where one chunk
// holds the head) or per slice, counted by an mbarrier per stage; on the
// scalar path with 4-byte cp.async, neighbouring lanes on neighbouring
// floats. g's row r is staged once per unit. Thread t sums its slice's
// products in k order, carrying its sum from chunk to chunk, and writes it
// after the last: the order of sddmm_heads_ref.
template <int H, int VEC>
__global__ void __launch_bounds__(32)
sddmm_kernel(const float* __restrict__ g, const float* __restrict__ table,
             const int* __restrict__ col, const int* __restrict__ units,
             const int* __restrict__ long_rows,
             const int* __restrict__ long_ptr, int n_long,
             float* __restrict__ out, int n_rows, int dh) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  constexpr int kEdges = 32 / H;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, unit = blockIdx.x;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
  if (e0 >= e1) return;  // an empty row: no edge, nothing to write
  int r = __ldg(units + 3 * unit + 2);
  if (r >= n_rows) {  // a segment: its row is the long row holding the slot
    const int slot = r - n_rows;
    int lo = 0, hi = n_long - 1;  // the last i with long_ptr[i] <= slot
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(long_ptr + mid) <= slot) lo = mid; else hi = mid - 1;
    }
    r = __ldg(long_rows + lo);
  }
  const int d = H * dh;
  const int kc = dh < kChunk ? dh : kChunk;
  const int gp = slice_pitch(dh, VEC), ep = slice_pitch(H * kc, VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* g_s = smem + 4 * kStages;
  float* buf = g_s + H * gp;  // stage s in buf + (s % kStages) * kEdges * ep
  const int n_chunks = (dh + kc - 1) / kc;
  const int n_stages = (e1 - e0 + kEdges - 1) / kEdges * n_chunks;
  const float* grow = g + (int64_t)r * d;
  if (VEC == 4 && lane == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(bars + k)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (VEC == 1) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      for (int k = lane; k < dh; k += 32)
        cp_async4(g_s + h * gp + k, grow + h * dh + k);
  }

  int my_c = 0;  // the column of edge (window start) + lane
  auto issue = [&](int s) {
    const int b = s / n_chunks, k0 = (s - b * n_chunks) * kc;
    const int eb = e0 + b * kEdges;
    const int nb = e1 - eb < kEdges ? e1 - eb : kEdges;
    if (k0 == 0 && (b * kEdges & 31) == 0)  // a new window of 32 edges
      my_c = eb + lane < e1 ? __ldg(col + eb + lane) : 0;
    const int len = dh - k0 < kc ? dh - k0 : kc;
    const int base = b * kEdges & 31;  // the batch's first lane in the window
    float* dst = buf + (s % kStages) * kEdges * ep;
    if constexpr (VEC == 4) {
      uint64_t* bar = bars + s % kStages;
      if (lane == 0)
        bar_expect(bar, nb * H * len * 4 + (s == 0 ? d * 4 : 0));
      __syncwarp();
      if (kc == dh) {  // an edge's H chunks are its whole row: one copy
        const int c = __shfl_sync(kFull, my_c, (base + lane) & 31);
        if (lane < nb)
          bulk_copy(dst + lane * ep, table + (int64_t)c * d, d * 4, bar);
      } else {         // a copy per (edge lane / H, head lane % H)
        const int c = __shfl_sync(kFull, my_c, (base + lane / H) & 31);
        if (lane < nb * H)
          bulk_copy(dst + lane / H * ep + lane % H * kc,
                    table + (int64_t)c * d + lane % H * dh + k0, len * 4,
                    bar);
      }
      if (s == 0 && lane < H)  // g's row, in the first stage's count
        bulk_copy(g_s + lane * gp, grow + lane * dh, dh * 4, bar);
    } else {  // edge by edge, head by head, a float a lane
      for (int i = 0; i < nb; ++i) {
        const float* row =
            table + (int64_t)__shfl_sync(kFull, my_c, base + i) * d + k0;
#pragma unroll
        for (int h = 0; h < H; ++h)
          for (int k = lane; k < len; k += 32)
            cp_async4(dst + i * ep + h * kc + k, row + h * dh + k);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {  // a group each, empty or not
    if (s < n_stages) issue(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int i = lane % kEdges, h = lane / kEdges;  // this thread's slice
  float acc = 0.f;
  for (int s = 0; s < n_stages; ++s) {
    if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (VEC == 4)
      bar_wait(bars + s % kStages, (unsigned)(s / kStages) & 1u);
    else
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncwarp();  // stage s is in shared memory, from every lane's copies
    const int b = s / n_chunks, k0 = (s - b * n_chunks) * kc;
    const int len = dh - k0 < kc ? dh - k0 : kc;
    const int e = e0 + b * kEdges + i;
    if (e < e1) {
      const V* ts = reinterpret_cast<const V*>(
          buf + (s % kStages) * kEdges * ep + i * ep + h * kc);
      const V* gs = reinterpret_cast<const V*>(g_s + h * gp + k0);
      for (int k = 0; k < len / VEC; ++k) {
        const V gv = gs[k], tv = ts[k];
        if constexpr (VEC == 4) {
          acc = __fadd_rn(acc, __fmul_rn(gv.x, tv.x));
          acc = __fadd_rn(acc, __fmul_rn(gv.y, tv.y));
          acc = __fadd_rn(acc, __fmul_rn(gv.z, tv.z));
          acc = __fadd_rn(acc, __fmul_rn(gv.w, tv.w));
        } else {
          acc = __fadd_rn(acc, __fmul_rn(gv, tv));
        }
      }
      if (k0 + len == dh) {
        out[(int64_t)e * H + h] = acc;
        acc = 0.f;
      }
    }
    __syncwarp();  // every lane is done with the slot the next issue refills
  }
}

template <int H, int VEC>
int launch_sddmm(const float* g, const float* table, const int* col,
                 const int* units, int n_units, const int* long_rows,
                 const int* long_ptr, int n_long, float* out, int n_rows,
                 int dh, cudaStream_t s) {
  const int bytes = 4 * sddmm_smem_floats(H, dh, VEC);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_kernel<H, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sddmm_kernel<H, VEC><<<(unsigned)n_units, 32, bytes, s>>>(
      g, table, col, units, long_rows, long_ptr, n_long, out, n_rows, dh);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch_sddmm(const float* g, const float* table, const int* col,
                   const int* units, int n_units, const int* long_rows,
                   const int* long_ptr, int n_long, float* out, int n_rows,
                   int n_heads, int dh, cudaStream_t s) {
  switch (n_heads) {
    case 1: return launch_sddmm<1, VEC>(g, table, col, units, n_units,
                                        long_rows, long_ptr, n_long, out,
                                        n_rows, dh, s);
    case 2: return launch_sddmm<2, VEC>(g, table, col, units, n_units,
                                        long_rows, long_ptr, n_long, out,
                                        n_rows, dh, s);
    case 4: return launch_sddmm<4, VEC>(g, table, col, units, n_units,
                                        long_rows, long_ptr, n_long, out,
                                        n_rows, dh, s);
    case 8: return launch_sddmm<8, VEC>(g, table, col, units, n_units,
                                        long_rows, long_ptr, n_long, out,
                                        n_rows, dh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The CSR and its plan as spmm.cu::spmm_csr takes them (row_ptr (n_rows+1,),
// col (nnz,), units (n_units, 3), long_rows (n_long,), long_ptr
// (n_long+1,), int32) plus the plan's segment length; part: (n_partials,
// n_heads) float32 workspace. n_heads is 1, 2, 4 or 8.
//
// s_src: (n_src, n_heads), s_dst: (n_rows, n_heads) float32 -> alpha:
// (nnz, n_heads) float32 in CSR order.
int gat_softmax(const float* s_src, const float* s_dst, const int* row_ptr,
                const int* col, const int* units, int n_units,
                const int* long_rows, const int* long_ptr, int n_long,
                int segment, float* part, float* alpha, int n_rows,
                int n_heads, void* stream) {
  RowArgs a = plan_args(row_ptr, col, units, n_units, long_rows, long_ptr,
                        n_long, segment, n_rows, part);
  a.s_src = s_src;
  a.s_dst = s_dst;
  a.edge_out = alpha;
  return dispatch_heads<kSoftmax>(a, n_heads, (cudaStream_t)stream);
}

// mode 0, over the forward CSR: alpha, dalpha (nnz, n_heads), s_src, s_dst
// as gat_softmax takes them -> dx (nnz, n_heads) and d s_dst (n_rows,
// n_heads); vals and perm are not read.
// mode 1, over the transposed CSR: vals (nnz, n_heads) in forward edge
// order, perm (nnz,) int32 (transposed edge -> forward edge) -> row sums
// (n_rows, n_heads) into row_out (d s_src); the other inputs are not read.
int gat_softmax_bwd(int mode, const float* alpha, const float* dalpha,
                    const float* s_src, const float* s_dst, const float* vals,
                    const int* perm, const int* row_ptr, const int* col,
                    const int* units, int n_units, const int* long_rows,
                    const int* long_ptr, int n_long, int segment, float* part,
                    float* edge_out, float* row_out, int n_rows, int n_heads,
                    void* stream) {
  RowArgs a = plan_args(row_ptr, col, units, n_units, long_rows, long_ptr,
                        n_long, segment, n_rows, part);
  a.alpha = alpha;
  a.dalpha = dalpha;
  a.s_src = s_src;
  a.s_dst = s_dst;
  a.vals = vals;
  a.perm = perm;
  a.edge_out = edge_out;
  a.row_out = row_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) return dispatch_heads<kSoftmaxBwd>(a, n_heads, s);
  if (mode == 1) return dispatch_heads<kRowSum>(a, n_heads, s);
  return (int)cudaErrorInvalidValue;
}

// g: (n_rows, n_heads * dh), table: (n_src, n_heads * dh) float32 ->
// out: (nnz, n_heads) float32, out[e, h] = sum_k g[r_e, h*dh + k] *
// table[col_e, h*dh + k] in k order.
int sddmm_heads(const float* g, const float* table, const int* col,
                const int* units, int n_units, const int* long_rows,
                const int* long_ptr, int n_long, float* out, int n_rows,
                int n_heads, int dh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_units <= 0) return (int)cudaSuccess;
  if (dh <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)g | (uintptr_t)table;
  if (dh % 4 == 0 && ptrs % 16 == 0)
    return dispatch_sddmm<4>(g, table, col, units, n_units, long_rows,
                             long_ptr, n_long, out, n_rows, n_heads, dh, s);
  return dispatch_sddmm<1>(g, table, col, units, n_units, long_rows, long_ptr,
                           n_long, out, n_rows, n_heads, dh, s);
}

}  // extern "C"
