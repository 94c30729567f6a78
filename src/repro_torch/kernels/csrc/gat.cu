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
// handful of flops and an expf against 4-byte gathers and writes; the SDDMM
// does 2*dh flops against 8*dh gathered bytes (0.25 flop/byte).
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
//   * SDDMM: one warp per work unit; thread (edge, head) sums its dh
//     products in k order, reading float4 where dh and the pointers allow.
//     A segment unit finds its row through the plan's long rows.
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

// dalpha[e, h] for the units' edges; thread t of a unit's warp takes the
// (edge, head) pairs t, t + 32, ... of the unit.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_kernel(const float* __restrict__ g, const float* __restrict__ table,
             const int* __restrict__ col, const int* __restrict__ units,
             int n_units, const int* __restrict__ long_rows,
             const int* __restrict__ long_ptr, int n_long,
             float* __restrict__ out, int n_rows, int n_heads, int dh) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
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
  const int d = n_heads * dh;
  const int pairs = (e1 - e0) * n_heads;
  for (int q = lane; q < pairs; q += 32) {
    const int e = e0 + q / n_heads, h = q - (q / n_heads) * n_heads;
    const V* gr = reinterpret_cast<const V*>(g + (int64_t)r * d + h * dh);
    const V* tr = reinterpret_cast<const V*>(
        table + (int64_t)__ldg(col + e) * d + h * dh);
    float acc = 0.f;
    for (int k = 0; k < dh / VEC; ++k) {
      const V gv = __ldg(gr + k), tv = __ldg(tr + k);
      if constexpr (VEC == 4) {
        acc = __fadd_rn(acc, __fmul_rn(gv.x, tv.x));
        acc = __fadd_rn(acc, __fmul_rn(gv.y, tv.y));
        acc = __fadd_rn(acc, __fmul_rn(gv.z, tv.z));
        acc = __fadd_rn(acc, __fmul_rn(gv.w, tv.w));
      } else {
        acc = __fadd_rn(acc, __fmul_rn(gv, tv));
      }
    }
    out[(int64_t)e * n_heads + h] = acc;
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
  if (n_heads <= 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_units + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock);
  const uintptr_t ptrs = (uintptr_t)g | (uintptr_t)table;
  if (dh % 4 == 0 && ptrs % 16 == 0) {
    sddmm_kernel<4><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        g, table, col, units, n_units, long_rows, long_ptr, n_long, out,
        n_rows, n_heads, dh);
  } else {
    sddmm_kernel<1><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        g, table, col, units, n_units, long_rows, long_ptr, n_long, out,
        n_rows, n_heads, dh);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
