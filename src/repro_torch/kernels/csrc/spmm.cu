// CSR SpMM on Hopper: the GCN aggregation  out[r, :] = sum_e w[e] * table[col[e], :]
// over the edges e in [row_ptr[r], row_ptr[r+1]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmm/spmm.py
// (_spmm_kernel, :37, called through spmm). The TPU kernel takes a padded CSR
// (n_rows, max_deg) and tiles the source table through VMEM; here the CSR is
// true (row_ptr/col/w), because the power-law graphs the port serves have a
// largest in-degree some 200x their mean and a padded index would be mostly
// padding.
//
// What bounds it on an H100: bytes. Each nonzero costs 2*d flops against a
// gathered d-wide f32 table row (4*d bytes), 0.5 flop/byte. The least traffic
// is one read of the table, the CSR and one write of the output; the gathers
// move nnz * d * 4 bytes, and only what L2 (50 MB) holds is read once. The
// stacked partitions' table (hundreds of MB) does not fit, but a column slice
// of it nearly does, and neighbouring rows share neighbours.
//
// Design. The order of every sum is fixed by the CSR alone (see
// repro_torch/kernels/spmm/ref.py, whose plain version follows it bit for
// bit): a row of at most SEGMENT edges sums from 0 edge by edge in CSR order;
// a longer row (a hub) is cut into SEGMENT-edge segments that sum the same
// way, and their partials combine left to right. The host builds the work
// plan once with the CSR (ref.py::split_plan): units of (edge range, target)
// in CSR order, none longer than SEGMENT edges, so a hub no longer runs
// serially on one warp.
//   * pass 1: grid (units / 8, column chunks); one warp per (unit, chunk of
//     kChunkFloats columns). Lane l owns vectors l, l+32, ... of the chunk,
//     as float4 / float2 / float where the row stride and the pointers allow
//     (d = 256 takes float4, d = 602 float2), so every gathered table row is
//     read as coalesced lines. The chunk is the slow grid axis: the card
//     works through one column slice of the table at a time, which L2 can
//     hold, and through the units in row order, so rows that share
//     neighbours run together. The sums live in registers, few per lane, so
//     many warps fit on an SM;
//   * the lanes first load 32 edges' (col, w) at once and share them by
//     shuffles; then kBatch edges' table vectors are loaded into registers
//     before any of them is added, so several gathered rows per warp are in
//     flight; the adds stay in CSR order, acc = acc + w*t with the multiply
//     and the add rounded separately (__fmul_rn, __fadd_rn; the library is
//     built with -fmad=false);
//   * whole rows write `out`, segments write their partial slot;
//   * pass 2, one thread per (split row, column): p0 + p1 + ... left to right.
// No atomics: the same CSR gives the same bits on every run (the serving
// engine's delta-refresh == full-sweep guarantee rests on it). The kernel
// allocates nothing; the wrapper passes the partials' workspace.
//
// spmm_csr_heads is the same kernel with a weight per edge and head: GAT's
// aggregation out[r, h*dh + k] = sum_e alpha[w_idx[e], h] * table[col[e],
// h*dh + k], and its backward over the transposed CSR. The JAX package
// computes it as gather_src * alpha then segment_sum
// (src/repro/models/gnn/models.py:141, outside any Pallas kernel). w_idx
// (null: the identity) lets the backward read the forward's alpha through
// perm_t (transposed edge -> forward edge) instead of gathering a transposed
// copy first: that gather, a launch of its own, took about four times this
// kernel's time on an H100. Lane l reads edge eb + l's index and its H <=
// kMaxHeads weights once per 32-edge batch into the warp's slice of shared
// memory, and the lanes read them from there, so the weights' indexed loads
// are neither repeated per vector nor in the inner loop's chain of dependent
// loads. The vector width also divides dh, so a lane's vector lies in one
// head and takes one weight; the order of the adds is spmm_csr's, which is
// its H = 1 case bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 4;         // gathered table rows in flight per warp
constexpr int kChunkFloats = 128; // columns of a row one warp sums
constexpr int kMaxHeads = 8;      // spmm_csr_heads: weights per edge

template <int VEC> struct VecT;
template <> struct VecT<1> { using T = float; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<4> { using T = float4; };

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float2 zero_of(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float madd(float acc, float w, float t) {
  return __fadd_rn(acc, __fmul_rn(w, t));
}
__device__ __forceinline__ float2 madd(float2 acc, float w, float2 t) {
  return make_float2(madd(acc.x, w, t.x), madd(acc.y, w, t.y));
}
__device__ __forceinline__ float4 madd(float4 acc, float w, float4 t) {
  return make_float4(madd(acc.x, w, t.x), madd(acc.y, w, t.y),
                     madd(acc.z, w, t.z), madd(acc.w, w, t.w));
}

// units: (n_units, 3) int32 rows (e_begin, e_end, target); target < n_rows is
// an output row, otherwise partial slot target - n_rows. Warp w of the grid's
// row x sums unit x * kWarpsPerBlock + w over column chunk blockIdx.y.
// HEADS: w is (n_w, n_heads) and column c of edge e takes w[w_idx[e], c /
// dh] (w[e, c / dh] where w_idx is null).
template <int VEC, int NV, bool HEADS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_units_kernel(const float* __restrict__ table, const int* __restrict__ col,
                  const float* __restrict__ w, const int* __restrict__ units,
                  int n_units, float* __restrict__ part,
                  float* __restrict__ out, int n_rows, int d, int n_heads,
                  int dh, const int* __restrict__ w_idx) {
  using V = typename VecT<VEC>::T;
  // HEADS: the weights of the warp's current 32 edges, [edge][head]
  __shared__ float w_s[HEADS ? kWarpsPerBlock * 32 * kMaxHeads : 1];
  float* ws = w_s + (HEADS ? (threadIdx.x >> 5) * 32 * kMaxHeads : 0);
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
  const int target = __ldg(units + 3 * unit + 2);
  float* dst = target < n_rows ? out + (int64_t)target * d
                               : part + (int64_t)(target - n_rows) * d;
  const int dv = d / VEC;  // vectors per row
  const int v0 = blockIdx.y * 32 * NV + lane;
  V acc[NV];
  int head[NV];  // HEADS: the head of each of the lane's vectors
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    acc[v] = zero_of(V());
    head[v] = HEADS ? (v0 + 32 * v) * VEC / dh : 0;
  }
  for (int eb = e0; eb < e1; eb += 32) {
    const int n = e1 - eb < 32 ? e1 - eb : 32;
    int my_c = 0;
    float my_w = 0.f;
    if (lane < n) {
      my_c = __ldg(col + eb + lane);
      if (!HEADS) my_w = __ldg(w + eb + lane);
    }
    if constexpr (HEADS) {
      __syncwarp();  // every lane is done with the last batch's weights
      if (lane < n) {
        const int64_t src =
            (int64_t)(w_idx ? __ldg(w_idx + eb + lane) : eb + lane) * n_heads;
        for (int h = 0; h < n_heads; ++h)
          ws[lane * n_heads + h] = __ldg(w + src + h);
      }
      __syncwarp();
    }
    for (int j = 0; j < n; j += kBatch) {
      constexpr int NW = HEADS ? NV : 1;  // weights per edge: one per vector
      V t[kBatch][NV];
      float wu[kBatch][NW];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = __shfl_sync(0xffffffffu, my_c, j + u);
        wu[u][0] = __shfl_sync(0xffffffffu, my_w, j + u);
        const V* tr = reinterpret_cast<const V*>(table + (int64_t)c * d);
        const float* we = ws + (j + u) * n_heads;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const bool live = j + u < n && v0 + 32 * v < dv;
          t[u][v] = live ? __ldg(tr + v0 + 32 * v) : zero_of(V());
          if (HEADS) wu[u][v < NW ? v : 0] = live ? we[head[v]] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u < n) {
#pragma unroll
          for (int v = 0; v < NV; ++v)
            acc[v] = madd(acc[v], wu[u][v < NW ? v : 0], t[u][v]);
        }
      }
    }
  }
  V* drow = reinterpret_cast<V*>(dst);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int idx = v0 + 32 * v;
    if (idx < dv) drow[idx] = acc[v];
  }
}

// Split row long_rows[i] = part[long_ptr[i]] + part[long_ptr[i] + 1] + ...,
// left to right.
__global__ void __launch_bounds__(256)
spmm_combine_kernel(const float* __restrict__ part,
                    const int* __restrict__ long_rows,
                    const int* __restrict__ long_ptr, float* __restrict__ out,
                    int d) {
  const int i = blockIdx.x;
  const int c = blockIdx.y * 256 + threadIdx.x;
  if (c >= d) return;
  const int s0 = __ldg(long_ptr + i);
  const int s1 = __ldg(long_ptr + i + 1);
  float acc = part[(int64_t)s0 * d + c];
  for (int s = s0 + 1; s < s1; ++s) acc = __fadd_rn(acc, part[(int64_t)s * d + c]);
  out[(int64_t)__ldg(long_rows + i) * d + c] = acc;
}

// Vectors of VEC floats; NV of them per lane, so a warp sums a column chunk
// of 32 * NV * VEC <= kChunkFloats floats (fewer where the row is narrower).
template <int VEC, bool HEADS>
void launch_units(const float* table, const int* col, const float* w,
                  const int* w_idx, const int* units, int n_units,
                  float* part, float* out, int n_rows, int d, int n_heads,
                  int dh, cudaStream_t s) {
  static_assert(kChunkFloats <= 128, "NV goes up to 4");
  constexpr int kMaxNV = kChunkFloats / (32 * VEC);
  const int dv = d / VEC;
  int nv = 1;
  while (nv < kMaxNV && 32 * nv < dv) nv *= 2;
  const dim3 grid((unsigned)((n_units + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((dv + 32 * nv - 1) / (32 * nv)));
  const dim3 block(kWarpsPerBlock * 32);
  if (nv == 1) {
    spmm_units_kernel<VEC, 1, HEADS><<<grid, block, 0, s>>>(
        table, col, w, units, n_units, part, out, n_rows, d, n_heads, dh,
        w_idx);
  } else if (nv == 2) {
    spmm_units_kernel<VEC, (kMaxNV >= 2 ? 2 : 1), HEADS>
        <<<grid, block, 0, s>>>(table, col, w, units, n_units, part, out,
                                n_rows, d, n_heads, dh, w_idx);
  } else {
    spmm_units_kernel<VEC, (kMaxNV >= 4 ? 4 : 1), HEADS>
        <<<grid, block, 0, s>>>(table, col, w, units, n_units, part, out,
                                n_rows, d, n_heads, dh, w_idx);
  }
}

// Both entry points: the widest vector that divides dh (so it lies in one
// head) and that the pointers' alignment allows, then the combine pass.
template <bool HEADS>
int spmm_run(const float* table, const int* col, const float* w,
             const int* w_idx, int n_heads, const int* units, int n_units,
             const int* long_rows, const int* long_ptr, int n_long,
             float* part, float* out, int n_rows, int d, cudaStream_t s) {
  if (n_units <= 0 || d <= 0) return (int)cudaSuccess;
  const int dh = d / n_heads;
  const uintptr_t ptrs = (uintptr_t)table | (uintptr_t)out | (uintptr_t)part;
  if (dh % 4 == 0 && ptrs % 16 == 0) {
    launch_units<4, HEADS>(table, col, w, w_idx, units, n_units, part, out,
                           n_rows, d, n_heads, dh, s);
  } else if (dh % 2 == 0 && ptrs % 8 == 0) {
    launch_units<2, HEADS>(table, col, w, w_idx, units, n_units, part, out,
                           n_rows, d, n_heads, dh, s);
  } else {
    launch_units<1, HEADS>(table, col, w, w_idx, units, n_units, part, out,
                           n_rows, d, n_heads, dh, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long <= 0) return (int)err;
  const dim3 grid((unsigned)n_long, (unsigned)((d + 255) / 256));
  spmm_combine_kernel<<<grid, 256, 0, s>>>(part, long_rows, long_ptr, out, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// table: (n_src, d) float32 row-major; col: (nnz,) int32 in [0, n_src);
// w: (nnz,) float32; units: (n_units, 3) int32 and long_rows (n_long,) /
// long_ptr (n_long+1,) int32, the plan of ref.py::split_plan; part:
// (long_ptr[n_long], d) float32 workspace; out: (n_rows, d) float32.
int spmm_csr(const float* table, const int* col, const float* w,
             const int* units, int n_units, const int* long_rows,
             const int* long_ptr, int n_long, float* part, float* out,
             int n_rows, int d, void* stream) {
  return spmm_run<false>(table, col, w, nullptr, 1, units, n_units,
                         long_rows, long_ptr, n_long, part, out, n_rows, d,
                         (cudaStream_t)stream);
}

// The same with w: (n_w, n_heads) float32, 1 <= n_heads <= 8 dividing d,
// and w_idx: (nnz,) int32 in [0, n_w), or null for w_idx[e] = e (then n_w
// = nnz); column c of the table is weighted by w[w_idx[e], c / (d /
// n_heads)].
int spmm_csr_heads(const float* table, const int* col, const float* w,
                   const int* w_idx, int n_heads, const int* units,
                   int n_units, const int* long_rows, const int* long_ptr,
                   int n_long, float* part, float* out, int n_rows, int d,
                   void* stream) {
  if (n_heads <= 0 || n_heads > kMaxHeads || d % n_heads)
    return (int)cudaErrorInvalidValue;
  return spmm_run<true>(table, col, w, w_idx, n_heads, units, n_units,
                        long_rows, long_ptr, n_long, part, out, n_rows, d,
                        (cudaStream_t)stream);
}

}  // extern "C"
