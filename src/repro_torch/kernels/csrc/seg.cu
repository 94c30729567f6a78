// CSR segment max on Hopper: PNA's max and min aggregations.
//
// For every destination row r of an edge-indexed CSR (ecsr: row_ptr of the
// destinations, col[e] the flat id of edge e's message) and every column c
// of the per-edge messages msgs (n_msgs, d) float32:
//
//   max[r, c]   = max over row r's edges e of msgs[col[e], c]
//   count[r, c] = the number of those edges whose value == max[r, c]
//
// and an empty row writes 0 and a count of 0. The count is what the
// gradient needs: d msgs[e, c] = g[r, c] * (1 / count[r, c]) where
// msgs[e, c] == max[r, c], else 0 (a plain elementwise pass of PyTorch ops,
// repro_torch/models/gnn/blocks.py).
//
// Not a port of a TPU kernel: the JAX package computes the same function
// with jax.ops.segment_max (src/repro/models/gnn/blocks.py:104, agg_max;
// agg_min is -agg_max(-msgs)), outside any Pallas kernel, and its gradient
// by autodiff (JAX's _scatter_extremal_jvp splits the gradient evenly among
// tied maxima). PyTorch's scatter_reduce(reduce="amax") would add through
// atomics and spread ties by its own rule; neither is on the port's path.
//
// What bounds it on an H100: bytes. Per (edge, column) one compare against
// a gathered 4-byte message; the gathers move nnz * d * 4 bytes (PNA 4 x 75
// on reddit_like@paper: about 1.62M edges, 486 MB), and each message is
// read once, by the one row its edge belongs to.
//
// Design (simple first). The host's work plan of the CSR
// (spmm/ref.py::split_plan): units of at most SEGMENT edges, whole rows or
// segments of a longer (hub) row. One warp per (unit, chunk of up to
// kChunk columns); lane l keeps the running max and count of columns l, l
// + 32, ... in registers. The lanes load 32 edges' message ids at once and
// share them by shuffles; then kBatch edges' values are loaded before any
// is compared, so several gathered rows are in flight. The rule, edge by
// edge in CSR order: a value greater than the running max (or a NaN, which
// then stays) replaces it with a count of 1; an equal value adds 1. A whole
// row writes max and count; a segment writes its partial; a second pass,
// one thread per (split row, column), combines a row's partials left to
// right by the same rule. So the max is the first of the tied values in
// CSR order (+0 or -0), the count does not depend on the plan, and one CSR
// gives the same bits on every run. No atomics. The plain version
// (repro_torch/kernels/seg/ref.py) follows the same rule.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 4;            // gathered message rows in flight a warp
constexpr int kNV = 4;               // columns per lane
constexpr int kChunk = 32 * kNV;     // columns one warp scans

__device__ __forceinline__ void take(float v, int n, float& m, int& c) {
  if (v > m || isnan(v)) {
    m = v;
    c = n;
  } else if (v == m) {
    c += n;
  }
}

// units: (n_units, 3) int32 (e_begin, e_end, target); target < n_rows is an
// output row, otherwise partial slot target - n_rows.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_max_units_kernel(const float* __restrict__ msgs,
                     const int* __restrict__ col,
                     const int* __restrict__ units, int n_units,
                     float* __restrict__ part_max, int* __restrict__ part_cnt,
                     float* __restrict__ out_max, int* __restrict__ out_cnt,
                     int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
  const int target = __ldg(units + 3 * unit + 2);
  const int c0 = blockIdx.y * kChunk + lane;
  float m[kNV];
  int cnt[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    m[v] = -__int_as_float(0x7f800000);  // -inf
    cnt[v] = 0;
  }
  for (int eb = e0; eb < e1; eb += 32) {
    const int n = e1 - eb < 32 ? e1 - eb : 32;
    const int my_id = lane < n ? __ldg(col + eb + lane) : 0;
    for (int j = 0; j < n; j += kBatch) {
      float t[kBatch][kNV];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int id = __shfl_sync(0xffffffffu, my_id, (j + u) & 31);
        const float* row = msgs + (int64_t)id * d;
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const int c = c0 + 32 * v;
          t[u][v] = (j + u < n && c < d) ? __ldg(row + c) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u < n) {
#pragma unroll
          for (int v = 0; v < kNV; ++v) take(t[u][v], 1, m[v], cnt[v]);
        }
      }
    }
  }
  const bool whole = target < n_rows;
  const int64_t base = (int64_t)(whole ? target : target - n_rows) * d;
  float* dmax = whole ? out_max : part_max;
  int* dcnt = whole ? out_cnt : part_cnt;
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    const int c = c0 + 32 * v;
    if (c < d) {
      // an empty row (only a whole row can be one) writes 0 and 0
      dmax[base + c] = cnt[v] == 0 ? 0.f : m[v];
      dcnt[base + c] = cnt[v];
    }
  }
}

// Split row long_rows[i]: its partials long_ptr[i] .. long_ptr[i+1] - 1
// combined left to right by take(). A segment is never empty.
__global__ void __launch_bounds__(256)
seg_max_combine_kernel(const float* __restrict__ part_max,
                       const int* __restrict__ part_cnt,
                       const int* __restrict__ long_rows,
                       const int* __restrict__ long_ptr,
                       float* __restrict__ out_max, int* __restrict__ out_cnt,
                       int d) {
  const int i = blockIdx.x;
  const int c = blockIdx.y * 256 + threadIdx.x;
  if (c >= d) return;
  const int s0 = __ldg(long_ptr + i);
  const int s1 = __ldg(long_ptr + i + 1);
  float m = part_max[(int64_t)s0 * d + c];
  int cnt = part_cnt[(int64_t)s0 * d + c];
  for (int s = s0 + 1; s < s1; ++s)
    take(part_max[(int64_t)s * d + c], part_cnt[(int64_t)s * d + c], m, cnt);
  const int64_t o = (int64_t)__ldg(long_rows + i) * d + c;
  out_max[o] = m;
  out_cnt[o] = cnt;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// msgs: (n_msgs, d) float32 row-major; col: (nnz,) int32 in [0, n_msgs);
// units (n_units, 3), long_rows (n_long,), long_ptr (n_long + 1,) int32: the
// plan of spmm/ref.py::split_plan; part_max / part_cnt: (long_ptr[n_long],
// d) float32 / int32 workspace; out_max / out_cnt: (n_rows, d) float32 /
// int32.
int seg_max_csr(const float* msgs, const int* col, const int* units,
                int n_units, const int* long_rows, const int* long_ptr,
                int n_long, float* part_max, int* part_cnt, float* out_max,
                int* out_cnt, int n_rows, int d, void* stream) {
  if (n_units <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n_units + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((d + kChunk - 1) / kChunk));
  seg_max_units_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      msgs, col, units, n_units, part_max, part_cnt, out_max, out_cnt,
      n_rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long <= 0) return (int)err;
  const dim3 cgrid((unsigned)n_long, (unsigned)((d + 255) / 256));
  seg_max_combine_kernel<<<cgrid, 256, 0, s>>>(part_max, part_cnt, long_rows,
                                               long_ptr, out_max, out_cnt, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
