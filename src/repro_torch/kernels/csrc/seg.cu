// CSR segment max and min on Hopper: PNA's max and min aggregations in one
// pass over the messages, and their gradient.
//
// Forward, seg_max_min_csr. For every destination row r of an edge-indexed
// CSR (ecsr: row_ptr of the destinations, col[e] the flat id of edge e's
// message) and every column c of the per-edge messages msgs (n_msgs, d)
// float32:
//
//   max[r, c], count_max[r, c]   the largest of row r's msgs[col[e], c] and
//                                the number of its edges that equal it
//   min[r, c], count_min[r, c]   the same for the smallest
//
// An empty row writes max +0, min -0 (what -max(-msgs) gives there) and
// counts of 0. The rule, edge by edge in CSR order: a value greater (for the
// min: less) than the running extremum, or a NaN, replaces it with a count of
// 1; an equal value adds 1. So an extremum is the first of its tied values in
// CSR order (+0 or -0), and min is bit for bit -max(-msgs), the JAX package's
// agg_min.
//
// Backward, seg_max_min_bwd_csr. Given the gradients g_max, g_min (n_rows, d)
// of the two results, each with its own row stride, for every edge e of row
// r and column c, with m = msgs[col[e], c]:
//
//   d msgs[col[e], c] = where(m == max[r, c], g_max[r, c] * (1 / cmax[r, c]), 0)
//                     + where(m == min[r, c], g_min[r, c] * (1 / cmin[r, c]), 0)
//
// with cmax, cmin the counts, the reciprocal an IEEE division, as JAX's segment_max VJP (updates_coef)
// and torch.reciprocal take it, and the two terms added in this order. The
// rows pad[] (padded edges, which no row names) are written 0. col names
// each message at most once, so every output row is written exactly once.
//
// Not a port of a TPU kernel: the JAX package computes the forward with
// jax.ops.segment_max (src/repro/models/gnn/blocks.py:104, agg_max; agg_min
// is -agg_max(-msgs)) outside any Pallas kernel, and the gradient by
// autodiff (JAX's _scatter_extremal_jvp splits it evenly among tied
// extrema). PyTorch's scatter_reduce(reduce="amax") adds through atomics and
// spreads ties by its own rule; neither is on the port's path.
//
// What bounds them on an H100: bytes. PNA 4 x 75 on reddit_like@paper
// gathers about 1.62M message rows of 300 bytes (486.8 MB) a call, in random
// order (the edges are not stored by destination); the forward writes four
// (25,000 x 75) outputs, the backward reads the six per-row tensors once and
// writes a gradient row for every message.
//
// Design. The host's work plan of the CSR (spmm/ref.py::split_plan): units of
// at most SEGMENT edges, whole rows or segments of a longer (hub) row. One
// warp per (unit, chunk of columns). A lane map (Map below) cuts the warp
// into groups of L lanes; a group reads a message row, lane l holding
// columns l, l + L, ..., so one load instruction reads 32 / L rows. The
// forward takes L = 16 lanes x 5 columns (PNA's 75 fill 75 of 80 slots),
// the backward 32 x 3. The unit's edges are cut into one contiguous part a
// group; a group loads L message ids at a time (the next L before the
// current ones are used), shares them by width-L shuffles, and loads B = 2
// rows before it uses any. Measured on an H100 at PNA's shape
// (tools/torch_seg_ab.py), more rows in flight a warp (4, 8, 16) or fewer
// lanes a row (8) made both kernels slower: the registers they cost take
// warps off the SM, and the random 300-byte gathers gain nothing from
// more outstanding rows. The forward keeps max, min and both counts of its
// columns in registers and combines the groups' partials by the same rule
// in a shuffle tree, each step a group with the next one's; a whole row
// writes its four outputs, a segment its partials, and a second pass, one
// thread per (split row, column), combines a row's partials left to right
// by the same rule. Contiguous ranges combined in order give the bits of
// the scan in CSR order, so neither the extrema nor the counts depend on
// the plan, and one CSR gives the same bits on every run. The backward
// loads its row's extrema and shares (g / count) once per lane and column,
// then reads each edge's message row and writes its gradient row; a split
// row's segments need no combination, since each edge's output is its
// own. A second kernel writes the padded rows' zeros. No atomics. The
// plain versions (repro_torch/kernels/seg/ref.py) follow the same rules.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;

// A lane map: L lanes read a message row, V columns each, so a warp covers
// L * V columns and reads 32 / L rows a load instruction; B rows in flight
// a lane group.
template <int L, int V, int B>
struct Map {
  static constexpr int kLanes = L;
  static constexpr int kGroups = 32 / L;
  static constexpr int kNV = V;
  static constexpr int kChunk = L * V;
  static constexpr int kBatch = B;
  static_assert(L * kGroups == 32 && L % B == 0, "lane map");
};
using Fwd = Map<16, 5, 2>;   // PNA's 75 columns fill 75 of 80 slots
using Bwd = Map<32, 3, 2>;   // 75 of 96

__device__ __forceinline__ void take_max(float v, int n, float& m, int& c) {
  if (v > m || isnan(v)) {
    m = v;
    c = n;
  } else if (v == m) {
    c += n;
  }
}

__device__ __forceinline__ void take_min(float v, int n, float& m, int& c) {
  if (v < m || isnan(v)) {
    m = v;
    c = n;
  } else if (v == m) {
    c += n;
  }
}

// The edges of lane group g of the unit [e0, e1): kGroups contiguous
// parts, in order, of nb = ceil(n / kGroups) edges but the last ones;
// nb bounds every group's loops.
struct Part {
  int h0, n_mine, nb;
};

template <typename M>
__device__ __forceinline__ Part part_of(int e0, int e1, int g) {
  const int nb = (e1 - e0 + M::kGroups - 1) / M::kGroups;
  const int h0 = min(e0 + g * nb, e1);
  return Part{h0, min(nb, e1 - h0), nb};
}

// Walk one lane group's edges: for each batch of kBatch edges, load their
// message rows' columns (c0 + kLanes * v, those with ok[v]) into t, then call
// body(t, ids, left), where edge u of the batch is the group's own if u <
// left. Every lane of the warp runs the same iterations (the loop bounds
// depend on the unit alone), as the shuffles need.
template <typename M, typename Body>
__device__ __forceinline__ void walk(const float* __restrict__ msgs,
                                     const int* __restrict__ col,
                                     const Part& h, int hl, int c0,
                                     const bool (&ok)[M::kNV], int d,
                                     Body body) {
  int id_next = hl < h.n_mine ? __ldg(col + h.h0 + hl) : 0;
  for (int base = 0; base < h.nb; base += M::kLanes) {
    const int id_cur = id_next;
    if (base + M::kLanes < h.nb) {
      const int k = base + M::kLanes + hl;
      id_next = k < h.n_mine ? __ldg(col + h.h0 + k) : 0;
    }
    for (int j = 0; j < M::kLanes && base + j < h.nb; j += M::kBatch) {
      float t[M::kBatch][M::kNV];
      int ids[M::kBatch];
#pragma unroll
      for (int u = 0; u < M::kBatch; ++u) {
        ids[u] = __shfl_sync(0xffffffffu, id_cur, j + u, M::kLanes);
        const bool valid = base + j + u < h.n_mine;
        const float* row = msgs + (int64_t)ids[u] * d + c0;
#pragma unroll
        for (int v = 0; v < M::kNV; ++v)
          t[u][v] = valid && ok[v] ? __ldg(row + M::kLanes * v) : 0.f;
      }
      body(t, ids, h.n_mine - (base + j));
    }
  }
}

// units: (n_units, 3) int32 (e_begin, e_end, target); target < n_rows is an
// output row, otherwise partial slot target - n_rows.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_max_min_units_kernel(const float* __restrict__ msgs,
                         const int* __restrict__ col,
                         const int* __restrict__ units, int n_units,
                         float* __restrict__ part_max,
                         int* __restrict__ part_cmax,
                         float* __restrict__ part_min,
                         int* __restrict__ part_cmin,
                         float* __restrict__ out_max,
                         int* __restrict__ out_cmax,
                         float* __restrict__ out_min,
                         int* __restrict__ out_cmin, int n_rows, int d) {
  using M = Fwd;
  const int lane = threadIdx.x & 31;
  const int hl = lane % M::kLanes;
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
  const int target = __ldg(units + 3 * unit + 2);
  const int c0 = blockIdx.y * M::kChunk + hl;
  bool ok[M::kNV];
  float mx[M::kNV], mn[M::kNV];
  int cx[M::kNV], cn[M::kNV];
#pragma unroll
  for (int v = 0; v < M::kNV; ++v) {
    ok[v] = c0 + M::kLanes * v < d;
    mx[v] = -__int_as_float(0x7f800000);  // -inf
    mn[v] = __int_as_float(0x7f800000);   // +inf
    cx[v] = cn[v] = 0;
  }
  walk<M>(msgs, col, part_of<M>(e0, e1, lane / M::kLanes), hl, c0, ok, d,
          [&](const float (&t)[M::kBatch][M::kNV], const int (&)[M::kBatch],
              int left) {
#pragma unroll
            for (int u = 0; u < M::kBatch; ++u) {
              if (u < left) {
#pragma unroll
                for (int v = 0; v < M::kNV; ++v) {
                  take_max(t[u][v], 1, mx[v], cx[v]);
                  take_min(t[u][v], 1, mn[v], cn[v]);
                }
              }
            }
          });
  // the groups' extrema combined by the same rule, each step a group with
  // the next one's (the first's and the second's, the third's and the
  // fourth's, ...), so the first group ends with the whole unit's
#pragma unroll
  for (int delta = M::kLanes; delta < 32; delta *= 2) {
#pragma unroll
    for (int v = 0; v < M::kNV; ++v) {
      const float rmx = __shfl_down_sync(0xffffffffu, mx[v], delta);
      const int rcx = __shfl_down_sync(0xffffffffu, cx[v], delta);
      const float rmn = __shfl_down_sync(0xffffffffu, mn[v], delta);
      const int rcn = __shfl_down_sync(0xffffffffu, cn[v], delta);
      take_max(rmx, rcx, mx[v], cx[v]);
      take_min(rmn, rcn, mn[v], cn[v]);
    }
  }
  if (lane >= M::kLanes) return;
  const bool whole = target < n_rows;
  const int64_t base = (int64_t)(whole ? target : target - n_rows) * d + c0;
  float* dmax = whole ? out_max : part_max;
  int* dcmax = whole ? out_cmax : part_cmax;
  float* dmin = whole ? out_min : part_min;
  int* dcmin = whole ? out_cmin : part_cmin;
#pragma unroll
  for (int v = 0; v < M::kNV; ++v) {
    if (ok[v]) {
      // an empty row (only a whole row can be one) writes +0, -0 and 0s
      const int64_t o = base + M::kLanes * v;
      dmax[o] = cx[v] == 0 ? 0.f : mx[v];
      dcmax[o] = cx[v];
      dmin[o] = cn[v] == 0 ? -0.f : mn[v];
      dcmin[o] = cn[v];
    }
  }
}

// Split row long_rows[i]: its partials long_ptr[i] .. long_ptr[i+1] - 1
// combined left to right by the same rule. A segment is never empty.
__global__ void __launch_bounds__(256)
seg_max_min_combine_kernel(const float* __restrict__ part_max,
                           const int* __restrict__ part_cmax,
                           const float* __restrict__ part_min,
                           const int* __restrict__ part_cmin,
                           const int* __restrict__ long_rows,
                           const int* __restrict__ long_ptr,
                           float* __restrict__ out_max,
                           int* __restrict__ out_cmax,
                           float* __restrict__ out_min,
                           int* __restrict__ out_cmin, int d) {
  const int i = blockIdx.x;
  const int c = blockIdx.y * 256 + threadIdx.x;
  if (c >= d) return;
  const int s0 = __ldg(long_ptr + i);
  const int s1 = __ldg(long_ptr + i + 1);
  int64_t p = (int64_t)s0 * d + c;
  float mx = part_max[p], mn = part_min[p];
  int cx = part_cmax[p], cn = part_cmin[p];
  for (int s = s0 + 1; s < s1; ++s) {
    p = (int64_t)s * d + c;
    take_max(part_max[p], part_cmax[p], mx, cx);
    take_min(part_min[p], part_cmin[p], mn, cn);
  }
  const int64_t o = (int64_t)__ldg(long_rows + i) * d + c;
  out_max[o] = mx;
  out_cmax[o] = cx;
  out_min[o] = mn;
  out_cmin[o] = cn;
}

// The gradient of the messages of one unit's edges (see the header).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_max_min_bwd_units_kernel(const float* __restrict__ msgs,
                             const int* __restrict__ col,
                             const int* __restrict__ units, int n_units,
                             const int* __restrict__ long_rows,
                             const int* __restrict__ long_ptr, int n_long,
                             const float* __restrict__ mx,
                             const int* __restrict__ cmx,
                             const float* __restrict__ mn,
                             const int* __restrict__ cmn,
                             const float* __restrict__ g_max,
                             int64_t g_max_stride,
                             const float* __restrict__ g_min,
                             int64_t g_min_stride, float* __restrict__ out,
                             int n_rows, int d) {
  using M = Bwd;
  const int lane = threadIdx.x & 31;
  const int hl = lane % M::kLanes;
  const int unit = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;
  const int e0 = __ldg(units + 3 * unit);
  const int e1 = __ldg(units + 3 * unit + 1);
  if (e0 == e1) return;                      // an empty row: no message
  int r = __ldg(units + 3 * unit + 2);
  if (r >= n_rows) {
    // a segment: its row is long_rows[i], long_ptr[i] <= slot < long_ptr[i+1]
    const int slot = r - n_rows;
    int lo = 0, hi = n_long - 1;
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (__ldg(long_ptr + m) <= slot) lo = m; else hi = m - 1;
    }
    r = __ldg(long_rows + lo);
  }
  const int c0 = blockIdx.y * M::kChunk + hl;
  bool ok[M::kNV];
  float vmax[M::kNV], vmin[M::kNV], smax[M::kNV], smin[M::kNV];
#pragma unroll
  for (int v = 0; v < M::kNV; ++v) {
    const int c = c0 + M::kLanes * v;
    ok[v] = c < d;
    if (ok[v]) {
      const int64_t o = (int64_t)r * d + c;
      vmax[v] = __ldg(mx + o);
      vmin[v] = __ldg(mn + o);
      smax[v] = __ldg(g_max + (int64_t)r * g_max_stride + c)
                * (1.f / (float)__ldg(cmx + o));
      smin[v] = __ldg(g_min + (int64_t)r * g_min_stride + c)
                * (1.f / (float)__ldg(cmn + o));
    } else {
      vmax[v] = vmin[v] = smax[v] = smin[v] = 0.f;
    }
  }
  walk<M>(msgs, col, part_of<M>(e0, e1, lane / M::kLanes), hl, c0, ok, d,
          [&](const float (&t)[M::kBatch][M::kNV],
              const int (&ids)[M::kBatch], int left) {
#pragma unroll
            for (int u = 0; u < M::kBatch; ++u) {
              if (u < left) {
                float* row = out + (int64_t)ids[u] * d + c0;
#pragma unroll
                for (int v = 0; v < M::kNV; ++v) {
                  if (ok[v]) {
                    const float a = t[u][v] == vmax[v] ? smax[v] : 0.f;
                    const float b = t[u][v] == vmin[v] ? smin[v] : 0.f;
                    row[M::kLanes * v] = a + b;
                  }
                }
              }
            }
          });
}

// out[pad[k], :] = 0, one thread per element.
__global__ void __launch_bounds__(256)
seg_max_min_bwd_pad_kernel(const int* __restrict__ pad, int n_pad,
                           float* __restrict__ out, int d) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (int64_t)n_pad * d) return;
  const int64_t k = i / d;
  out[(int64_t)__ldg(pad + k) * d + (i - k * d)] = 0.f;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// msgs: (n_msgs, d) float32 row-major; col: (nnz,) int32 in [0, n_msgs);
// units (n_units, 3), long_rows (n_long,), long_ptr (n_long + 1,) int32: the
// plan of spmm/ref.py::split_plan; part_*: (long_ptr[n_long], d) float32 /
// int32 workspace; out_max / out_cmax / out_min / out_cmin: (n_rows, d)
// float32 / int32 / float32 / int32.
int seg_max_min_csr(const float* msgs, const int* col, const int* units,
                    int n_units, const int* long_rows, const int* long_ptr,
                    int n_long, float* part_max, int* part_cmax,
                    float* part_min, int* part_cmin, float* out_max,
                    int* out_cmax, float* out_min, int* out_cmin, int n_rows,
                    int d, void* stream) {
  if (n_units <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n_units + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((d + Fwd::kChunk - 1) / Fwd::kChunk));
  seg_max_min_units_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      msgs, col, units, n_units, part_max, part_cmax, part_min, part_cmin,
      out_max, out_cmax, out_min, out_cmin, n_rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long <= 0) return (int)err;
  const dim3 cgrid((unsigned)n_long, (unsigned)((d + 255) / 256));
  seg_max_min_combine_kernel<<<cgrid, 256, 0, s>>>(
      part_max, part_cmax, part_min, part_cmin, long_rows, long_ptr, out_max,
      out_cmax, out_min, out_cmin, d);
  return (int)cudaGetLastError();
}

// msgs, col and the plan as above; max / cmax / min / cmin: the forward's
// (n_rows, d) outputs; g_max / g_min: (n_rows, d) float32 with unit column
// stride and the given row strides; pad: (n_pad,) int32, the message rows
// that col does not name; out: (n_msgs, d) float32.
int seg_max_min_bwd_csr(const float* msgs, const int* col, const int* units,
                        int n_units, const int* long_rows,
                        const int* long_ptr, int n_long, const float* mx,
                        const int* cmx, const float* mn, const int* cmn,
                        const float* g_max, int64_t g_max_stride,
                        const float* g_min, int64_t g_min_stride,
                        const int* pad, int n_pad, float* out, int n_rows,
                        int d, void* stream) {
  if (d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_units > 0) {
    const dim3 grid(
        (unsigned)((n_units + kWarpsPerBlock - 1) / kWarpsPerBlock),
        (unsigned)((d + Bwd::kChunk - 1) / Bwd::kChunk));
    seg_max_min_bwd_units_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
        msgs, col, units, n_units, long_rows, long_ptr, n_long, mx, cmx, mn,
        cmn, g_max, g_max_stride, g_min, g_min_stride, out, n_rows, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_pad > 0) {
    const int64_t n = (int64_t)n_pad * d;
    seg_max_min_bwd_pad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        pad, n_pad, out, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
