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
// handful of flops and an expf against 4-byte gathers and writes; the
// gathered s_src (n_src * H floats) fits in L2, so what is left beside the
// bytes is the latency of each unit's dependent col -> s_src loads and of
// its ordered sums, hidden by having many units in flight. The SDDMM
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
//   * softmax and its backward: one warp per work unit of the plan, segments
//     included, so a hub row runs on as many warps as it has segments
//     (reddit_like@paper's longest row, 12,679 edges, on 100), not on one
//     block that walks them. A call runs in phases, separate launches, so
//     nothing waits on a grid-wide barrier: (1) every unit; a whole row
//     finishes there, a segment writes its first partial (the softmax: its
//     scores' maximum, the scores kept in alpha's place; the backward: its
//     sum of alpha * dalpha; the row sums: its sum); (2) every segment: the
//     softmax reads its row's maxima, writes exp(score - m) and its sum;
//     the backward adds its row's partials left to right into c, writes dx
//     and its sum; (3) the softmax: every segment adds its row's sums left
//     to right (all alike, so all get the same z) and normalizes; the sums:
//     a warp per long row adds the partials into row_out. A segment finds
//     its row by a warp-wide search of long_ptr. A unit holds its terms in
//     registers across the steps of one launch (at most 4 edges a lane, H
//     floats each), so col and the gathered s_src rows are read once per
//     edge and alpha and dx written once, but for the edges of hub rows
//     (24% of reddit_like@paper's), whose terms pass through alpha's or
//     dx's place between launches;
//   * the ordered sums: the lanes stage a unit's terms in shared memory,
//     edge by edge, and lane h folds head h's in edge order, a load and an
//     add per edge, where a running sum carried by every lane through a
//     shuffle per (edge, head) took 25-37% longer; a row's partials come
//     into shared memory the same way, 128 at a time, in one load a lane
//     each. A maximum is a warp reduction (exact in any order). What is
//     left is mostly instructions (expf and the division per (edge, head))
//     and the latency of the dependent loads;
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
// workspace (2 * n_partials, H).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRowWarps = 4;      // warps per block of the row kernels
constexpr int kUnitEdges = 128;   // a unit's most edges (the plan's segment)
constexpr int kPerLane = kUnitEdges / 32;
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
  int n_partials;
  const float* s_src;   // kSoftmax, kSoftmaxBwd: (n_src, H)
  const float* s_dst;   // kSoftmax, kSoftmaxBwd: (n_rows, H)
  const float* alpha;   // kSoftmaxBwd: (nnz, H)
  const float* dalpha;  // kSoftmaxBwd: (nnz, H)
  const float* vals;    // kRowSum: (nnz, H), forward edge order
  const int* perm;      // kRowSum: (nnz,) edge -> forward edge
  float* edge_out;      // kSoftmax: alpha; kSoftmaxBwd: dx   (nnz, H)
  float* row_out;       // kSoftmaxBwd: d s_dst; kRowSum: d s_src (n_rows, H)
  float* part;          // (2 * n_partials, H): first partials, then second
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

// v = p[0, H): 16- or 8-byte loads where VEC (p is then so aligned).
template <int H, bool VEC>
__device__ __forceinline__ void load_heads(const float* p, float (&v)[H]) {
  if constexpr (VEC && H % 4 == 0) {
#pragma unroll
    for (int h = 0; h < H; h += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + h);
      v[h] = q.x, v[h + 1] = q.y, v[h + 2] = q.z, v[h + 3] = q.w;
    }
  } else if constexpr (VEC && H == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) v[h] = p[h];
  }
}

template <int H, bool VEC>
__device__ __forceinline__ void store_heads(float* p, const float (&v)[H]) {
  if constexpr (VEC && H % 4 == 0) {
#pragma unroll
    for (int h = 0; h < H; h += 4)
      *reinterpret_cast<float4*>(p + h) =
          make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
  } else if constexpr (VEC && H == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) p[h] = v[h];
  }
}

// The long row whose partial slots hold slot: the last i with long_ptr[i] <=
// slot (a long row has two segments or more, so long_ptr rises strictly).
// The warp probes 32 evenly spaced rows of the range a round and keeps the
// stretch after the last that is <= slot: 3 rounds for 1,092 long rows.
__device__ __forceinline__ int long_row_of(const RowArgs& a, int slot,
                                           int lane) {
  int lo = 0, len = a.n_long;  // long_ptr[lo] <= slot; the answer < lo + len
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int i = lo + lane * step;
    const bool le = lane * step < len && __ldg(a.long_ptr + i) <= slot;
    const int k = 31 - __clz(__ballot_sync(kFull, le));
    lo += k * step;
    len = len - k * step < step ? len - k * step : step;
  }
  return lo;
}

// A unit's edges e0 + i, i = lane + 32 j < n, are lane's slots j; the warp
// holds a unit's per-edge terms in v[j][h] across its phases.
template <int H>
using Terms = float[kPerLane][H];

// Stage the n terms in shared memory, edge by edge (H floats each), and fold
// them in edge order: lane h < H returns (...((0 + t_0[h]) + t_1[h]) ...) +
// t_{n-1}[h], every other lane 0. One lane per head reads the staged terms;
// no running sum passes through shuffles.
template <int H>
__device__ __forceinline__ float fold(float* s, const Terms<H>& v, int n,
                                      int lane) {
  __syncwarp();  // the lanes < H have read the stage's last contents
#pragma unroll
  for (int j = 0; j < kPerLane && 32 * j < n; ++j)
    if (lane + 32 * j < n) store_heads<H, true>(s + (lane + 32 * j) * H, v[j]);
  __syncwarp();
  float acc = 0.f;
  if (lane < H) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, s[i * H + lane]);
  }
  return acc;
}

// lane h < H: part[s0][h] + part[s0 + 1][h] + ... + part[s0 + ns - 1][h],
// left to right (every segment of a row makes the same adds); others 0. The
// partials come through the stage s kUnitEdges at a time, each chunk read by
// the whole warp at once, so the adds wait on shared memory, not on a load
// from L2 each.
template <int H>
__device__ __forceinline__ float combine(float* s, const float* part, int s0,
                                         int ns, int lane) {
  constexpr int kPer = kUnitEdges * H / 32;
  const float* p = part + (int64_t)s0 * H;
  float acc = 0.f;
  for (int k0 = 0; k0 < ns; k0 += kUnitEdges) {
    const int len = (ns - k0 < kUnitEdges ? ns - k0 : kUnitEdges) * H;
    float q[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      q[i] = lane + 32 * i < len ? p[(int64_t)k0 * H + lane + 32 * i] : 0.f;
    __syncwarp();  // the lanes < H have read the stage's last contents
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (lane + 32 * i < len) s[lane + 32 * i] = q[i];
    __syncwarp();
    if (lane < H) {
      int i = lane;
      if (k0 == 0) acc = s[lane], i += H;
#pragma unroll 8
      for (; i < len; i += H) acc = __fadd_rn(acc, s[i]);
    }
  }
  return acc;
}

// out[h] = lane h's v, on every lane.
template <int H>
__device__ __forceinline__ void bcast(float v, float (&out)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) out[h] = __shfl_sync(kFull, v, h);
}

// lane h < H writes its v to p[h].
template <int H>
__device__ __forceinline__ void put_lanes(float* p, float v, int lane) {
  if (lane < H) p[lane] = v;
}

// The scores leaky(s_src[col_e] + s_dst[r]) of the unit's edges, -inf where
// a slot holds none; m = their maximum per head, on every lane. col and the
// s_src rows are read once: all slots' columns, then all their rows. (The
// slots past the unit's last edge are skipped here, and in every loop of
// arithmetic below; the other loads are issued for all slots at once.)
template <int H, bool VEC>
__device__ __forceinline__ void scores(const RowArgs& a, int e0, int n, int r,
                                       int lane, Terms<H>& v, float (&m)[H]) {
  float sd[H];
  load_heads<H, VEC>(a.s_dst + (int64_t)r * H, sd);
  int c[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane && 32 * j < n; ++j)
    c[j] = lane + 32 * j < n ? __ldg(a.col + e0 + lane + 32 * j) : 0;
#pragma unroll
  for (int h = 0; h < H; ++h) m[h] = neg_inf();
#pragma unroll
  for (int j = 0; j < kPerLane && 32 * j < n; ++j) {
    if (lane + 32 * j < n) {
      load_heads<H, VEC>(a.s_src + (int64_t)c[j] * H, v[j]);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        v[j][h] = leaky(__fadd_rn(v[j][h], sd[h]));
        m[h] = fmaxf(m[h], v[j][h]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) v[j][h] = neg_inf();
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) m[h] = warp_max(m[h]);
}

// neg[j][h]: s_src[col_e, h] + s_dst[r, h] < 0, the leaky ReLU's slope 0.2
// (edges held; the rest false).
template <int H, bool VEC>
__device__ __forceinline__ void negatives(const RowArgs& a, int e0, int n,
                                          int r, int lane,
                                          bool (&neg)[kPerLane][H]) {
  float sd[H];
  load_heads<H, VEC>(a.s_dst + (int64_t)r * H, sd);
  int c[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    c[j] = lane + 32 * j < n ? __ldg(a.col + e0 + lane + 32 * j) : 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float x[H] = {};
    if (lane + 32 * j < n) load_heads<H, VEC>(a.s_src + (int64_t)c[j] * H, x);
#pragma unroll
    for (int h = 0; h < H; ++h) neg[j][h] = __fadd_rn(x[h], sd[h]) < 0.f;
  }
}

// v[j] = p[(e0 + lane + 32 j) * H, +H) for the edges held, 0 elsewhere.
template <int H, bool VEC>
__device__ __forceinline__ void load_edges(const float* p, int e0, int n,
                                           int lane, Terms<H>& v) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (lane + 32 * j < n) {
      load_heads<H, VEC>(p + (int64_t)(e0 + lane + 32 * j) * H, v[j]);
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) v[j][h] = 0.f;
    }
  }
}

template <int H, bool VEC>
__device__ __forceinline__ void store_edges(float* p, int e0, int n, int lane,
                                            const Terms<H>& v) {
#pragma unroll
  for (int j = 0; j < kPerLane && 32 * j < n; ++j)
    if (lane + 32 * j < n)
      store_heads<H, VEC>(p + (int64_t)(e0 + lane + 32 * j) * H, v[j]);
}

// dx = alpha * (dalpha - c), times 0.2 where x < 0; alpha, dalpha in al, da.
template <int H>
__device__ __forceinline__ void softmax_grad(Terms<H>& al, const Terms<H>& da,
                                             const bool (&neg)[kPerLane][H],
                                             const float (&c)[H], int n) {
#pragma unroll
  for (int j = 0; j < kPerLane && 32 * j < n; ++j) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float dx = __fmul_rn(al[j][h], __fsub_rn(da[j][h], c[h]));
      al[j][h] = neg[j][h] ? __fmul_rn(0.2f, dx) : dx;
    }
  }
}

// Phase 1, a warp per unit of the plan (every unit). A whole row (target <
// n_rows) runs its function to the end: kSoftmax writes alpha; kSoftmaxBwd
// dx and d s_dst; kRowSum the row sum. A segment (target n_rows + slot)
// writes its first partial to part[slot]: kSoftmax its scores' maximum (the
// scores go to edge_out); kSoftmaxBwd its sum of alpha * dalpha; kRowSum its
// sum.
template <int OP, int H, bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
rows_unit_kernel(RowArgs a) {
  __shared__ __align__(16) float stage[kRowWarps][kUnitEdges * H];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kRowWarps + warp;
  if (unit >= a.n_units) return;
  const int e0 = __ldg(a.units + 3 * unit);
  const int n = __ldg(a.units + 3 * unit + 1) - e0;
  const int t = __ldg(a.units + 3 * unit + 2);
  const bool whole = t < a.n_rows;
  float* s = stage[warp];
  float* part = a.part + (int64_t)(t - a.n_rows) * H;  // a segment's slot
  Terms<H> v;
  if constexpr (OP == kSoftmax) {
    const int r =
        whole ? t : __ldg(a.long_rows + long_row_of(a, t - a.n_rows, lane));
    float m[H];
    scores<H, VEC>(a, e0, n, r, lane, v, m);
    if (!whole) {
      store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (lane == h) part[h] = m[h];
      return;
    }
#pragma unroll
    for (int j = 0; j < kPerLane && 32 * j < n; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h)
        v[j][h] = lane + 32 * j < n ? expf(__fsub_rn(v[j][h], m[h])) : 0.f;
    float z[H];
    bcast<H>(fold<H>(s, v, n, lane), z);
#pragma unroll
    for (int j = 0; j < kPerLane && 32 * j < n; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h)
        v[j][h] = __fdiv_rn(v[j][h], fmaxf(z[h], 1e-16f));
    store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
  } else if constexpr (OP == kSoftmaxBwd) {
    Terms<H> da;
    bool neg[kPerLane][H];
    load_edges<H, VEC>(a.alpha, e0, n, lane, v);
    load_edges<H, VEC>(a.dalpha, e0, n, lane, da);
    if (whole) negatives<H, VEC>(a, e0, n, t, lane, neg);
    Terms<H> p;
#pragma unroll
    for (int j = 0; j < kPerLane && 32 * j < n; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h) p[j][h] = __fmul_rn(v[j][h], da[j][h]);
    const float acc = fold<H>(s, p, n, lane);
    if (!whole) {
      put_lanes<H>(part, acc, lane);
      return;
    }
    float c[H];
    bcast<H>(acc, c);
    softmax_grad<H>(v, da, neg, c, n);
    store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
    put_lanes<H>(a.row_out + (int64_t)t * H, fold<H>(s, v, n, lane), lane);
  } else {
    int p[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      p[j] = lane + 32 * j < n ? __ldg(a.perm + e0 + lane + 32 * j) : 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (lane + 32 * j < n) {
        load_heads<H, VEC>(a.vals + (int64_t)p[j] * H, v[j]);
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) v[j][h] = 0.f;
      }
    }
    const float acc = fold<H>(s, v, n, lane);
    put_lanes<H>(whole ? a.row_out + (int64_t)t * H : part, acc, lane);
  }
}

// Phases 2 and 3 over the segments of long rows, a warp per partial slot.
// kSoftmax, PASS 2: m = the maximum of the row's first partials; ex =
//   exp(score - m) over the segment (scores from edge_out, ex back to it);
//   their sum to the second partials.
// kSoftmax, PASS 3: z = the row's second partials added left to right;
//   alpha = ex / max(z, 1e-16) over the segment.
// kSoftmaxBwd (PASS 2): c = the row's first partials added left to right;
//   dx over the segment; its sum to the second partials.
template <int OP, int H, bool VEC, int PASS>
__global__ void __launch_bounds__(kRowWarps * 32)
rows_segment_kernel(RowArgs a) {
  __shared__ __align__(16) float stage[kRowWarps][kUnitEdges * H];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kRowWarps + warp;
  if (slot >= a.n_partials) return;
  const int i = long_row_of(a, slot, lane);
  const int r = __ldg(a.long_rows + i);
  const int s0 = __ldg(a.long_ptr + i), ns = __ldg(a.long_ptr + i + 1) - s0;
  const int re = __ldg(a.row_ptr + r + 1);
  const int e0 = __ldg(a.row_ptr + r) + (slot - s0) * a.segment;
  const int n = (e0 + a.segment < re ? e0 + a.segment : re) - e0;
  const float* first = a.part;
  float* second = a.part + (int64_t)a.n_partials * H;
  float* s = stage[warp];
  Terms<H> v;
  if constexpr (OP == kSoftmax && PASS == 2) {
    float m[H];
#pragma unroll
    for (int h = 0; h < H; ++h) m[h] = neg_inf();
    for (int k = lane; k < ns; k += 32) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        m[h] = fmaxf(m[h], first[(int64_t)(s0 + k) * H + h]);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) m[h] = warp_max(m[h]);
    load_edges<H, VEC>(a.edge_out, e0, n, lane, v);
#pragma unroll
    for (int j = 0; j < kPerLane && 32 * j < n; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h)
        v[j][h] = lane + 32 * j < n ? expf(__fsub_rn(v[j][h], m[h])) : 0.f;
    store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
    put_lanes<H>(second + (int64_t)slot * H, fold<H>(s, v, n, lane), lane);
  } else if constexpr (OP == kSoftmax) {
    float z[H];
    bcast<H>(combine<H>(s, second, s0, ns, lane), z);
    load_edges<H, VEC>(a.edge_out, e0, n, lane, v);
#pragma unroll
    for (int j = 0; j < kPerLane && 32 * j < n; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h)
        v[j][h] = __fdiv_rn(v[j][h], fmaxf(z[h], 1e-16f));
    store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
  } else {
    float c[H];
    bcast<H>(combine<H>(s, first, s0, ns, lane), c);
    Terms<H> da;
    bool neg[kPerLane][H];
    load_edges<H, VEC>(a.alpha, e0, n, lane, v);
    load_edges<H, VEC>(a.dalpha, e0, n, lane, da);
    negatives<H, VEC>(a, e0, n, r, lane, neg);
    softmax_grad<H>(v, da, neg, c, n);
    store_edges<H, VEC>(a.edge_out, e0, n, lane, v);
    put_lanes<H>(second + (int64_t)slot * H, fold<H>(s, v, n, lane), lane);
  }
}

// The last phase of the row sums, a warp per long row: row_out[r] = the
// row's partials (first or second) added left to right.
template <int H>
__global__ void __launch_bounds__(kRowWarps * 32)
rows_long_kernel(RowArgs a, int second) {
  __shared__ __align__(16) float stage[kRowWarps][kUnitEdges * H];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowWarps + warp;
  if (i >= a.n_long) return;
  const int s0 = __ldg(a.long_ptr + i), ns = __ldg(a.long_ptr + i + 1) - s0;
  const float* part = a.part + (int64_t)second * a.n_partials * H;
  put_lanes<H>(a.row_out + (int64_t)__ldg(a.long_rows + i) * H,
               combine<H>(stage[warp], part, s0, ns, lane), lane);
}

unsigned row_grid(int n) {
  return (unsigned)((n + kRowWarps - 1) / kRowWarps);
}

// The phases of OP, each a launch over all units, the segments or the long
// rows: no grid-wide barrier, no atomics, and a hub's segments run on as
// many warps as it has.
template <int OP, int H, bool VEC>
int launch_rows(const RowArgs& a, cudaStream_t s) {
  const unsigned block = kRowWarps * 32;
  if (a.n_units > 0) {
    rows_unit_kernel<OP, H, VEC><<<row_grid(a.n_units), block, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_long == 0) return (int)cudaSuccess;
  if constexpr (OP == kRowSum) {
    rows_long_kernel<H><<<row_grid(a.n_long), block, 0, s>>>(a, 0);
  } else {
    rows_segment_kernel<OP, H, VEC, 2>
        <<<row_grid(a.n_partials), block, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (OP == kSoftmax)
      rows_segment_kernel<OP, H, VEC, 3>
          <<<row_grid(a.n_partials), block, 0, s>>>(a);
    else
      rows_long_kernel<H><<<row_grid(a.n_long), block, 0, s>>>(a, 1);
  }
  return (int)cudaGetLastError();
}

// VEC: every per-edge or per-row float array a kernel reads or writes by
// head rows is aligned for 16-byte (H a multiple of 4) or 8-byte (H = 2)
// accesses.
template <int OP, int H>
int launch_aligned(const RowArgs& a, cudaStream_t s) {
  const uintptr_t need = H % 4 == 0 ? 16 : H == 2 ? 8 : 4;
  const uintptr_t ptrs = (uintptr_t)a.s_src | (uintptr_t)a.s_dst |
                         (uintptr_t)a.alpha | (uintptr_t)a.dalpha |
                         (uintptr_t)a.vals | (uintptr_t)a.edge_out;
  if (ptrs % need == 0) return launch_rows<OP, H, true>(a, s);
  return launch_rows<OP, H, false>(a, s);
}

template <int OP>
int dispatch_heads(const RowArgs& a, int n_heads, cudaStream_t s) {
  if (a.segment <= 0 || a.segment > kUnitEdges)
    return (int)cudaErrorInvalidValue;
  switch (n_heads) {
    case 1: return launch_aligned<OP, 1>(a, s);
    case 2: return launch_aligned<OP, 2>(a, s);
    case 4: return launch_aligned<OP, 4>(a, s);
    case 8: return launch_aligned<OP, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

RowArgs plan_args(const int* row_ptr, const int* col, const int* units,
                  int n_units, const int* long_rows, const int* long_ptr,
                  int n_long, int segment, int n_partials, int n_rows,
                  float* part) {
  RowArgs a = {};
  a.row_ptr = row_ptr;
  a.col = col;
  a.units = units;
  a.n_units = n_units;
  a.long_rows = long_rows;
  a.long_ptr = long_ptr;
  a.n_long = n_long;
  a.segment = segment;
  a.n_partials = n_partials;
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
// (n_long+1,), int32) plus the plan's segment length (at most 128) and its
// number of partial slots; part: (2 * n_partials, n_heads) float32
// workspace. n_heads is 1, 2, 4 or 8. Each call launches its phases on
// stream, one after another.
//
// s_src: (n_src, n_heads), s_dst: (n_rows, n_heads) float32 -> alpha:
// (nnz, n_heads) float32 in CSR order.
int gat_softmax(const float* s_src, const float* s_dst, const int* row_ptr,
                const int* col, const int* units, int n_units,
                const int* long_rows, const int* long_ptr, int n_long,
                int segment, int n_partials, float* part, float* alpha,
                int n_rows, int n_heads, void* stream) {
  RowArgs a = plan_args(row_ptr, col, units, n_units, long_rows, long_ptr,
                        n_long, segment, n_partials, n_rows, part);
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
                    const int* long_ptr, int n_long, int segment,
                    int n_partials, float* part, float* edge_out,
                    float* row_out, int n_rows, int n_heads, void* stream) {
  RowArgs a = plan_args(row_ptr, col, units, n_units, long_rows, long_ptr,
                        n_long, segment, n_partials, n_rows, part);
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
