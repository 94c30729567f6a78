// Flash-attention backward on Hopper: the gradient of the LM's prefill
// attention (kernels/flash/ops.py::attention_bshd) with respect to q, k and
// v, from the forward's output O and per-row log-sum-exp `lse`:
//   Delta = rowsum(dO * O),
//   P = exp(S_c - lse), S_c = scale * q . k, or cap * tanh(scale * q . k /
//       cap) under a softcap (gemma2), 0 where the mask hides the key,
//   dP = dO V^T,
//   dS = P * (dP - Delta), times 1 - (S_c / cap)^2 under a softcap,
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO,
// with GQA (dK and dV sum each KV head's query heads), causal and
// sliding-window masks, a kv_len bound and values narrower than the keys
// (MLA: D = 192, Dv = 128). float32 in and out: the reference trains in
// float32.
//
// Replaces no Pallas kernel: the Pallas flash kernel
// (src/repro/kernels/flash/flash.py::_flash_kernel) has no backward, and the
// JAX package differentiates src/repro/models/lm/model.py::
// blockwise_attention (:126) itself, recomputing each KV block's scores
// (_ATTN_SCAN_REMAT, :114). This is the gradient of the function that
// csrc/flash.cu computes; its plain version is kernels/flash/ref.py::
// attention_bshd_bwd_ref, held to jax.vjp of blockwise_attention on the CPU.
//
// What bounds it on an H100: operations. Per visible (query, key) pair the
// backward needs five products, 2 * (3 D + 2 Dv) flops; at granite-3-2b's
// training shape (batch 4, 2,048 tokens, 32 heads, D = 64, causal) that is
// 172 GFLOP a layer against 0.2 GB of inputs and outputs. Two kernels
// without atomics recompute S and dP in both: dq does three products (S,
// dP, dQ), dkdv four (S, dP, dV, dK). Every product runs on the tensor
// cores as 3xTF32, the forward's convention: each float32 operand x is
// split into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest (cvt.rna's rounding), and small*big + big*small + big*big
// accumulate in float32 (m16n8k8 TF32 mma.sync), close to float32 accuracy
// (one TF32 product alone misses the 1e-4 gate by 10x). The bound counts
// three TF32 products per multiply-add. What holds the kernels below it is
// the work around the products: the splits (an integer rounding, not the
// cvt.rna.tf32.f32 conversion, which took ~40% of the time), the fragment
// loads and the tile hand-overs.
//
// Design: two kernels, launched one after the other on the same stream,
// deterministic and without atomics.
//   * flash_bwd_dq: grid (query tiles, batch * heads), heaviest first. A
//     block of NW warps owns NW * 16 query rows, 16 per warp. Its prologue
//     computes Delta for each warp's own rows (from global memory, kept in
//     registers) and writes it to a (batch * heads, Sq) buffer; q and dO
//     stay in shared memory. It streams the K/V tiles its rows see (the
//     forward's skip of tiles above the causal diagonal, below every row's
//     window or past kv_len; per warp too), double-buffered. S = Q K^T and
//     dP = dO V^T land in mma accumulator fragments (rows g, g + 8; keys
//     2t, 2t + 1 of each 8-key group, g = lane / 4, t = lane % 4), dS is
//     formed in those registers and feeds dQ += dS K as the A operand
//     straight from them: the A fragment's k = t stands for key 2t and
//     k = t + 4 for key 2t + 1, and K's B fragment reads the same keys (the
//     forward's P V trick), so no shared-memory trip is needed.
//   * flash_bwd_dkdv: grid (key tiles, batch * kv_heads), heaviest (causal)
//     first. A block owns NP * 16 keys of one KV head, K and V in shared
//     memory, and streams, in a fixed order, the query tiles of its KV
//     head's H / Hkv query heads that see its keys (q, dO and their lse and
//     Delta rows, double-buffered): GQA's sum happens inside the block, no
//     second pass, no atomics, the same bits on every run. Scores are
//     computed transposed, keys as rows (S^T = K Q^T, dP^T = V dO^T, as
//     FlashAttention-2's dkdv does), so P^T and dS^T are already A
//     fragments of dV += P^T dO and dK += dS^T Q. A warp holding 16 keys'
//     dK and dV (16 x (192 + 128) floats at MLA's widths, 160 registers a
//     thread) would spill, so two warps share 16 keys and split the work by
//     accumulator: the P warp computes S^T, P^T and dV; the dS warp
//     computes dP^T, takes P^T (times the cap's derivative) from the P warp
//     through shared memory, kept in fragment order (one float4 a lane and
//     8-query group, no bank conflict), forms dS^T and accumulates dK. One
//     named barrier a pair and tile orders the hand-over. lse and Delta are
//     per query, so per column: each lane reads its own columns'.
//   * copies: the streamed tiles are double-buffered with cp.async, 16
//     bytes where a tensor's rows are 16-byte aligned (MLA's v, a column
//     slice of kv, is), else 4 bytes an element; both zero-fill rows past
//     the end and columns past the width. Tiles are row-major with a pitch
//     of 4 (mod 32) floats, so every fragment load of a warp, row-wise or
//     column-wise, hits 32 distinct banks.
//   * fragments: row-wise ones (the scores' A and B operands) come by
//     ldmatrix, four 8 x 4 float matrices an instruction; column-wise ones
//     (the B operand of dQ, dK and dV) by 32-bit loads. Each float32
//     operand is split into its TF32 halves as its fragment is loaded: an
//     A fragment once for the row of products that shares it, a B fragment
//     at each product (a tile split once in shared memory would take twice
//     the room: MLA's tiles fill 205 KB already).
//   * dQ, dK and dV sum each tile's products in fresh registers and add
//     that to the accumulator: the tensor cores' float32 accumulation
//     truncates, and over the thousands of steps of dK and dV's sums its
//     bias reached ~1e-4 of the largest (measured on the card).
//   * scale multiplies the score fragment and, at the end, dQ and dK; a
//     masked score's P is exactly 0, so it adds nothing, and a row that
//     sees no key (lse = -inf, O = 0) gets dQ = 0 and adds nothing to dK or
//     dV. Rows beyond Sq are never written; keys in [kv_len, Skv) get 0.
//   * the softcap is a template flag (CAP), as in the forward.
// Tiles (dispatch): D padded to DP, v to DVP (its own width only at MLA's
// 192 / 128, without a cap). Registers stay within ptxas's budget with no
// spill: 128 a thread where two blocks share an SM (DP <= 64), up to 255
// above.
//   dq (NW warps, BK keys a tile):  DP <= 128: 8, 32;  192 / 128: 8, 16;
//     192 and 256: 4, 16.
//   dkdv (NP pairs, BQ queries a tile):  DP <= 128 and 192 / 128: 4, 32;
//     192: 4, 16;  256: 2, 16.
// The kernels allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (batch * heads, sq), natural units
  float* delta;      // (batch * heads, sq), written by flash_bwd_dq
  float* grad_q;
  float* grad_k;
  float* grad_v;
  // element strides {batch, sequence, head} (the last dim is contiguous)
  int64_t q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  int64_t sq, skv, kv_end, window;  // kv_end = min(skv, kv_len); window <= 0: none
  int heads, kv_heads, group, d, dv, causal;
  int vec_q, vec_k, vec_v, vec_do;  // rows copy as 16-byte chunks
  float scale;
  float softcap;  // <= 0: none
};

__device__ __forceinline__ bool visible(const BwdParams& p, int64_t qp,
                                        int64_t kp) {
  return qp < p.sq && kp < p.kv_end && (!p.causal || kp <= qp) &&
         (p.window <= 0 || qp - kp < p.window);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` of `threads` threads: the producer arrives, the
// consumer waits (the block's own barrier is id 0).
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// x = big + small, both TF32 rounded to nearest, ties away, as
// cvt.rna.tf32.f32 rounds. The tensor cores read a TF32 operand's top 19
// bits and ignore the low 13, so half a TF32 unit added to the bits rounds
// it; only big's value, which small subtracts, needs its low bits cleared.
// Three additions and a mask in place of two conversions: with
// cvt.rna.tf32.f32 the splits took about 40% of the kernels' time on an
// H100.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  const float rest = x - __uint_as_float(big & 0xffffe000u);
  small = __float_as_uint(rest) + 0x1000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// c += a * b, one m16n8k8 TF32 product with float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of an accumulator fragment's 16 x 8 block (the forward's
// P V trick: k = t is column 2t, k = t + 4 is column 2t + 1), split.
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_tf32(a, big, small);
}

// Four 8 x 4 float32 matrices of shared memory into r: lanes 8i .. 8i + 7
// each address one 16-byte row of matrix i, and this lane gets word
// lane % 4 of row lane / 4 of matrix i in r[i], the m16n8k8 TF32 fragment
// layout: one instruction in place of four loads.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// The same for float32 values held as their bits (ldmatrix's output).
template <int N>
__device__ __forceinline__ void split_bits(const uint32_t (&x)[N],
                                           uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// x[j] = A B^T in 3xTF32 for A's 16 rows (row-major, pitch LDA, from `a`)
// and B's rows 8j .. 8j + 7 (row-major, pitch LDB, from `b`) over KS steps
// of 8 columns: a score tile, rows as A's, 8 NJ columns (NJ even). Both
// operands come by ldmatrix: A's four matrices are rows 0-7 / 8-15 x
// columns 0-3 / 4-7, B's two column groups j, j + 1 x columns 0-3 / 4-7.
template <int NJ, int KS, int LDA, int LDB>
__device__ __forceinline__ void scores(float (&x)[NJ][4], const float* a,
                                       const float* b, int lane) {
  static_assert(NJ % 2 == 0, "column groups come in pairs");
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  const float* a_row =
      a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDA + 4 * (lane >> 4);
  const float* b_row =
      b + ((lane & 7) + 8 * (lane >> 4)) * LDB + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ar[4], a_big[4], a_small[4];
    ldsm4(ar, a_row + ks * 8);
    split_bits(ar, a_big, a_small);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t br[4], b_big[4], b_small[4];
      ldsm4(br, b_row + jp * 16 * LDB + ks * 8);
      split_bits(br, b_big, b_small);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t bb[2] = {b_big[2 * h], b_big[2 * h + 1]};
        const uint32_t bs[2] = {b_small[2 * h], b_small[2 * h + 1]};
        mma_tf32(x[2 * jp + h], a_small, bb);
        mma_tf32(x[2 * jp + h], a_big, bs);
        mma_tf32(x[2 * jp + h], a_big, bb);
      }
    }
  }
}

// acc[j] += X B for the accumulator fragments x (16 rows x 8 NK columns,
// the A operand through acc_as_a) and the B operand read column-wise from
// b0 = &B[2t][g] of a row-major tile with pitch LD (B's rows are x's
// columns): NJ column groups of 8. Each column group's sum over this tile
// is taken in fresh registers and added to acc once: the tensor cores'
// float32 accumulation truncates, and over the thousands of steps of a
// long sum (dK and dV over every query of a KV head's group) its bias
// reached ~1e-4 of the largest (measured on the card).
template <int NJ, int NK, int LD, int NA>
__device__ __forceinline__ void tile_product(float (&acc)[NA][4],
                                             const float (&x)[NK][4],
                                             const float* b0) {
  uint32_t a_big[NK][4], a_small[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) acc_as_a(x[kk], a_big[kk], a_small[kk]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const float* br = b0 + kk * 8 * LD + j * 8;
      const float b[2] = {br[0], br[LD]};
      uint32_t b_big[2], b_small[2];
      split_tf32(b, b_big, b_small);
      mma_tf32(part, a_small[kk], b_big);
      mma_tf32(part, a_big[kk], b_small);
      mma_tf32(part, a_big[kk], b_big);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
  }
}

// Rows [row0, row0 + ROWS) of a (seq, width) slice with row stride `rs`
// into a tile with row pitch LD and W columns, by cp.async: 16-byte chunks
// where the rows are 16-byte aligned (`vec`; width % 4 == 0), else 4-byte
// elements. Rows past `valid` and columns past `width` are zero-filled.
template <int ROWS, int W, int LD, int NT>
__device__ __forceinline__ void copy_rows(float* tile, const float* base,
                                          int64_t rs, int64_t row0,
                                          int64_t valid, int width,
                                          bool vec) {
  if (vec) {
    constexpr int kChunks = W / 4;
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
      const int r = idx / kChunks;
      const int c = (idx - r * kChunks) * 4;
      const int64_t row = row0 + r;
      const bool ok = row < valid && c < width;
      cp_async16(tile + r * LD + c, ok ? base + row * rs + c : base,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += NT) {
      const int r = idx / W;
      const int c = idx - r * W;
      const int64_t row = row0 + r;
      const bool ok = row < valid && c < width;
      cp_async4(tile + r * LD + c, ok ? base + row * rs + c : base,
                ok ? 4 : 0);
    }
  }
}

// P for the uncapped score x = q . k (unscaled) and the row's lse; times the
// cap's derivative through `deriv` (1 without a cap).
template <bool CAP>
__device__ __forceinline__ float prob(float x, float lse, float scale,
                                      float cap, float inv_cap,
                                      float& deriv) {
  x *= scale;
  deriv = 1.f;
  if constexpr (CAP) {
    const float th = tanhf(x * inv_cap);
    x = cap * th;
    deriv = 1.f - th * th;
  }
  return exp2f((x - lse) * kLog2e);
}

// Row pitch: the width rounded up to 32 floats, plus 4 (= 4 mod 32).
constexpr int pitch(int w) { return (w + 31) / 32 * 32 + 4; }

template <int DP, int DVP, int NW, int BK>
struct DqCfg {
  static constexpr int kThreads = NW * 32, BQ = NW * 16;
  static constexpr int LD = pitch(DP), LDV = pitch(DVP);
  static constexpr size_t kSmem =
      (size_t)(BQ * LD + BQ * LDV + 2 * BK * LD + 2 * BK * LDV) *
      sizeof(float);
  static constexpr int kMinBlocks = kSmem * 2 <= 227 * 1024 ? 2 : 1;
  static_assert(kSmem <= 227 * 1024, "tiles exceed the shared memory");
  static_assert(DP % 8 == 0 && DVP % 8 == 0 && BK % 8 == 0 && DVP <= DP,
                "tile widths");
};

template <int DP, int DVP, int NW, int BK, bool CAP>
__global__ void __launch_bounds__(DqCfg<DP, DVP, NW, BK>::kThreads,
                                  DqCfg<DP, DVP, NW, BK>::kMinBlocks)
flash_bwd_dq_kernel(const BwdParams p) {
  using C = DqCfg<DP, DVP, NW, BK>;
  constexpr int NT = C::kThreads, BQ = C::BQ, LD = C::LD, LDV = C::LDV;
  constexpr int KS = DP / 8, KV = DVP / 8, NKT = BK / 8, NDT = DP / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* sdO = sQ + BQ * LD;                     // BQ x LDV
  float* sK = sdO + BQ * LDV;                    // 2 buffers of BK x LD
  float* sV = sK + 2 * BK * LD;                  // 2 buffers of BK x LDV

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qt = (int64_t)gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int hk = h / p.group;
  const int64_t q_lo = qt * BQ;
  const int64_t q_last = (q_lo + BQ < p.sq ? q_lo + BQ : p.sq) - 1;
  const int64_t wq_lo = q_lo + warp * 16;  // this warp's first row

  const float* qb = p.q + b * p.q_s[0] + h * p.q_s[2];
  const float* kb = p.k + b * p.k_s[0] + hk * p.k_s[2];
  const float* vb = p.v + b * p.v_s[0] + hk * p.v_s[2];
  const float* ob = p.o + b * p.o_s[0] + h * p.o_s[2];
  const float* dob = p.dout + b * p.do_s[0] + h * p.do_s[2];

  copy_rows<BQ, DP, LD, NT>(sQ, qb, p.q_s[1], q_lo, p.sq, p.d, p.vec_q);
  copy_rows<BQ, DVP, LDV, NT>(sdO, dob, p.do_s[1], q_lo, p.sq, p.dv,
                              p.vec_do);
  cp_async_commit();

  // the key range any row of this block sees (the forward's)
  int64_t k_stop = p.kv_end;
  if (p.causal && q_last + 1 < k_stop) k_stop = q_last + 1;
  int64_t k_first = 0;
  if (p.window > 0 && q_lo - p.window + 1 > 0) k_first = q_lo - p.window + 1;
  const int64_t k_lo0 = k_first / BK * BK;
  const int n_tiles =
      k_lo0 < k_stop ? (int)((k_stop - k_lo0 + BK - 1) / BK) : 0;
  auto load_kv = [&](int buf, int64_t k_lo) {
    copy_rows<BK, DP, LD, NT>(sK + buf * BK * LD, kb, p.k_s[1], k_lo,
                              p.kv_end, p.d, p.vec_k);
    copy_rows<BK, DVP, LDV, NT>(sV + buf * BK * LDV, vb, p.v_s[1], k_lo,
                                p.kv_end, p.dv, p.vec_v);
  };
  if (n_tiles > 0) load_kv(0, k_lo0);
  cp_async_commit();

  // Delta = rowsum(dO * O) of this warp's 16 rows, written for
  // flash_bwd_dkdv; this lane keeps rows g and g + 8, with their lse
  float delta[2] = {0.f, 0.f}, lse[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int64_t row = wq_lo + r;
    float sum = 0.f;
    if (row < p.sq)
      for (int c = lane; c < p.dv; c += 32)
        sum += dob[row * p.do_s[1] + c] * ob[row * p.o_s[1] + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (row < p.sq && lane == 0) p.delta[(int64_t)bh * p.sq + row] = sum;
    if (r == g) delta[0] = sum;
    if (r == g + 8) delta[1] = sum;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t row = wq_lo + g + 8 * rr;
    if (row < p.sq) lse[rr] = p.lse[(int64_t)bh * p.sq + row];
  }

  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float cap = p.softcap, inv_cap = CAP ? 1.f / p.softcap : 0.f;
  const float* wQ = sQ + warp * 16 * LD;
  const float* wdO = sdO + warp * 16 * LDV;

  for (int i = 0; i < n_tiles; ++i) {
    const int64_t k_lo = k_lo0 + (int64_t)i * BK;
    if (i + 1 < n_tiles) {
      load_kv((i + 1) & 1, k_lo + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // skip a tile that none of this warp's rows sees
    const bool active =
        wq_lo < p.sq && !(p.causal && k_lo > wq_lo + 15) &&
        !(p.window > 0 && k_lo + BK - 1 < wq_lo - p.window + 1);
    if (active) {
      const float* Kt = sK + (i & 1) * BK * LD;
      const float* Vt = sV + (i & 1) * BK * LDV;
      // S = Q K^T and dP = dO V^T: s[j] and dp[j] hold keys 8j + 2t, +1
      float s[NKT][4], dp[NKT][4];
      scores<NKT, KS, LD, LD>(s, wQ, Kt, lane);
      scores<NKT, KV, LDV, LDV>(dp, wdO, Vt, lane);
      // dS in place of S; masks only where some score of this warp's rows
      // is not visible
      const bool full =
          k_lo + BK <= p.kv_end && wq_lo + 16 <= p.sq &&
          (!p.causal || k_lo + BK - 1 <= wq_lo) &&
          (p.window <= 0 || wq_lo + 15 - k_lo < p.window);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float deriv;
          float pr = prob<CAP>(s[j][e], lse[e >> 1], p.scale, cap, inv_cap,
                               deriv);
          if (!full && !visible(p, wq_lo + g + (e >> 1) * 8,
                                k_lo + j * 8 + 2 * t + (e & 1)))
            pr = 0.f;
          s[j][e] = pr * (dp[j][e] - delta[e >> 1]) * deriv;
        }
      // dQ += dS K (the scale is applied once at the end)
      tile_product<NDT, NKT, LD>(acc, s, Kt + 2 * t * LD + g);
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  cp_async_wait<0>();  // no copy is left in flight (n_tiles == 0)

  float* dqb = p.grad_q + b * p.dq_s[0] + h * p.dq_s[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t row = wq_lo + g + rr * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col < p.d)
          dqb[row * p.dq_s[1] + col] = acc[j][2 * rr + e] * p.scale;
      }
  }
}

template <int DP, int DVP, int NP, int BQ>
struct DkvCfg {
  static constexpr int kThreads = NP * 64, BK = NP * 16;
  static constexpr int LD = pitch(DP), LDV = pitch(DVP);
  static constexpr size_t kSmem =
      (size_t)(BK * LD + BK * LDV + 2 * BQ * LD + 2 * BQ * LDV +
               NP * 16 * BQ + 4 * BQ) * sizeof(float);
  static constexpr int kMinBlocks = kSmem * 2 <= 227 * 1024 ? 2 : 1;
  static_assert(kSmem <= 227 * 1024, "tiles exceed the shared memory");
  static_assert(DP % 8 == 0 && DVP % 8 == 0 && BQ % 8 == 0 && DVP <= DP,
                "tile widths");
};

template <int DP, int DVP, int NP, int BQ, bool CAP>
__global__ void __launch_bounds__(DkvCfg<DP, DVP, NP, BQ>::kThreads,
                                  DkvCfg<DP, DVP, NP, BQ>::kMinBlocks)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using C = DkvCfg<DP, DVP, NP, BQ>;
  constexpr int NT = C::kThreads, BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int KS = DP / 8, KV = DVP / 8, NQT = BQ / 8;
  constexpr int NA = DP / 8;  // accumulator column groups (dK's; dV's fewer)
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // BK x LD
  float* sV = sK + BK * LD;                      // BK x LDV
  float* sQ = sV + BK * LDV;                     // 2 buffers of BQ x LD
  float* sdO = sQ + 2 * BQ * LD;                 // 2 buffers of BQ x LDV
  float4* sP = reinterpret_cast<float4*>(sdO + 2 * BQ * LDV);  // NP x NQT x 32
  float* sLse = reinterpret_cast<float*>(sP + NP * NQT * 32);  // 2 x BQ
  float* sDelta = sLse + 2 * BQ;                               // 2 x BQ

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the P warp (role 0) and the dS warp (role 1) of pair `pair` share keys
  // [wk_lo, wk_lo + 16); the roles' halves spread over the SM's quarters
  const int role = warp / NP, pair = warp - role * NP;
  const int64_t k_lo = (int64_t)blockIdx.x * BK;  // heaviest (causal) first
  const int64_t wk_lo = k_lo + pair * 16;
  const int bhk = blockIdx.y;
  const int b = bhk / p.kv_heads;
  const int hk = bhk - b * p.kv_heads;

  const float* kb = p.k + b * p.k_s[0] + hk * p.k_s[2];
  const float* vb = p.v + b * p.v_s[0] + hk * p.v_s[2];
  copy_rows<BK, DP, LD, NT>(sK, kb, p.k_s[1], k_lo, p.kv_end, p.d, p.vec_k);
  copy_rows<BK, DVP, LDV, NT>(sV, vb, p.v_s[1], k_lo, p.kv_end, p.dv,
                              p.vec_v);
  cp_async_commit();

  // the query rows that see any key of this block
  const int64_t k_hi = k_lo + BK < p.kv_end ? k_lo + BK : p.kv_end;
  const int64_t q_first = p.causal ? k_lo : 0;
  int64_t q_stop = p.sq;
  if (p.window > 0 && k_hi - 1 + p.window < q_stop)
    q_stop = k_hi - 1 + p.window;
  const int64_t q_lo0 = q_first / BQ * BQ;
  const int n_qt = k_lo < k_hi && q_lo0 < q_stop
                       ? (int)((q_stop - q_lo0 + BQ - 1) / BQ) : 0;
  const int n_tiles = n_qt * p.group;  // (query head, query tile), in order

  auto load_q = [&](int buf, int i) {
    const int gi = i / n_qt;
    const int64_t q_lo = q_lo0 + (int64_t)(i - gi * n_qt) * BQ;
    const int h = hk * p.group + gi;
    const int64_t bh = (int64_t)b * p.heads + h;
    copy_rows<BQ, DP, LD, NT>(sQ + buf * BQ * LD,
                              p.q + b * p.q_s[0] + h * p.q_s[2], p.q_s[1],
                              q_lo, p.sq, p.d, p.vec_q);
    copy_rows<BQ, DVP, LDV, NT>(sdO + buf * BQ * LDV,
                                p.dout + b * p.do_s[0] + h * p.do_s[2],
                                p.do_s[1], q_lo, p.sq, p.dv, p.vec_do);
    for (int r = threadIdx.x; r < 2 * BQ; r += NT) {
      const int rq = r < BQ ? r : r - BQ;
      const bool in = q_lo + rq < p.sq;
      const float* src = (r < BQ ? p.lse : p.delta) + bh * p.sq + q_lo + rq;
      float* dst = (r < BQ ? sLse : sDelta) + buf * BQ + rq;
      cp_async4(dst, in ? src : p.lse, in ? 4 : 0);
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();

  // role 0: dV (DVP / 8 column groups); role 1: dK (DP / 8)
  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float cap = p.softcap, inv_cap = CAP ? 1.f / p.softcap : 0.f;
  float4* pP = sP + pair * NQT * 32 + lane;

  for (int i = 0; i < n_tiles; ++i) {
    const int gi = i / n_qt;
    const int64_t q_lo = q_lo0 + (int64_t)(i - gi * n_qt) * BQ;
    if (i + 1 < n_tiles) {
      load_q((i + 1) & 1, i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // skip a tile that none of this pair's keys sees
    const bool active =
        wk_lo < p.kv_end && !(p.causal && wk_lo > q_lo + BQ - 1) &&
        !(p.window > 0 && q_lo - (wk_lo + 15) >= p.window);
    if (active) {
      const float* Qt = sQ + (i & 1) * BQ * LD;
      const float* dOt = sdO + (i & 1) * BQ * LDV;
      const float* Lt = sLse + (i & 1) * BQ;
      const float* Dt = sDelta + (i & 1) * BQ;
      const bool full =
          wk_lo + 16 <= p.kv_end && q_lo + BQ <= p.sq &&
          (!p.causal || wk_lo + 15 <= q_lo) &&
          (p.window <= 0 || q_lo + BQ - 1 - wk_lo < p.window);
      // s[j]: keys g, g + 8 (rows) x queries 8j + 2t, +1 (columns)
      float s[NQT][4];
      if (role == 0) {
        // S^T = K Q^T, then P^T; P^T (times the cap's derivative) goes to
        // the dS warp; dV += P^T dO
        scores<NQT, KS, LD, LD>(s, sK + pair * 16 * LD, Qt, lane);
#pragma unroll
        for (int j = 0; j < NQT; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(Lt + j * 8 + 2 * t);
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float deriv;
            float pr = prob<CAP>(s[j][e], (e & 1) ? l2.y : l2.x, p.scale, cap,
                                 inv_cap, deriv);
            if (!full && !visible(p, q_lo + j * 8 + 2 * t + (e & 1),
                                  wk_lo + g + (e >> 1) * 8))
              pr = 0.f;
            s[j][e] = pr;
            pd[e] = pr * deriv;
          }
          pP[j * 32] = make_float4(pd[0], pd[1], pd[2], pd[3]);
        }
        bar_arrive(1 + pair, 64);
        tile_product<KV, NQT, LDV>(acc, s, dOt + 2 * t * LDV + g);
      } else {
        // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta); dK += dS^T Q
        scores<NQT, KV, LDV, LDV>(s, sV + pair * 16 * LDV, dOt, lane);
        bar_sync(1 + pair, 64);
#pragma unroll
        for (int j = 0; j < NQT; ++j) {
          const float4 pd = pP[j * 32];
          const float2 d2 =
              *reinterpret_cast<const float2*>(Dt + j * 8 + 2 * t);
          s[j][0] = pd.x * (s[j][0] - d2.x);
          s[j][1] = pd.y * (s[j][1] - d2.y);
          s[j][2] = pd.z * (s[j][2] - d2.x);
          s[j][3] = pd.w * (s[j][3] - d2.y);
        }
        tile_product<KS, NQT, LD>(acc, s, Qt + 2 * t * LD + g);
      }
    }
    __syncthreads();  // this buffer's and sP's reads are done
  }
  cp_async_wait<0>();  // no copy is left in flight (n_tiles == 0)

  // role 0 writes dV, role 1 dK (times scale); keys past kv_len get 0
  float* out = role == 0 ? p.grad_v + b * p.dv_s[0] + hk * p.dv_s[2]
                         : p.grad_k + b * p.dk_s[0] + hk * p.dk_s[2];
  const int64_t rs = role == 0 ? p.dv_s[1] : p.dk_s[1];
  const int width = role == 0 ? p.dv : p.d;
  const float mul = role == 0 ? 1.f : p.scale;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t key = wk_lo + g + rr * 8;
    if (key >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col < width) out[key * rs + col] = acc[j][2 * rr + e] * mul;
      }
  }
}

template <int DP, int DVP, int NW, int BK, bool CAP>
cudaError_t launch_dq(const BwdParams& p, int64_t batch, cudaStream_t s) {
  using C = DqCfg<DP, DVP, NW, BK>;
  auto* kernel = flash_bwd_dq_kernel<DP, DVP, NW, BK, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + C::BQ - 1) / C::BQ),
                  (unsigned)(batch * p.heads));
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <int DP, int DVP, int NP, int BQ, bool CAP>
cudaError_t launch_dkdv(const BwdParams& p, int64_t batch, cudaStream_t s) {
  using C = DkvCfg<DP, DVP, NP, BQ>;
  auto* kernel = flash_bwd_dkdv_kernel<DP, DVP, NP, BQ, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.skv + C::BK - 1) / C::BK),
                  (unsigned)(batch * p.kv_heads));
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(p);
  return cudaGetLastError();
}

// Tiles by head width (D padded to DP, v to DVP), as the note at the top
// lists: dq takes (NW warps, BK keys), dkdv (NP pairs, BQ queries). v gets a
// width of its own only at MLA's D 192 / Dv 128, without a softcap.
template <bool DQ, bool CAP>
cudaError_t dispatch(const BwdParams& p, int64_t batch, cudaStream_t s) {
#define REPRO_BWD(DP, DVP, NW, BK, NP, BQ)                          \
  {                                                                 \
    if constexpr (DQ)                                               \
      return launch_dq<DP, DVP, NW, BK, CAP>(p, batch, s);          \
    else                                                            \
      return launch_dkdv<DP, DVP, NP, BQ, CAP>(p, batch, s);        \
  }
  if (p.d <= 32) REPRO_BWD(32, 32, 8, 32, 4, 32)
  if (p.d <= 64) REPRO_BWD(64, 64, 8, 32, 4, 32)
  if (p.d <= 128) REPRO_BWD(128, 128, 8, 32, 4, 32)
  if (p.d <= 192) {
    if constexpr (!CAP) {
      if (p.dv <= 128) REPRO_BWD(192, 128, 8, 16, 4, 32)
    }
    REPRO_BWD(192, 192, 4, 16, 4, 16)
  }
  if (p.d <= 256) REPRO_BWD(256, 256, 4, 16, 2, 16)
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

// Rows of a tensor copy as 16-byte chunks: its pointer is 16-byte aligned
// and its width and strides {batch, seq, head} are multiples of 4 floats.
bool aligned16(const float* ptr, const int64_t* strides, int width) {
  if ((uintptr_t)ptr % 16 != 0 || width % 4 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

int run(bool dq_pass, const float* q, const float* k, const float* v,
        const float* o, const float* dout, const float* lse, float* delta,
        float* dq, float* dk, float* dv, int64_t batch, int heads,
        int kv_heads, int64_t sq, int64_t skv, int d, int dv_width,
        const int64_t* strides, float scale, float softcap, int causal,
        int64_t window, int64_t kv_len, void* stream) {
  if (d < 1 || d > 256 || dv_width < 1 || dv_width > d || heads < 1 ||
      kv_heads < 1 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse;
  p.delta = delta; p.grad_q = dq; p.grad_k = dk; p.grad_v = dv;
  int64_t* dst[8] = {p.q_s, p.k_s, p.v_s, p.o_s, p.do_s, p.dq_s, p.dk_s,
                     p.dv_s};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.sq = sq; p.skv = skv;
  p.kv_end = kv_len < skv ? kv_len : skv;
  if (p.kv_end < 0) p.kv_end = 0;
  p.window = window;
  p.heads = heads; p.kv_heads = kv_heads; p.group = heads / kv_heads;
  p.d = d; p.dv = dv_width; p.causal = causal;
  p.vec_q = aligned16(q, p.q_s, d);
  p.vec_k = aligned16(k, p.k_s, d);
  p.vec_v = aligned16(v, p.v_s, dv_width);
  p.vec_do = aligned16(dout, p.do_s, dv_width);
  p.scale = scale; p.softcap = softcap;
  if (batch == 0 || (dq_pass ? sq : skv) == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (softcap > 0.f)
    err = dq_pass ? dispatch<true, true>(p, batch, s)
                  : dispatch<false, true>(p, batch, s);
  else
    err = dq_pass ? dispatch<true, false>(p, batch, s)
                  : dispatch<false, false>(p, batch, s);
  return (int)err;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Both entry points take the same arguments. q: (batch, sq, heads, d), k:
// (batch, skv, kv_heads, d), v: (batch, skv, kv_heads, dv); o and dout
// (batch, sq, heads, dv); dq, dk, dv shaped as q, k, v; all float32 with a
// contiguous last dim and element strides {batch, seq, head} in
// strides[0..23] (q, k, v, o, dout, dq, dk, dv). lse and delta: float32
// (batch * heads, sq). flash_bwd_dq writes delta and dq; flash_bwd_dkdv
// reads delta and writes dk and dv, so it runs second, on the same stream.
// window <= 0 and softcap <= 0 mean none; causal is 0 or 1.
int flash_bwd_dq(const float* q, const float* k, const float* v,
                 const float* o, const float* dout, const float* lse,
                 float* delta, float* dq, float* dk, float* dv,
                 int64_t batch, int heads, int kv_heads, int64_t sq,
                 int64_t skv, int d, int dv_width, const int64_t* strides,
                 float scale, float softcap, int causal, int64_t window,
                 int64_t kv_len, void* stream) {
  return run(true, q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads,
             kv_heads, sq, skv, d, dv_width, strides, scale, softcap, causal,
             window, kv_len, stream);
}

int flash_bwd_dkdv(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* delta, float* dq, float* dk, float* dv,
                   int64_t batch, int heads, int kv_heads, int64_t sq,
                   int64_t skv, int d, int dv_width, const int64_t* strides,
                   float scale, float softcap, int causal, int64_t window,
                   int64_t kv_len, void* stream) {
  return run(false, q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads,
             kv_heads, sq, skv, d, dv_width, strides, scale, softcap, causal,
             window, kv_len, stream);
}

}  // extern "C"
