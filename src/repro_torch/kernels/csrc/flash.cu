// Flash-attention forward on Hopper: for each query row, an online softmax
// over the visible keys,
//   m = max_k s[k],  l = sum_k exp(s[k] - m),  acc = sum_k exp(s[k] - m) v[k],
// with s[k] = (scale * q) . k[k], or cap * tanh((scale * q) . k[k] / cap)
// under a logit softcap (gemma2), causal and sliding-window masks and a
// kv_len bound. q and k are D wide, v (and the output) Dv <= D wide (MLA:
// D = d_nope + d_rope = 192, Dv = 128). It writes either the raw
// (acc, m, l) or the normalised attention acc / max(l, 1e-30), as float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash/flash.py
// (_flash_kernel, :32, pallas_call :99, called through flash_fwd :76 and
// kernels/flash/ops.py::flash_attention). On the LM serving path it is every
// prefill layer's attention, the counterpart of
// src/repro/models/lm/model.py::blockwise_attention, which adds the softcap
// and the separate value width that the Pallas kernel lacks.
//
// What bounds it on an H100: operations. Per visible (query, key) pair it
// does 2*D flops for the score and 2*D for the value product; at the serving
// slice's shape (B*H = 256 heads, S = 2048, D = 64, causal) that is 137 GFLOP
// against 0.34 GB of q/k/v/out. The LM serves in float32, so both products
// run on the tensor cores as 3xTF32: each float32 operand x is split into
// big = tf32(x) and small = tf32(x - big), and small*big + big*small +
// big*big accumulate in float32 (m16n8k8 TF32 mma.sync), close to float32
// accuracy at three TF32 products per multiply-add.
//
// Design:
//   * grid (query tiles, batch*heads); a block of NW warps owns NW*16 query
//     rows, 16 per warp, and loops over BK-key tiles itself, in place of the
//     TPU's sequential grid axis. Blocks are independent: no atomics, no
//     second pass. Query tiles run heaviest-first (the last, longest causal
//     rows get the lowest block index).
//   * q is scaled once in float32 by scale * log2(e) (exp2 then gives
//     exp), zero-padded to DP (a multiple of 8) columns and kept in shared
//     memory. Under a softcap (a template flag, CAP, so that the uncapped
//     instances carry neither the branch nor its registers) q is scaled by
//     scale alone: the cap's tanh (tanhf, accurate: tanh.approx's ~2^-11
//     relative error would show in the LM's logits) takes the natural-unit
//     score, and cap * log2(e) multiplies its result. v is zero-padded to
//     DV columns of its own, so a narrower v costs neither shared memory nor
//     PV products. K/V tiles are double-buffered in shared memory: the tile
//     after the current one is copied with 16-byte cp.async (float32 inputs
//     whose rows are 16-byte aligned) or loaded and converted by the threads
//     (bf16 / f16 inputs, other strides) while the current one is computed.
//     Rows are padded to LD = 4 (mod 32) floats, so every fragment load of
//     a warp hits 32 distinct banks.
//   * the scores of a warp's 16 rows x BK keys live in mma accumulator
//     fragments (rows g, g+8; keys 2t, 2t+1 of each 8-key group, g = lane/4,
//     t = lane%4); the row max and sum reduce over the 4 lanes of a quad, as
//     FlashAttention-2 does. The probabilities feed the PV product straight
//     from those registers: the PV mma's reduction index k = t stands for
//     key 2t and k = t+4 for key 2t+1, and V's B fragment reads the same
//     keys, so no shuffle or shared-memory trip is needed.
//   * tiles wholly above the causal diagonal, wholly below every row's
//     window, or past kv_len are skipped (per block, and per warp for its
//     16 rows); inside a tile a masked score is -inf and contributes
//     exactly 0 (the running max starts at a finite -2e38, so a row that
//     sees no key keeps acc = 0, l = 0). Rows beyond Sq are never written.
//   * GQA without copies: query head h reads KV head h / (H / Hkv) through
//     strides, in the model's own (B, S, H, D) layout.
//   * inputs float32, bfloat16 or float16 (templated), math in float32.
// The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* m;  // may be null
  float* l;  // may be null
  // element strides: batch, sequence, head (the last dim is contiguous)
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t sq, kv_end;  // kv_end = min(skv, kv_len)
  int64_t window;      // <= 0: none
  int heads, group, d, dv, causal, normalize;
  int async_kv;        // K/V rows may be copied as 16-byte cp.async chunks
  float scale;
  float softcap;       // <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a * b, one m16n8k8 TF32 product with float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// c += a * b in 3xTF32: small*big + big*small + big*big, with a split once
// by the caller (it is shared by a row of products).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const float (&b)[2]) {
  uint32_t b_big[2], b_small[2];
  split_tf32(b, b_big, b_small);
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// Rows [row0, row0 + ROWS) of a (seq, d) slice with row stride `rs`, times
// `mul`, into a float32 tile with row stride LD and DP columns; rows past
// `valid` and columns past d are 0. Plain loads, converted by the threads.
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_rows(float* tile, const T* base,
                                          int64_t rs, int64_t row0,
                                          int64_t valid, int d, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
    const int r = idx / DP;  // DP is a power of two
    const int c = idx % DP;
    const int64_t row = row0 + r;
    tile[r * LD + c] =
        (row < valid && c < d) ? to_f32(base[row * rs + c]) * mul : 0.f;
  }
}

// The same for float32 rows that are 16-byte aligned, as cp.async copies:
// 16-byte chunks, zero-filled past `valid` and past d (d % 4 == 0).
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void copy_rows_async(float* tile, const float* base,
                                                int64_t rs, int64_t row0,
                                                int64_t valid, int d) {
  constexpr int kChunks = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int64_t row = row0 + r;
    const bool ok = row < valid && c < d;
    cp_async16(tile + r * LD + c, ok ? base + row * rs + c : base,
               ok ? 16 : 0);
  }
}

template <int DP, int DV, int NW, int BK>
struct Cfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int BQ = NW * 16;
  static constexpr int LD = (DP + 31) / 32 * 32 + 4;   // = 4 (mod 32)
  static constexpr int LDV = (DV + 31) / 32 * 32 + 4;  // = 4 (mod 32)
  static constexpr size_t kSmem =
      (size_t)((BQ + 2 * BK) * LD + 2 * BK * LDV) * sizeof(float);
  static constexpr int kMinBlocks = kSmem * 2 <= 227 * 1024 ? 2 : 1;
  static_assert(kSmem <= 227 * 1024, "tiles exceed the shared memory");
  static_assert(DV <= DP && DV % 8 == 0 && DP % 8 == 0, "head widths");
};

template <typename T, int DP, int DV, int NW, int BK, bool CAP>
__global__ void __launch_bounds__(Cfg<DP, DV, NW, BK>::kThreads,
                                  Cfg<DP, DV, NW, BK>::kMinBlocks)
flash_fwd_kernel(const Params p) {
  using C = Cfg<DP, DV, NW, BK>;
  constexpr int NT = C::kThreads;
  constexpr int BQ = C::BQ;
  constexpr int LD = C::LD;
  constexpr int LDV = C::LDV;
  constexpr int KS = DP / 8;  // k-steps of the score product
  constexpr int NKT = BK / 8; // 8-key groups of a tile
  constexpr int NDT = DV / 8; // 8-column groups of the output
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;       // 2 buffers
  float* sV = sK + 2 * BK * LD;   // 2 buffers of LDV-float rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t qt = (int64_t)gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int hk = h / p.group;
  const int64_t q_lo = qt * BQ;
  const int64_t q_last = (q_lo + BQ < p.sq ? q_lo + BQ : p.sq) - 1;
  const int64_t wq_lo = q_lo + warp * 16;  // this warp's first row

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // q in float32, times scale (as the Pallas kernel does), times log2(e)
  // unless the softcap's tanh needs the score in natural units first
  load_rows<T, BQ, DP, LD, NT>(sQ, qb, p.q_ss, q_lo, p.sq, p.d,
                               CAP ? p.scale : p.scale * kLog2e);

  // the key range any row of this block can see
  int64_t k_stop = p.kv_end;
  if (p.causal && q_last + 1 < k_stop) k_stop = q_last + 1;
  int64_t k_first = 0;
  if (p.window > 0 && q_lo - p.window + 1 > 0) k_first = q_lo - p.window + 1;
  const int64_t k_lo0 = k_first / BK * BK;
  const int n_tiles = k_lo0 < k_stop ? (int)((k_stop - k_lo0 + BK - 1) / BK) : 0;

  auto load_kv = [&](int buf, int64_t k_lo) {
    float* k_dst = sK + buf * BK * LD;
    float* v_dst = sV + buf * BK * LDV;
    if constexpr (sizeof(T) == 4) {
      if (p.async_kv) {
        copy_rows_async<BK, DP, LD, NT>(k_dst, reinterpret_cast<const float*>(kb),
                                        p.k_ss, k_lo, p.kv_end, p.d);
        copy_rows_async<BK, DV, LDV, NT>(v_dst,
                                         reinterpret_cast<const float*>(vb),
                                         p.v_ss, k_lo, p.kv_end, p.dv);
        return;
      }
    }
    load_rows<T, BK, DP, LD, NT>(k_dst, kb, p.k_ss, k_lo, p.kv_end, p.d, 1.f);
    load_rows<T, BK, DV, LDV, NT>(v_dst, vb, p.v_ss, k_lo, p.kv_end, p.dv,
                                  1.f);
  };

  float o[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // log2 units
  float l_run[2] = {0.f, 0.f};    // this lane's part of the row sums

  if (n_tiles > 0) load_kv(0, k_lo0);
  cp_async_commit();
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

      // scores: (16 rows) x (BK keys), s[j] holds keys 8j + 2t, 8j + 2t + 1
      float s[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float* qa = sQ + (warp * 16 + g) * LD + ks * 8 + t;
        const float a[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
        uint32_t a_big[4], a_small[4];
        split_tf32(a, a_big, a_small);
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          const float* kr = Kt + (j * 8 + g) * LD + ks * 8 + t;
          const float bk[2] = {kr[0], kr[4]};
          mma_3xtf32(s[j], a_big, a_small, bk);
        }
      }
      if constexpr (CAP) {  // cap * tanh(score / cap), in log2 units
        const float cap_log2e = p.softcap * kLog2e;
        const float inv_cap = 1.f / p.softcap;
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = cap_log2e * tanhf(s[j][e] * inv_cap);
      }

      // masks, where some score of this warp's rows is not visible
      const bool full =
          k_lo + BK <= p.kv_end && (!p.causal || k_lo + BK - 1 <= wq_lo) &&
          (p.window <= 0 || wq_lo + 15 - k_lo < p.window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t qp = wq_lo + g + (e >> 1) * 8;
            const int64_t kp = k_lo + j * 8 + 2 * t + (e & 1);
            const bool ok = kp < p.kv_end && (!p.causal || kp <= qp) &&
                            (p.window <= 0 || qp - kp < p.window);
            if (!ok) s[j][e] = -INFINITY;
          }
      }

      // online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NKT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[rr], mx);  // finite
        const float corr = exp2f(m_run[rr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            s[j][e] = exp2f(s[j][e] - m_new);  // -inf -> 0
            sum += s[j][e];
          }
        l_run[rr] = l_run[rr] * corr + sum;
        m_run[rr] = m_new;
#pragma unroll
        for (int j = 0; j < NDT; ++j) {
          o[j][2 * rr] *= corr;
          o[j][2 * rr + 1] *= corr;
        }
      }

      // o += P V. The A fragment's k = t is key 2t of the group and k = t+4
      // is key 2t+1, which is how s[] holds them; V's B fragment reads the
      // same keys.
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t a_big[4], a_small[4];
        split_tf32(a, a_big, a_small);
        const float* vr = Vt + (kk * 8 + 2 * t) * LDV + g;
#pragma unroll
        for (int j = 0; j < NDT; ++j) {
          const float bv[2] = {vr[j * 8], vr[LDV + j * 8]};
          mma_3xtf32(o[j], a_big, a_small, bv);
        }
      }
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int64_t qp = wq_lo + g + rr * 8;
    if (qp >= p.sq) continue;
    float* orow = p.out + b * p.o_sb + qp * p.o_ss + h * p.o_sh;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NDT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const float x = o[j][2 * rr + e];
        if (col < p.dv) orow[col] = p.normalize ? __fdiv_rn(x, den) : x;
      }
    if (t == 0 && p.m != nullptr) {
      p.m[(int64_t)bh * p.sq + qp] =
          m_run[rr] == kNeg ? kNeg : m_run[rr] * kLn2;
      p.l[(int64_t)bh * p.sq + qp] = l;
    }
  }
}

template <typename T, int DP, int DV, int NW, int BK, bool CAP>
cudaError_t launch(const Params& p, int64_t batch, cudaStream_t stream) {
  using C = Cfg<DP, DV, NW, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, DV, NW, BK, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + C::BQ - 1) / C::BQ),
                  (unsigned)(batch * p.heads));
  flash_fwd_kernel<T, DP, DV, NW, BK, CAP>
      <<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// DV: v's width padded to the template's. A narrower v gets tiles of its
// own width only where a served model has one, in float32 (the LM's serving
// dtype) without a softcap: MLA's DP 192 / DV 128, and DP 32 / DV 16 of its
// reduced config (DVN > 0). Any other v is padded to DP inside the tiles.
template <typename T, int DP, int DVN, int NW, int BK, bool CAP>
cudaError_t dispatch_dv(const Params& p, int64_t batch, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4 && DVN > 0 && !CAP)
    if (p.dv <= DVN) return launch<T, DP, DVN, NW, BK, false>(p, batch, stream);
  return launch<T, DP, DP, NW, BK, CAP>(p, batch, stream);
}

// DP: the head width padded to the template's; blocks of 8 warps (128 query
// rows) and 64-key tiles up to DP = 64, 32-key tiles at DP = 128 and 192
// (half the score registers, the faster of the two on an H100 at 128), and
// 4 warps with 32-key tiles at DP = 256 to stay in shared memory.
template <typename T, bool CAP>
cudaError_t dispatch_d(const Params& p, int64_t batch, cudaStream_t stream) {
  if (p.d <= 16) return dispatch_dv<T, 16, 0, 8, 64, CAP>(p, batch, stream);
  if (p.d <= 32) return dispatch_dv<T, 32, 16, 8, 64, CAP>(p, batch, stream);
  if (p.d <= 64) return dispatch_dv<T, 64, 0, 8, 64, CAP>(p, batch, stream);
  if (p.d <= 128) return dispatch_dv<T, 128, 0, 8, 32, CAP>(p, batch, stream);
  if (p.d <= 192)
    return dispatch_dv<T, 192, 128, 8, 32, CAP>(p, batch, stream);
  if (p.d <= 256) return dispatch_dv<T, 256, 0, 4, 32, CAP>(p, batch, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr, const int64_t* strides, int d) {
  if ((uintptr_t)ptr % 16 != 0 || d % 4 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, sq, heads, d), k: (batch, skv, kv_heads, d), v: (batch, skv,
// kv_heads, dv), each with element strides {batch, seq, head} in
// `strides[0..8]` (q, k, v) and a contiguous last dim; out: float32
// (batch, sq, heads, dv) with strides `strides[9..11]`; m/l: float32
// (batch*heads, sq) or null. dtype: 0 float32, 1 bfloat16, 2 float16.
// window <= 0 and softcap <= 0 mean none; causal and normalize are 0 or 1.
int flash_fwd(const void* q, const void* k, const void* v, float* out,
              float* m, float* l, int dtype, int64_t batch, int heads,
              int kv_heads, int64_t sq, int64_t skv, int d, int dv,
              const int64_t* strides, float scale, float softcap, int causal,
              int64_t window, int64_t kv_len, int normalize, void* stream) {
  if (d < 1 || d > 256 || dv < 1 || dv > d || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.m = m; p.l = l;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = sq;
  p.kv_end = kv_len < skv ? kv_len : skv;
  p.window = window;
  p.heads = heads; p.group = heads / kv_heads; p.d = d; p.dv = dv;
  p.causal = causal; p.normalize = normalize; p.scale = scale;
  p.softcap = softcap;
  p.async_kv = dtype == 0 && aligned16(k, strides + 3, d) &&
               aligned16(v, strides + 6, dv);
  if (sq == 0 || batch == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  // softcapped instances exist in float32 only: the wrapper widens bf16 /
  // f16 inputs under a softcap (the kernel computes in float32 anyway)
  if (dtype == 0 && softcap > 0.f) err = dispatch_d<float, true>(p, batch, s);
  else if (softcap > 0.f) err = cudaErrorInvalidValue;
  else if (dtype == 0) err = dispatch_d<float, false>(p, batch, s);
  else if (dtype == 1) err = dispatch_d<__nv_bfloat16, false>(p, batch, s);
  else if (dtype == 2) err = dispatch_d<__half, false>(p, batch, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
