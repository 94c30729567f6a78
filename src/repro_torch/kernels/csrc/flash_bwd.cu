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
// 172 GFLOP a layer against 0.2 GB of inputs and outputs. This first design
// runs them as scalar float32 FMAs from shared-memory tiles (the CUDA
// cores' 67 TFLOP/s at most), and recomputes S and dP in both kernels (7
// products, not 5); the forward's 3xTF32 mma.sync fragments, wgmma and TMA
// are later work.
//
// Design: two kernels, launched one after the other on the same stream,
// deterministic and without atomics.
//   * flash_bwd_dq: grid (query tiles, batch * heads). A block of 256
//     threads owns BQ query rows of one head. Its prologue computes Delta
//     for its rows and writes it to a (batch * heads, Sq) buffer; then it
//     loops over the KV tiles its rows see (the forward's skip of tiles
//     above the causal diagonal, below every row's window or past kv_len),
//     recomputes S and dP, forms dS in shared memory and accumulates dQ in
//     registers.
//   * flash_bwd_dkdv: grid (key tiles, batch * kv_heads). A block owns BK
//     keys of one KV head, keeps K and V in shared memory and loops, in a
//     fixed order, over the H / Hkv query heads of its KV head and the query
//     tiles that see its keys; it reads Delta and lse, recomputes S and dP,
//     and accumulates dV = P^T dO and dK = dS^T Q in registers. GQA's sum
//     happens inside the block: no second pass, no atomics, the same bits
//     on every run.
//   * threads form a 16 x 16 grid; a thread owns the rows ty + 16 i and the
//     columns tx + 16 j of each product, so a warp reads two rows of one
//     operand (broadcast) and 16 neighbouring words or 16 rows of the other.
//     Tiles are row-major with an odd pitch (width + 1 floats): the 16 rows
//     a warp reads at one column fall in 16 banks.
//   * q is scaled by `scale` as it is loaded (the forward's scores, and
//     dK = dS^T (scale q) needs no further product); a masked score's P is
//     exactly 0, so it adds nothing, and a row that sees no key (lse =
//     -inf, O = 0) gets dQ = 0 and adds nothing to dK or dV.
//   * the softcap is a template flag (CAP), as in the forward; widths are
//     padded to multiples of 16 (zeros), v to a width of its own only for
//     MLA's 192 / 128.
// The kernels allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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
  float scale;
  float softcap;  // <= 0: none
};

__device__ __forceinline__ bool visible(const BwdParams& p, int64_t qp,
                                        int64_t kp) {
  return qp < p.sq && kp < p.kv_end && (!p.causal || kp <= qp) &&
         (p.window <= 0 || qp - kp < p.window);
}

// Rows [row0, row0 + ROWS) of a (seq, width) slice with row stride `rs`,
// times `mul`, into a tile with row pitch LD and W columns; rows past
// `valid` and columns past `width` are 0.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          int64_t rs, int64_t row0,
                                          int64_t valid, int width,
                                          float mul) {
  for (int idx = threadIdx.x; idx < ROWS * W; idx += kThreads) {
    const int r = idx / W;
    const int c = idx - r * W;
    const int64_t row = row0 + r;
    tile[r * LD + c] =
        (row < valid && c < width) ? base[row * rs + c] * mul : 0.f;
  }
}

// Given the uncapped score s (natural units) and the row's lse, delta and
// dP: the score's dS, and P through `pr`.
template <bool CAP>
__device__ __forceinline__ float score_grad(float s, float lse, float dp,
                                            float delta, float cap,
                                            float inv_cap, bool seen,
                                            float& pr) {
  float deriv = 1.f;
  if constexpr (CAP) {
    const float t = tanhf(s * inv_cap);
    s = cap * t;
    deriv = 1.f - t * t;
  }
  pr = seen ? expf(s - lse) : 0.f;
  return pr * (dp - delta) * deriv;
}

template <int DP, int DVP, int BQ, int BK>
struct DqCfg {
  static constexpr int LDQ = DP + 1, LDV = DVP + 1, LDS = BK + 1;
  static constexpr size_t kSmem =
      (size_t)(BQ * LDQ + BQ * LDV + BK * LDQ + BK * LDV + BQ * LDS +
               2 * BQ) * sizeof(float);
  static_assert(kSmem <= 227 * 1024, "tiles exceed the shared memory");
  static_assert(DP % 16 == 0 && DVP % 16 == 0 && BQ % 16 == 0 &&
                BK % 16 == 0 && DVP <= DP, "tile widths");
};

template <int DP, int DVP, int BQ, int BK, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  using C = DqCfg<DP, DVP, BQ, BK>;
  constexpr int LDQ = C::LDQ, LDV = C::LDV, LDS = C::LDS;
  constexpr int RI = BQ / 16, CK = BK / 16, CD = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x LDQ, q * scale
  float* sdO = sQ + BQ * LDQ;    // BQ x LDV
  float* sK = sdO + BQ * LDV;    // BK x LDQ
  float* sV = sK + BK * LDQ;     // BK x LDV
  float* sdS = sV + BK * LDV;    // BQ x LDS
  float* sLse = sdS + BQ * LDS;  // BQ
  float* sDelta = sLse + BQ;     // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t qt = (int64_t)gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int hk = h / p.group;
  const int64_t q_lo = qt * BQ;
  const int64_t q_last = (q_lo + BQ < p.sq ? q_lo + BQ : p.sq) - 1;

  const float* qb = p.q + b * p.q_s[0] + h * p.q_s[2];
  const float* kb = p.k + b * p.k_s[0] + hk * p.k_s[2];
  const float* vb = p.v + b * p.v_s[0] + hk * p.v_s[2];
  const float* ob = p.o + b * p.o_s[0] + h * p.o_s[2];
  const float* dob = p.dout + b * p.do_s[0] + h * p.do_s[2];

  load_tile<BQ, DP, LDQ>(sQ, qb, p.q_s[1], q_lo, p.sq, p.d, p.scale);
  load_tile<BQ, DVP, LDV>(sdO, dob, p.do_s[1], q_lo, p.sq, p.dv, 1.f);
  // Delta = rowsum(dO * O), one warp a row; written for flash_bwd_dkdv
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int64_t row = q_lo + r;
    float sum = 0.f;
    if (row < p.sq)
      for (int c = lane; c < p.dv; c += 32)
        sum += dob[row * p.do_s[1] + c] * ob[row * p.o_s[1] + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sDelta[r] = sum;
      sLse[r] = row < p.sq ? p.lse[(int64_t)bh * p.sq + row] : 0.f;
      if (row < p.sq) p.delta[(int64_t)bh * p.sq + row] = sum;
    }
  }

  // the key range any row of this block sees (the forward's)
  int64_t k_stop = p.kv_end;
  if (p.causal && q_last + 1 < k_stop) k_stop = q_last + 1;
  int64_t k_first = 0;
  if (p.window > 0 && q_lo - p.window + 1 > 0) k_first = q_lo - p.window + 1;
  const int64_t k_lo0 = k_first / BK * BK;

  float acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  const float cap = p.softcap, inv_cap = CAP ? 1.f / p.softcap : 0.f;

  for (int64_t k_lo = k_lo0; k_lo < k_stop; k_lo += BK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<BK, DP, LDQ>(sK, kb, p.k_s[1], k_lo, p.kv_end, p.d, 1.f);
    load_tile<BK, DVP, LDV>(sV, vb, p.v_s[1], k_lo, p.kv_end, p.dv, 1.f);
    __syncthreads();

    float s[RI][CK], dp[RI][CK];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float a[RI], bk[CK];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sQ[(ty + 16 * i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) bk[j] = sK[(tx + 16 * j) * LDQ + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll 4
    for (int c = 0; c < DVP; ++c) {
      float a[RI], bv[CK];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sdO[(ty + 16 * i) * LDV + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) bv[j] = sV[(tx + 16 * j) * LDV + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) dp[i][j] += a[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kc = tx + 16 * j;
        float pr;
        sdS[r * LDS + kc] = score_grad<CAP>(
            s[i][j], sLse[r], dp[i][j], sDelta[r], cap, inv_cap,
            visible(p, q_lo + r, k_lo + kc), pr);
      }
    }
    __syncthreads();

    // dQ += dS K (the scale is applied once at the end)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[RI], bk[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sdS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) bk[j] = sK[kk * LDQ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] += a[i] * bk[j];
    }
  }

  float* dqb = p.grad_q + b * p.dq_s[0] + h * p.dq_s[2];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int64_t row = q_lo + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) dqb[row * p.dq_s[1] + col] = acc[i][j] * p.scale;
    }
  }
}

template <int DP, int DVP, int BQ, int BK>
struct DkvCfg {
  static constexpr int LDQ = DP + 1, LDV = DVP + 1, LDS = BK + 1;
  static constexpr size_t kSmem =
      (size_t)(BK * LDQ + BK * LDV + BQ * LDQ + BQ * LDV + BQ * LDS +
               2 * BQ) * sizeof(float);
  static_assert(kSmem <= 227 * 1024, "tiles exceed the shared memory");
  static_assert(DP % 16 == 0 && DVP % 16 == 0 && BQ % 16 == 0 &&
                BK % 16 == 0 && DVP <= DP, "tile widths");
};

template <int DP, int DVP, int BQ, int BK, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using C = DkvCfg<DP, DVP, BQ, BK>;
  constexpr int LDQ = C::LDQ, LDV = C::LDV, LDS = C::LDS;
  constexpr int RQ = BQ / 16, CK = BK / 16;  // score micro-tile
  constexpr int RK = BK / 16, CD = DP / 16, CV = DVP / 16;
  extern __shared__ float smem[];
  float* sK = smem;              // BK x LDQ
  float* sV = sK + BK * LDQ;     // BK x LDV
  float* sQ = sV + BK * LDV;     // BQ x LDQ, q * scale
  float* sdO = sQ + BQ * LDQ;    // BQ x LDV
  float* sP = sdO + BQ * LDV;    // BQ x LDS: P, then dS
  float* sLse = sP + BQ * LDS;   // BQ
  float* sDelta = sLse + BQ;     // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t k_lo = (int64_t)blockIdx.x * BK;  // heaviest (causal) first
  const int bhk = blockIdx.y;
  const int b = bhk / p.kv_heads;
  const int hk = bhk - b * p.kv_heads;

  const float* kb = p.k + b * p.k_s[0] + hk * p.k_s[2];
  const float* vb = p.v + b * p.v_s[0] + hk * p.v_s[2];
  load_tile<BK, DP, LDQ>(sK, kb, p.k_s[1], k_lo, p.kv_end, p.d, 1.f);
  load_tile<BK, DVP, LDV>(sV, vb, p.v_s[1], k_lo, p.kv_end, p.dv, 1.f);

  float acc_k[RK][CD], acc_v[RK][CV];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) acc_v[i][j] = 0.f;
  }
  const float cap = p.softcap, inv_cap = CAP ? 1.f / p.softcap : 0.f;

  // the query rows that see any key of this block
  const int64_t k_hi = k_lo + BK < p.kv_end ? k_lo + BK : p.kv_end;
  const int64_t q_first = p.causal ? k_lo : 0;
  int64_t q_stop = p.sq;
  if (p.window > 0 && k_hi - 1 + p.window < q_stop)
    q_stop = k_hi - 1 + p.window;
  const int64_t q_lo0 = k_lo < k_hi ? q_first / BQ * BQ : q_stop;

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const int64_t bh = (int64_t)b * p.heads + h;
    const float* qb = p.q + b * p.q_s[0] + h * p.q_s[2];
    const float* dob = p.dout + b * p.do_s[0] + h * p.do_s[2];
    for (int64_t q_lo = q_lo0; q_lo < q_stop; q_lo += BQ) {
      __syncthreads();  // the previous tile's reads are done
      load_tile<BQ, DP, LDQ>(sQ, qb, p.q_s[1], q_lo, p.sq, p.d, p.scale);
      load_tile<BQ, DVP, LDV>(sdO, dob, p.do_s[1], q_lo, p.sq, p.dv, 1.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q_lo + r < p.sq;
        sLse[r] = in ? p.lse[bh * p.sq + q_lo + r] : 0.f;
        sDelta[r] = in ? p.delta[bh * p.sq + q_lo + r] : 0.f;
      }
      __syncthreads();

      // S and dP: rows q (ty + 16 i), columns key (tx + 16 j)
      float s[RQ][CK], dp[RQ][CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float a[RQ], bk[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty + 16 * i) * LDQ + c];
#pragma unroll
        for (int j = 0; j < CK; ++j) bk[j] = sK[(tx + 16 * j) * LDQ + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) s[i][j] += a[i] * bk[j];
      }
#pragma unroll 4
      for (int c = 0; c < DVP; ++c) {
        float a[RQ], bv[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = sdO[(ty + 16 * i) * LDV + c];
#pragma unroll
        for (int j = 0; j < CK; ++j) bv[j] = sV[(tx + 16 * j) * LDV + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) dp[i][j] += a[i] * bv[j];
      }
      float ds[RQ][CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int kc = tx + 16 * j;
          float pr;
          ds[i][j] = score_grad<CAP>(s[i][j], sLse[r], dp[i][j], sDelta[r],
                                     cap, inv_cap,
                                     visible(p, q_lo + r, k_lo + kc), pr);
          sP[r * LDS + kc] = pr;
        }
      }
      __syncthreads();

      // dV += P^T dO: rows key (ty + 16 i), columns (tx + 16 j)
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float a[RK], bo[CV];
#pragma unroll
        for (int i = 0; i < RK; ++i) a[i] = sP[qq * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CV; ++j) bo[j] = sdO[qq * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CV; ++j) acc_v[i][j] += a[i] * bo[j];
      }
      __syncthreads();  // P's reads are done before dS takes its place
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j)
          sP[(ty + 16 * i) * LDS + tx + 16 * j] = ds[i][j];
      __syncthreads();

      // dK += dS^T (scale q)
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float a[RK], bq[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) a[i] = sP[qq * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CD; ++j) bq[j] = sQ[qq * LDQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) acc_k[i][j] += a[i] * bq[j];
      }
    }
  }

  float* dkb = p.grad_k + b * p.dk_s[0] + hk * p.dk_s[2];
  float* dvb = p.grad_v + b * p.dv_s[0] + hk * p.dv_s[2];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int64_t key = k_lo + ty + 16 * i;
    if (key >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) dkb[key * p.dk_s[1] + col] = acc_k[i][j];
    }
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int col = tx + 16 * j;
      if (col < p.dv) dvb[key * p.dv_s[1] + col] = acc_v[i][j];
    }
  }
}

template <int DP, int DVP, int BQ, int BK, bool CAP>
cudaError_t launch_dq(const BwdParams& p, int64_t batch, cudaStream_t s) {
  constexpr size_t smem = DqCfg<DP, DVP, BQ, BK>::kSmem;
  auto* kernel = flash_bwd_dq_kernel<DP, DVP, BQ, BK, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + BQ - 1) / BQ),
                  (unsigned)(batch * p.heads));
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DP, int DVP, int BQ, int BK, bool CAP>
cudaError_t launch_dkdv(const BwdParams& p, int64_t batch, cudaStream_t s) {
  constexpr size_t smem = DkvCfg<DP, DVP, BQ, BK>::kSmem;
  auto* kernel = flash_bwd_dkdv_kernel<DP, DVP, BQ, BK, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.skv + BK - 1) / BK),
                  (unsigned)(batch * p.kv_heads));
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Tiles by head width (D padded to DP, v to DVP): dq holds BQ = 64 query
// rows and BK = 64 keys up to DP = 64, 32 keys above; dkdv holds BK = 64
// keys up to DP = 128 (32 above) and BQ = 64 query rows up to DP = 64 (32
// above), so that every instance stays within the shared memory and its
// accumulators within the registers. v gets a width of its own only at
// MLA's D 192 / Dv 128, without a softcap.
template <bool DQ, bool CAP>
cudaError_t dispatch(const BwdParams& p, int64_t batch, cudaStream_t s) {
#define REPRO_BWD(DP, DVP, QQ, QK, KQ, KK)                           \
  {                                                                  \
    if constexpr (DQ)                                                \
      return launch_dq<DP, DVP, QQ, QK, CAP>(p, batch, s);           \
    else                                                             \
      return launch_dkdv<DP, DVP, KQ, KK, CAP>(p, batch, s);         \
  }
  if (p.d <= 32) REPRO_BWD(32, 32, 64, 64, 64, 64)
  if (p.d <= 64) REPRO_BWD(64, 64, 64, 64, 64, 64)
  if (p.d <= 128) REPRO_BWD(128, 128, 64, 32, 32, 64)
  if (p.d <= 192) {
    if constexpr (!CAP) {
      if (p.dv <= 128) REPRO_BWD(192, 128, 64, 32, 32, 32)
    }
    REPRO_BWD(192, 192, 64, 32, 32, 32)
  }
  if (p.d <= 256) REPRO_BWD(256, 256, 64, 32, 32, 32)
#undef REPRO_BWD
  return cudaErrorInvalidValue;
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
