// Flash-attention forward on Hopper: for each query row, an online softmax
// over the visible keys,
//   m = max_k s[k],  l = sum_k exp(s[k] - m),  acc = sum_k exp(s[k] - m) v[k],
// with s[k] = (scale * q) . k[k], causal and sliding-window masks and a
// kv_len bound. It writes either the raw (acc, m, l) or the normalised
// attention acc / max(l, 1e-30), as float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash/flash.py
// (_flash_kernel, :32, pallas_call :99, called through flash_fwd :76 and
// kernels/flash/ops.py::flash_attention). On the LM serving path it is every
// prefill layer's attention, the counterpart of
// src/repro/models/lm/model.py::blockwise_attention.
//
// What bounds it on an H100: operations. Per visible (query, key) pair it
// does 2*D flops for the score and 2*D for the value product; at the serving
// slice's shape (B*H = 256 heads, S = 2048, D = 64, causal) that is 137 GFLOP
// against 0.34 GB of q/k/v/out, far above the 20 flop/byte where float32 on
// the CUDA cores (67 TFLOP/s) stops being the limit. Tensor cores, TMA and
// wgmma are left for a later version; this one is simple and right.
//
// Design:
//   * grid (query tiles, batch*heads); one block of 256 threads owns a
//     64-row query tile and loops over 64-key tiles itself, in place of the
//     TPU's sequential grid axis. Blocks are independent: no atomics, no
//     second pass. Query tiles run heaviest-first (the last, longest causal
//     rows get the lowest block index).
//   * q (scaled in float32, as the Pallas kernel does), the K/V tile and the
//     probability tile live in shared memory as float32, rows padded to an
//     odd stride so the 16 threads that read 16 different rows hit 16 banks.
//     Thread (ty, tx) of a 16x16 grid keeps scores for rows ty+16i and keys
//     tx+16j (i, j < 4) and the output columns tx+16c of the same rows, so
//     the running max, sum and accumulator stay in its registers; row max
//     and row sum are reduced over the 16 tx lanes of a half-warp.
//   * tiles wholly above the causal diagonal, wholly below every row's
//     window, or past kv_len are skipped; inside a tile a masked score
//     contributes exactly 0 (so a window smaller than a tile cannot leave
//     exp(NEG - NEG) = 1 terms behind). For every row that sees a key this
//     is the Pallas kernel's result; rows beyond Sq are never written.
//   * GQA without copies: query head h reads KV head h / (H / Hkv) through
//     strides, in the model's own (B, S, H, D) layout.
//   * inputs float32, bfloat16 or float16 (templated), math in float32;
//     expf (never __expf), IEEE division; dot products use explicit fmaf.
//     The library builds with -fmad=false and without fast math.
// The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 1;   // row stride of the probability tile
constexpr float kNeg = -2.0e38f;

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
  int heads, group, d, causal, normalize;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 64 rows [row0, row0 + 64) of a (seq, d) slice with row stride `rs`, times
// `mul`, into a float32 tile with row stride `ts`; rows past `valid` are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          int64_t rs, int64_t row0,
                                          int64_t valid, int d, int ts,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int64_t row = row0 + r;
    tile[r * ts + c] =
        row < valid ? __fmul_rn(to_f32(base[row * rs + c]), mul) : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int NC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  const int d = p.d;
  const int ds = d | 1;  // odd row stride
  float* sQ = smem;
  float* sK = sQ + kBQ * ds;
  float* sV = sK + kBK * ds;
  float* sP = sV + kBK * ds;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t qt = (int64_t)gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int hk = h / p.group;
  const int64_t q_lo = qt * kBQ;
  const int64_t q_last = (q_lo + kBQ < p.sq ? q_lo + kBQ : p.sq) - 1;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile(sQ, qb, p.q_ss, q_lo, p.sq, d, ds, p.scale);

  // the key range any row of this tile can see
  int64_t k_stop = p.kv_end;
  if (p.causal && q_last + 1 < k_stop) k_stop = q_last + 1;
  int64_t k_first = 0;
  if (p.window > 0 && q_lo - p.window + 1 > 0) k_first = q_lo - p.window + 1;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t k_lo = k_first / kBK * kBK; k_lo < k_stop; k_lo += kBK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    load_tile(sK, kb, p.k_ss, k_lo, p.kv_end, d, ds, 1.f);
    load_tile(sV, vb, p.v_ss, k_lo, p.kv_end, d, ds, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ds + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q_lo + ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k_lo + tx + 16 * j;
        ok[j] = kp < p.kv_end && (!p.causal || kp <= qp) &&
                (p.window <= 0 || qp - kp < p.window);
        s[i][j] = ok[j] ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * kPS + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
      m[i] = m_new;
    }
    __syncthreads();

    const int nk = k_stop - k_lo < kBK ? (int)(k_stop - k_lo) : kBK;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? sV[kk * ds + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q_lo + ty + 16 * i;
    if (qp >= p.sq) continue;
    float* orow = p.out + b * p.o_sb + qp * p.o_ss + h * p.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = p.normalize ? __fdiv_rn(acc[i][c], den) : acc[i][c];
    }
    if (tx == 0 && p.m != nullptr) {
      p.m[(int64_t)bh * p.sq + qp] = m[i];
      p.l[(int64_t)bh * p.sq + qp] = l[i];
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, int64_t batch, cudaStream_t stream) {
  const int ds = p.d | 1;
  const size_t smem = ((size_t)(kBQ + 2 * kBK) * ds + (size_t)kBQ * kPS) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + kBQ - 1) / kBQ),
                  (unsigned)(batch * p.heads));
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int64_t batch, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16>(p, batch, stream);
  if (p.d <= 32) return launch<T, 32>(p, batch, stream);
  if (p.d <= 64) return launch<T, 64>(p, batch, stream);
  if (p.d <= 128) return launch<T, 128>(p, batch, stream);
  if (p.d <= 256) return launch<T, 256>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q: (batch, sq, heads, d), k/v: (batch, skv, kv_heads, d), each with element
// strides {batch, seq, head} in `strides[0..8]` (q, k, v) and a contiguous
// last dim; out: float32 with strides `strides[9..11]`; m/l: float32
// (batch*heads, sq) or null. dtype: 0 float32, 1 bfloat16, 2 float16.
// window <= 0 means none; causal and normalize are 0 or 1.
int flash_fwd(const void* q, const void* k, const void* v, float* out,
              float* m, float* l, int dtype, int64_t batch, int heads,
              int kv_heads, int64_t sq, int64_t skv, int d,
              const int64_t* strides, float scale, int causal, int64_t window,
              int64_t kv_len, int normalize, void* stream) {
  if (d < 1 || d > 256 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0)
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
  p.heads = heads; p.group = heads / kv_heads; p.d = d;
  p.causal = causal; p.normalize = normalize; p.scale = scale;
  if (sq == 0 || batch == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) err = dispatch_d<float>(p, batch, s);
  else if (dtype == 1) err = dispatch_d<__nv_bfloat16>(p, batch, s);
  else if (dtype == 2) err = dispatch_d<__half>(p, batch, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
