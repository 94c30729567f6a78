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
// gathered d-wide f32 table row (4*d bytes), 0.5 flop/byte; the table of the
// stacked partitions (hundreds of MB) does not fit in the 50 MB L2, so the
// gathers stream from HBM. The least traffic is one read of the table, the
// CSR and one write of the output; the gathers as written here move
// nnz * d * 4 bytes, with reuse only where L2 happens to hold a row.
// Design, kept simple and deterministic:
//   * one warp per destination row; lane l owns columns l, l+32, ... of a
//     column chunk of up to 32*kMaxVec, so every gathered table row is read
//     as coalesced 128-byte lines and the sums live in registers;
//   * the neighbor loop is unrolled so several rows' loads are in flight at
//     once (the loads are independent; only the adds are ordered);
//   * neighbors are visited in CSR order and each sum is acc = acc + w*t with
//     separately rounded multiply and add: no atomics, the same bits on
//     every run (the serving engine's delta-refresh == full-sweep guarantee
//     rests on it) and the same arithmetic as the plain PyTorch version
//     (repro_torch/kernels/spmm/ref.py), bit for bit;
//   * one write per output value.
// Known imbalance: a hub row's whole neighbor list runs on one warp (the
// first thing a faster version should split). The kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxVec = 24;  // columns per lane per chunk: chunks of 768

template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const float* __restrict__ table, const int* __restrict__ row_ptr,
                const int* __restrict__ col, const float* __restrict__ w,
                float* __restrict__ out, int64_t n_rows, int d, int c_begin) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  const int cb = c_begin + lane;
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const float we = __ldg(w + e);
    const float* tr = table + (int64_t)__ldg(col + e) * d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = cb + 32 * v;
      if (c < d) acc[v] = __fadd_rn(acc[v], __fmul_rn(we, __ldg(tr + c)));
    }
  }
  float* orow = out + row * d;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = cb + 32 * v;
    if (c < d) orow[c] = acc[v];
  }
}

template <int NV>
void launch_chunk(const float* table, const int* row_ptr, const int* col,
                  const float* w, float* out, int64_t n_rows, int d,
                  int c_begin, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_csr_kernel<NV><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, row_ptr, col, w, out, n_rows, d, c_begin);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// table: (n_src, d) float32 row-major; row_ptr: (n_rows+1,) int32;
// col: (nnz,) int32 in [0, n_src); w: (nnz,) float32; out: (n_rows, d) float32.
int spmm_csr(const float* table, const int* row_ptr, const int* col,
             const float* w, float* out, int64_t n_rows, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < d; c0 += 32 * kMaxVec) {
    const int cols = d - c0 < 32 * kMaxVec ? d - c0 : 32 * kMaxVec;
    const int nv = (cols + 31) / 32;
    if (nv <= 1) launch_chunk<1>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 2) launch_chunk<2>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 4) launch_chunk<4>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 8) launch_chunk<8>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 12) launch_chunk<12>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 16) launch_chunk<16>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else if (nv <= 20) launch_chunk<20>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    else launch_chunk<kMaxVec>(table, row_ptr, col, w, out, n_rows, d, c0, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
