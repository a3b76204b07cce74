// BSR (block-ELL) sparse matrix-vector product for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package computes a BsrMatrix
// product as plain jnp, osqp_tpu/ops/spmv.py:297 (_bsr_matvec), which XLA
// fuses on the TPU: pad v to nbc * 128, gather one 128-wide segment of it
// per block, and contract
//     y[8 b + r] = sum_{k<Kb} sum_{c<128} blocks[b, k, r, c] * v[128 bcols[b, k] + c]
// for the rows below m.  In eager PyTorch that is a pad, a gather and a
// batched product; this kernel is one launch.  Its plain PyTorch version is
// osqp_tpu_torch/ops/bsr_matvec.py::bsr_matvec_plain.  Padding blocks are
// zero blocks at block-column 0 and are not skipped, as in the plain version.
//
// What bounds it: bytes.  The dense (8, 128) blocks dominate: the product
// needs the nb stored blocks that are not padding, nb 1024 sizeof(T) bytes,
// nb 4 of block-columns, and v and y once, over 3.35 TB/s.  The kernel
// reads all nbr Kb blocks, pads included, so where block-rows hold fewer
// than Kb blocks it moves more than the product needs.
//
// Design: one warp per block-row.  Lane l owns columns 4l .. 4l + 3 of every
// block: per block it loads those four entries of the v segment (one 16-byte
// load in f32, two in f64, where the segment lies inside v and v is 16-byte
// aligned; else four guarded scalar loads, so v is never padded on the
// device), then the same four columns of each of the 8 block rows (16 bytes
// per row in f32, 32 in f64: a warp reads each 512- or 1024-byte block row
// in one coalesced sweep), and keeps 8 row sums.  After the Kb blocks each
// row sum is reduced over the warp by shuffles, and lanes 0..7 write the
// rows that lie below m.  Indices are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 8;
constexpr int kC = 128;

template <typename T>
struct Vec4 {
  T x, y, z, w;
};

__device__ __forceinline__ Vec4<float> load4(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {a.x, a.y, a.z, a.w};
}

__device__ __forceinline__ Vec4<double> load4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_matvec_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                  const T* __restrict__ v, T* __restrict__ y, long long nbr, int Kb,
                  long long n, long long m, int v_aligned) {
  const int lane = threadIdx.x & 31;
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= nbr) return;  // b is the same for the whole warp
  T acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = T(0);
  for (int k = 0; k < Kb; ++k) {
    const long long c = (long long)__ldg(bcols + b * Kb + k) * kC + 4 * lane;
    Vec4<T> x;
    if (v_aligned && c + 4 <= n) {
      x = load4(v + c);
    } else {
      x.x = c < n ? __ldg(v + c) : T(0);
      x.y = c + 1 < n ? __ldg(v + c + 1) : T(0);
      x.z = c + 2 < n ? __ldg(v + c + 2) : T(0);
      x.w = c + 3 < n ? __ldg(v + c + 3) : T(0);
    }
    const T* blk = blocks + (b * Kb + k) * (kR * kC) + 4 * lane;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const Vec4<T> a = load4(blk + r * kC);
      acc[r] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
    }
  }
  T out = T(0);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    T s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == r) out = s;
  }
  const long long row = b * kR + lane;
  if (lane < kR && row < m) y[row] = out;
}

template <typename T>
int launch(const void* blocks, const void* bcols, const void* v, void* y, long long nbr,
           int Kb, long long n, long long m, int v_aligned, void* stream) {
  if (nbr < 1 || Kb < 1 || n < 1 || m < 1 || m > nbr * kR) return (int)cudaErrorInvalidValue;
  const long long grid = (nbr * 32 + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bsr_matvec_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(bcols), static_cast<const T*>(v),
      static_cast<T*>(y), nbr, Kb, n, m, v_aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: blocks (nbr, Kb, 8, 128) contiguous and 16-byte aligned,
// bcols (nbr, Kb) int32 with every 128 bcols < n + 127, v (n,), y (m,) with
// m <= 8 nbr, all on the device; v_aligned says whether v is 16-byte
// aligned.  The launch goes on `stream`.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bsr_matvec_f32(const void* blocks, const void* bcols, const void* v, void* y,
                              long long nbr, int Kb, long long n, long long m, int v_aligned,
                              void* stream) {
  return launch<float>(blocks, bcols, v, y, nbr, Kb, n, m, v_aligned, stream);
}

extern "C" int bsr_matvec_f64(const void* blocks, const void* bcols, const void* v, void* y,
                              long long nbr, int Kb, long long n, long long m, int v_aligned,
                              void* stream) {
  return launch<double>(blocks, bcols, v, y, nbr, Kb, n, m, v_aligned, stream);
}
