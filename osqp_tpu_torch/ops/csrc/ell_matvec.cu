// ELL (padded-row) sparse matrix-vector product for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package computes an EllMatrix
// product as the plain jnp expression osqp_tpu/ops/spmv.py:240,
//     y[r] = sum_{k<K} data[r, k] * v[cols[r, k]],   r < m,
// which XLA fuses into one pass.  In eager PyTorch the same expression is a
// gather, a multiply and a row sum with an (m, K) temporary; this kernel is
// one launch.  Its plain PyTorch version is osqp_tpu_torch/ops/ell_matvec.py::
// ell_matvec_plain.  Pads are zero data at column 0 and are not skipped, so a
// non-finite v[0] spreads into every padded row as it does in the plain
// version.
//
// What bounds it: bytes.  The product needs each stored entry that is not a
// pad (nnz values and int32 columns), v at least once and y once:
// (nnz (sizeof(T) + 4) + (m + n) sizeof(T)) bytes over 3.35 TB/s.  The
// kernel reads the padded arrays, m K (sizeof(T) + 4) bytes, so on rows
// shorter than K it moves more than the product needs.
//
// Design: a group of G lanes (a power of two up to 32, the least >= K) per
// row, 256 / G rows per block.  Lane j of a group sums k = j, j + G, ...; as
// data and cols are row-major, a warp's loads of them cover 32 / G rows side
// by side and coalesce.  v is gathered through the read-only cache.  The
// group's sums meet in a shuffle reduction over xor offsets below G, which
// never leaves the group.  Every lane reaches the shuffles (rows past m add
// zeros), so the full mask is valid.  Row indices are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                  const T* __restrict__ v, T* __restrict__ y, long long m, int K,
                  int log2g) {
  const int g = 1 << log2g;
  const int lane = threadIdx.x & (g - 1);
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> log2g;
  T acc = T(0);
  if (r < m) {
    const T* dr = data + r * K;
    const int* cr = cols + r * K;
    for (int k = lane; k < K; k += g) acc += __ldg(dr + k) * __ldg(v + __ldg(cr + k));
  }
  for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < m && lane == 0) y[r] = acc;
}

template <typename T>
int launch(const void* data, const void* cols, const void* v, void* y, long long m, int K,
           int log2g, void* stream) {
  if (m < 1 || K < 1 || log2g < 0 || log2g > 5) return (int)cudaErrorInvalidValue;
  const long long grid = ((m << log2g) + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ell_matvec_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols), static_cast<const T*>(v),
      static_cast<T*>(y), m, K, log2g);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: data (m, K) contiguous, cols (m, K) int32 in [0, len(v)),
// v, y (m,), all on the device; G = 2^log2g lanes per row.  The launch goes on
// `stream`.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_matvec_f32(const void* data, const void* cols, const void* v, void* y,
                              long long m, int K, int log2g, void* stream) {
  return launch<float>(data, cols, v, y, m, K, log2g, stream);
}

extern "C" int ell_matvec_f64(const void* data, const void* cols, const void* v, void* y,
                              long long m, int K, int log2g, void* stream) {
  return launch<double>(data, cols, v, y, m, K, log2g, stream);
}
