// ELL (padded-row) sparse matrix-vector product for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package computes an EllMatrix
// product as the plain jnp expression osqp_tpu/ops/spmv.py:240,
//     y[r] = sum_{k<K} data[r, k] * v[cols[r, k]],   r < m,
// which XLA fuses into one pass.  In eager PyTorch the same expression is a
// gather, a multiply and a row sum with an (m, K) temporary; this kernel is
// one launch.  Its plain PyTorch version is osqp_tpu_torch/ops/ell_matvec.py::
// ell_matvec_plain.
//
// What bounds it: bytes.  The product needs each stored entry that is not a
// pad (nnz values and int32 columns), v at least once and y once:
// (nnz (sizeof(T) + 4) + (m + n) sizeof(T)) bytes over 3.35 TB/s.
//
// Pads are skipped.  lens[r] (ops/ell_matvec.py::row_lens, stored on the
// operator) is 1 + the last slot of row r that holds non-zero data or a
// non-zero column; every slot past it is a pad, zero data at column 0, so a
// lane reads only slots below lens[r] and the padded tail of a row is never
// fetched.  The plain version adds 0 * v[0] for each of those pads, which is
// NaN when v[0] is not finite: a row with lens[r] < K is then set to NaN, so
// the kernel's NaNs lie where the plain version's do.
//
// Design: a group of G = 2^log2g lanes per row (chosen once per operator from
// its mean row length, ops/ell_matvec.py::lanes_log2), 256 / G rows per
// block.  Lane j of a group sums k = j, j + G, ... < lens[r].  A lane takes
// two of its slots per step with predicated loads: first both columns and
// data, then both gathers of v (through the read-only cache), then the FMAs,
// so a row of up to 2 G entries is read in one step with all its loads in
// flight.  (Four slots per step, two rows per group, a pipeline over rows,
// cache hints that stream data and cols or keep v out of L1, 128- or
// 512-thread blocks, and loading the first slot before lens arrives were no
// faster on the ELL family's operators: PERF.md, section 6.)  What sets the
// pace there is traffic through L2: one 32-byte sector per gather of v for 8
// or 4 useful bytes, and, on rows much shorter than K, the 64-byte bursts
// around each row's entries, which the padded stride makes twice their size.
// The group's sums meet in a shuffle reduction over xor offsets below G,
// which never leaves the group.  Every lane reaches the shuffles (rows past m
// add zeros), so the full mask is valid.  Row indices are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

__device__ __forceinline__ float quiet_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                  const int* __restrict__ lens, const T* __restrict__ v, T* __restrict__ y,
                  long long m, int K, int log2g) {
  const int g = 1 << log2g;
  const int lane = threadIdx.x & (g - 1);
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> log2g;
  T acc = T(0);
  int len = 0;
  if (r < m) {
    len = __ldg(lens + r);
    const T* dr = data + r * K;
    const int* cr = cols + r * K;
    for (int k = lane; k < len; k += kUnroll * g) {
      int c[kUnroll];
      T d[kUnroll], x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + u * g;
        c[u] = kk < len ? __ldg(cr + kk) : 0;
        d[u] = kk < len ? __ldg(dr + kk) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = k + u * g < len ? __ldg(v + c[u]) : T(0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += d[u] * x[u];
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < m && lane == 0) {
    if (len < K && !isfinite(__ldg(v))) acc = quiet_nan(acc);  // 0 * v[0] in a skipped pad
    y[r] = acc;
  }
}

template <typename T>
int launch(const void* data, const void* cols, const void* lens, const void* v, void* y,
           long long m, int K, int log2g, void* stream) {
  if (m < 1 || K < 1 || log2g < 0 || log2g > 5) return (int)cudaErrorInvalidValue;
  const long long grid = ((m << log2g) + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ell_matvec_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols),
      static_cast<const int*>(lens), static_cast<const T*>(v), static_cast<T*>(y), m, K,
      log2g);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: data (m, K) contiguous, cols (m, K) int32 in [0, len(v)),
// lens (m,) int32 in [0, K] with every slot at or past lens[r] a pad, v,
// y (m,), all on the device; G = 2^log2g lanes per row.  The launch goes on
// `stream`.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_matvec_f32(const void* data, const void* cols, const void* lens,
                              const void* v, void* y, long long m, int K, int log2g,
                              void* stream) {
  return launch<float>(data, cols, lens, v, y, m, K, log2g, stream);
}

extern "C" int ell_matvec_f64(const void* data, const void* cols, const void* lens,
                              const void* v, void* y, long long m, int K, int log2g,
                              void* stream) {
  return launch<double>(data, cols, lens, v, y, m, K, log2g, stream);
}
