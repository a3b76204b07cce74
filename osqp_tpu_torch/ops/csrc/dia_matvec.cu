// DIA (diagonal-storage) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/proto_dia_pallas.py::make_dia_matvec_pallas
// (its inner `kernel`), the Pallas version of the live plain-jnp matvec
// osqp_tpu/ops/spmv.py::_dia_matvec.  It computes
//     y[r] = sum_{d=0}^{D-1} bands[d, r] * v[r + off_d],   r < m_out,
// where a term whose index r + off_d falls outside [0, n_in) contributes
// nothing.  Its plain PyTorch version is osqp_tpu_torch/ops/dia_matvec.py::
// dia_matvec_plain; the two compute the same function.
//
// What bounds it: bytes.  Each output row reads D band values and D entries
// of v and writes one value, two flops per band, so the least time is
// (D * m_out + m_out + n_in) * sizeof(T) over the card's memory rate
// (3.35 TB/s on an H100 SXM): 12.5 us for D = 3, m_out = n_in = 2^20 in f64.
//
// Design: the TPU kernel stages three aligned 8192-wide tiles of the padded
// vector in VMEM and shifts them with pltpu.roll, because Mosaic refuses
// unaligned slices.  None of that is needed here.  One thread computes one
// output row, in a grid that covers m_out and masks the ragged edge.  A warp
// reads 32 consecutive band values of each diagonal (coalesced) and 32
// consecutive entries of v at the diagonal's shift, through the read-only
// cache; neighbouring diagonals hit the same cache lines of v, so v crosses
// device memory about once.  The offsets sit in shared memory.  Indices are
// 64-bit.  Terms are summed in offset order d = 0..D-1, the order of the
// plain version, and every product and sum is rounded on its own (no FMA
// contraction), as the plain version's separate multiply and add kernels
// round them, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBands = 1024;  // spmv._DIA_MAX_BANDS

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_matvec_kernel(const T* __restrict__ bands, const int* __restrict__ offsets,
                  const T* __restrict__ v, T* __restrict__ y, int D,
                  long long m_out, long long n_in) {
  __shared__ int off[kMaxBands];
  for (int d = threadIdx.x; d < D; d += blockDim.x) off[d] = offsets[d];
  __syncthreads();

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m_out) return;
  T acc = T(0);
  for (int d = 0; d < D; ++d) {
    const long long c = r + (long long)off[d];
    const T b = __ldg(bands + (long long)d * m_out + r);
    const T x = (c >= 0 && c < n_in) ? __ldg(v + c) : T(0);
    acc = d == 0 ? mul_rn(b, x) : add_rn(acc, mul_rn(b, x));
  }
  y[r] = acc;
}

template <typename T>
int launch(const void* bands, const void* offsets, const void* v, void* y, int D,
           long long m_out, long long n_in, void* stream) {
  if (D < 1 || D > kMaxBands || m_out < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (m_out + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dia_matvec_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const int*>(offsets),
      static_cast<const T*>(v), static_cast<T*>(y), D, m_out, n_in);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: bands (D, m_out) contiguous, offsets (D,) int32, v (n_in,),
// y (m_out,), all on the device; the launch goes on `stream`.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dia_matvec_f32(const void* bands, const void* offsets, const void* v, void* y,
                              int D, long long m_out, long long n_in, void* stream) {
  return launch<float>(bands, offsets, v, y, D, m_out, n_in, stream);
}

extern "C" int dia_matvec_f64(const void* bands, const void* offsets, const void* v, void* y,
                              int D, long long m_out, long long n_in, void* stream) {
  return launch<double>(bands, offsets, v, y, D, m_out, n_in, stream);
}
