// BSR (block-ELL) sparse matrix-vector product for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package computes a BsrMatrix
// product as plain jnp, osqp_tpu/ops/spmv.py:297 (_bsr_matvec), which XLA
// fuses on the TPU: pad v to nbc * 128, gather one 128-wide segment of it
// per block, and contract
//     y[8 b + r] = sum_{k<Kb} sum_{c<128} blocks[b, k, r, c] * v[128 bcols[b, k] + c]
// for the rows below m.  In eager PyTorch that is a pad, a gather and a
// batched product; this kernel is one launch.  Its plain PyTorch version is
// osqp_tpu_torch/ops/bsr_matvec.py::bsr_matvec_plain.
//
// What bounds it: bytes.  The dense (8, 128) blocks dominate: the product
// needs the nb stored blocks that are not padding, nb 1024 sizeof(T) bytes,
// nb 4 of block-columns, and v and y once, over 3.35 TB/s.
//
// Padding blocks are skipped.  nblk[b] (ops/bsr_matvec.py::block_counts,
// stored on the operator) is 1 + the last slot of block-row b whose
// block-column is not 0 or whose block holds a non-zero; every slot past it
// is a zero block at block-column 0, so the warp reads only the first
// nblk[b] blocks.  The plain version multiplies each padding block by
// v[0 : 128] (zero past n), which is NaN in all 8 rows when one of those
// values is not finite: a block-row with nblk[b] < Kb checks them (four per
// lane, then __any_sync) and is then set to NaN.
//
// Design: one warp per block-row, 4 warps per block.  Lane l owns columns
// 4l .. 4l + 3 of every block: per block it loads those four entries of the
// v segment (one 16-byte load in f32, two in f64, where the segment lies
// inside v and v is 16-byte aligned; else four guarded scalar loads, so v is
// never padded on the device), then the same four columns of each of the 8
// block rows (16 bytes per row in f32, 32 in f64: a warp reads each 512- or
// 1024-byte block row in one coalesced sweep), and keeps 8 row sums.  The
// lanes load the row's block-columns together, 32 at a time, and broadcast
// each by shuffle.  The loads of block k + 1 are issued before the FMAs of
// block k, so a warp keeps one whole block (4 or 8 KB) in flight while it
// computes.  After the row's blocks each row sum is reduced over the warp by
// shuffles, and lanes 0..7 write the rows that lie below m.  Indices are
// 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 8;
constexpr int kC = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec4 {
  T x, y, z, w;
};

// One lane's share of a block: its four entries of the v segment and its
// four columns of each of the 8 block rows.
template <typename T>
struct Slice {
  Vec4<T> x;
  Vec4<T> a[kR];
};

__device__ __forceinline__ float quiet_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ Vec4<float> load4(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {a.x, a.y, a.z, a.w};
}

__device__ __forceinline__ Vec4<double> load4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

// v[c .. c + 3], zero past n.
template <typename T>
__device__ __forceinline__ Vec4<T> load_v(const T* v, long long c, long long n, int v_aligned) {
  if (v_aligned && c + 4 <= n) return load4(v + c);
  Vec4<T> x;
  x.x = c < n ? __ldg(v + c) : T(0);
  x.y = c + 1 < n ? __ldg(v + c + 1) : T(0);
  x.z = c + 2 < n ? __ldg(v + c + 2) : T(0);
  x.w = c + 3 < n ? __ldg(v + c + 3) : T(0);
  return x;
}

template <typename T>
__device__ __forceinline__ void load_slice(Slice<T>& s, const T* blk, const T* v, long long c,
                                           long long n, int v_aligned) {
  s.x = load_v(v, c, n, v_aligned);
#pragma unroll
  for (int r = 0; r < kR; ++r) s.a[r] = load4(blk + r * kC);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_matvec_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                  const int* __restrict__ nblk, const T* __restrict__ v, T* __restrict__ y,
                  long long nbr, int Kb, long long n, long long m, int v_aligned) {
  const int lane = threadIdx.x & 31;
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= nbr) return;  // b is the same for the whole warp
  const int nb = __ldg(nblk + b);  // and so is nb
  const int* bc_row = bcols + b * Kb;
  const T* blk_row = blocks + b * Kb * (kR * kC) + 4 * lane;
  T acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = T(0);
  int bc = 0;  // block-columns k0 + lane of the current chunk of 32
  Slice<T> next;
  if (nb > 0) {
    bc = lane < nb ? __ldg(bc_row + lane) : 0;
    load_slice(next, blk_row, v, (long long)__shfl_sync(kFull, bc, 0) * kC + 4 * lane, n,
               v_aligned);
  }
  for (int k = 0; k < nb; ++k) {
    const Slice<T> cur = next;
    const int k1 = k + 1;
    if (k1 < nb) {
      if ((k1 & 31) == 0) bc = k1 + lane < nb ? __ldg(bc_row + k1 + lane) : 0;
      load_slice(next, blk_row + (long long)k1 * (kR * kC), v,
                 (long long)__shfl_sync(kFull, bc, k1 & 31) * kC + 4 * lane, n, v_aligned);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      acc[r] += cur.a[r].x * cur.x.x + cur.a[r].y * cur.x.y + cur.a[r].z * cur.x.z +
                cur.a[r].w * cur.x.w;
  }
  bool pad_nan = false;
  if (nb < Kb) {  // padding blocks multiply v[0 : 128]
    const Vec4<T> x = load_v(v, 4 * lane, n, v_aligned);
    pad_nan = __any_sync(kFull, !(isfinite(x.x) && isfinite(x.y) && isfinite(x.z) &&
                                  isfinite(x.w)));
  }
  T out = T(0);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    T s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == r) out = s;
  }
  const long long row = b * kR + lane;
  if (lane < kR && row < m) y[row] = pad_nan ? quiet_nan(out) : out;
}

template <typename T>
int launch(const void* blocks, const void* bcols, const void* nblk, const void* v, void* y,
           long long nbr, int Kb, long long n, long long m, int v_aligned, void* stream) {
  if (nbr < 1 || Kb < 1 || n < 1 || m < 1 || m > nbr * kR) return (int)cudaErrorInvalidValue;
  const long long grid = (nbr * 32 + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bsr_matvec_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(bcols),
      static_cast<const int*>(nblk), static_cast<const T*>(v), static_cast<T*>(y), nbr, Kb, n,
      m, v_aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: blocks (nbr, Kb, 8, 128) contiguous and 16-byte aligned,
// bcols (nbr, Kb) int32 with every 128 bcols < n + 127, nblk (nbr,) int32 in
// [0, Kb] with every slot at or past nblk[b] a padding block, v (n,), y (m,)
// with m <= 8 nbr, all on the device; v_aligned says whether v is 16-byte
// aligned.  The launch goes on `stream`.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bsr_matvec_f32(const void* blocks, const void* bcols, const void* nblk,
                              const void* v, void* y, long long nbr, int Kb, long long n,
                              long long m, int v_aligned, void* stream) {
  return launch<float>(blocks, bcols, nblk, v, y, nbr, Kb, n, m, v_aligned, stream);
}

extern "C" int bsr_matvec_f64(const void* blocks, const void* bcols, const void* nblk,
                              const void* v, void* y, long long nbr, int Kb, long long n,
                              long long m, int v_aligned, void* stream) {
  return launch<double>(blocks, bcols, nblk, v, y, nbr, Kb, n, m, v_aligned, stream);
}
