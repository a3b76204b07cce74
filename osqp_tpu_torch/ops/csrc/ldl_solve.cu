// K6: the triangular solves of an LDL' factorization, float64:
// x = P' L'^-1 D^-1 L^-1 P b, in one launch whatever the depth of the
// elimination tree.
//
// Replaces no TPU kernel: the JAX package solves with the factor of its
// numpy algebra on the host (osqp_tpu/native/ldl.cpp::ldl_solve).  Plain
// version: ops/ldl.py::ldl_solve_plain (two dense triangular solves).
//
// Synchronization-free, after Liu et al., "A synchronization-free algorithm
// for parallel sparse triangular solves" (Euro-Par 2016): one warp a task,
// 2n tasks in a topological order, each warp claiming the next through an
// atomic ticket, so that a task waits only on tasks that warps already
// resident hold.  Tasks 0..n-1 are the forward pass, row k of L (CSR):
// y_k = b_perm[k] - sum_j L_kj y_j; tasks n..2n-1 the backward pass, column
// j of L (CSC) from the last: x_j = y_j / D_j - sum_i L_ij x_i, written to
// out[perm[j]].  Permutation and diagonal are fused into the passes.  The
// value is its own ready flag: y and x are set to a NaN sentinel (all bits
// one, which `publish` never stores) before the launch, a finished task
// stores its value with one 8-byte store, and each term polls its source
// until the sentinel is gone (cuda::atomic_ref, relaxed, device scope: an
// aligned 8-byte load sees the sentinel or the value, and nothing else is
// published), so a link of the dependency chain costs one L2 round trip.
// The sums are gathers in a fixed order (lane-strided over the pattern,
// then a fixed butterfly): no atomic accumulation, so two runs give the
// same x bit for bit and the ADMM iterates do not change from run to run.
//
// Bound: L's values and indices read once per pass plus the vectors, at the
// memory rate; in practice the longest dependency chain (a dense trailing
// block is a chain as long as the block), one hand-over per link.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // ops/ldl.py::SOLVE_WARPS
static_assert(kWarps == 8, "the wrapper's ticket count assumes 8 warps a block");

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // lane 0's value: one fixed order
}

constexpr unsigned long long kPending = ~0ull;  // the sentinel: a NaN no operation returns
constexpr unsigned long long kNaN = 0x7ff8000000000000ull;

// The value at p once its task has stored it.
__device__ __forceinline__ double await(double* p) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> a(
      *reinterpret_cast<unsigned long long*>(p));
  unsigned long long v;
  while ((v = a.load(cuda::memory_order_relaxed)) == kPending) {
  }
  return __longlong_as_double((long long)v);
}

__device__ __forceinline__ void publish(double* p, double v) {
  unsigned long long bits = (unsigned long long)__double_as_longlong(v);
  if (bits == kPending) bits = kNaN;
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
      *reinterpret_cast<unsigned long long*>(p)).store(bits, cuda::memory_order_relaxed);
}

__global__ void __launch_bounds__(kThreads)
ldl_solve_kernel(int n, const int* __restrict__ Rp, const int* __restrict__ Rj,
                 const double* __restrict__ Lr, const int* __restrict__ Lp,
                 const int* __restrict__ Li, const double* __restrict__ Lx,
                 const double* __restrict__ Dinv, const int64_t* __restrict__ perm,
                 const double* __restrict__ b, double* __restrict__ out, double* y, double* x,
                 unsigned long long* ticket, unsigned long long base) {
  const int lane = threadIdx.x & 31;
  unsigned long long t = 0;
  if (lane == 0) t = atomicAdd(ticket, 1ull) - base;
  t = __shfl_sync(0xffffffffu, t, 0);
  if (t >= 2ull * (unsigned long long)n) return;
  // every load that does not wait on another task comes before the
  // waits, off the chain's critical path
  if (t < (unsigned long long)n) {  // forward: row k of L
    const int k = (int)t;
    const double bk = lane == 0 ? b[perm ? perm[k] : k] : 0.0;
    double acc = 0.0;
    const int qe = Rp[k + 1];
    for (int q = Rp[k] + lane; q < qe; q += 32) acc = fma(Lr[q], await(y + Rj[q]), acc);
    acc = warp_sum(acc);
    if (lane == 0) publish(y + k, bk - acc);
  } else {  // backward: column j of L, the last column first
    const int j = n - 1 - (int)(t - n);
    const double zj = lane == 0 ? await(y + j) * Dinv[j] : 0.0;
    const int64_t oj = perm ? perm[j] : j;
    double acc = 0.0;
    const int cb = Lp[j];
    for (int q = Lp[j + 1] - 1 - lane; q >= cb; q -= 32) {  // rows from the last
      acc = fma(Lx[q], await(x + Li[q]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const double xj = zj - acc;
      publish(x + j, xj);
      out[oj] = xj;
    }
  }
}

}  // namespace

extern "C" {

// One solve on `stream`: y and x (2n doubles, contiguous from y) set to the
// sentinel, then `grid` blocks of kWarps warps, one ticket each; `base` is
// the ticket counter's value before this launch (every launch takes
// grid * kWarps tickets).  perm (int64, new index -> old) may be null.
// Returns the first error, or 0.
int ldl_solve_launch(int n, const int* Rp, const int* Rj, const double* Lr, const int* Lp,
                     const int* Li, const double* Lx, const double* Dinv, const int64_t* perm,
                     const double* b, double* out, double* y, unsigned long long* ticket,
                     unsigned long long base, int grid, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(y, 0xff, 2 * (size_t)n * sizeof(double), stream);
  if (err != cudaSuccess) return (int)err;
  ldl_solve_kernel<<<grid, kThreads, 0, stream>>>(n, Rp, Rj, Lr, Lp, Li, Lx, Dinv, perm, b,
                                                   out, y, y + n, ticket, base);
  return (int)cudaGetLastError();
}

}  // extern "C"
