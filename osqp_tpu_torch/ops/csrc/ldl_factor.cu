// K5: the numeric LDL' factorization of a quasi-definite matrix, float64.
//
// Replaces no TPU kernel: the JAX package factors the KKT matrix of its
// numpy algebra on the host (osqp_tpu/native/ldl.cpp::ldl_numeric, an
// up-looking QDLDL-class loop).  The port runs the same factorization on
// the card into the symbolic pattern the host computed
// (osqp_tpu_torch/ops/ldl.py::symbolic), so that the ADMM loop of the
// 'ldl' algebra never leaves it.  Plain version: ops/ldl.py::
// ldl_factor_plain (a dense left-looking loop).
//
// Schedule: left-looking by columns, in the heights of the elimination
// tree.  Column j's entries depend only on the columns of its row pattern,
// which are its descendants, all of lower height; so one launch per height
// computes every column of that height, and launches <= the tree's depth.
// A column is cut into items of kRows rows; several blocks take one wide
// column.  Each block first scatters row j of L, scaled by D, into its own
// dense workspace W (n doubles, zero outside the row), and sums the pivot
// d_j = K_jj - sum_k L_jk^2 D_k over it (every block of the column in the
// same fixed order, so all get the same d_j).  Then each warp takes a row
// i of the item: L_ij = (K_ij - sum_{k<j} L_ik W_k) / d_j, gathering along
// row i of L (CSR) and reading W only where it is nonzero (entries of row
// i outside row j's pattern may still be in flight in this launch).  The
// block writes L_ij to both layouts; the block of the column's first item
// writes D_j, 1/D_j and counts the pivot's sign with integer atomics.  No
// value is accumulated atomically: every sum runs in a fixed order
// (lane-strided over the pattern, then a fixed butterfly), so two runs give
// the same L and D bit for bit.
//
// Bound: the multiply-adds sum_j Lnz_j^2 (at most) at the f64 peak, or L's
// bytes once, whichever is larger.  The row gathers read L once per column
// they meet, from L2 or HBM, and a level holds few columns in a dense
// trailing block, where the launches follow one another down the chain; a
// dense-block tensor-core (DMMA) design is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // rows of a column per item (ops/ldl.py::ROWS_PER_ITEM)
constexpr int kUnroll = 4;  // a lane's gathers in flight

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // lane 0's value: one fixed order
}

__global__ void __launch_bounds__(kThreads)
ldl_factor_level(const int2* __restrict__ items, int first, int count,
                 const int* __restrict__ Lp, const int* __restrict__ Li,
                 const int* __restrict__ Rp, const int* __restrict__ Rj,
                 const int* __restrict__ kmap, const int* __restrict__ diagpos,
                 const int* __restrict__ csc2csr, const double* __restrict__ Ax,
                 double* __restrict__ Lx, double* __restrict__ Lr, double* __restrict__ D,
                 double* __restrict__ Dinv, double* __restrict__ work, int* __restrict__ stats,
                 int n) {
  __shared__ double red[kWarps];
  double* W = work + (size_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = blockIdx.x; it < count; it += gridDim.x) {
    const int2 item = items[first + it];
    const int j = item.x, r0 = item.y;
    const int rb = Rp[j], re = Rp[j + 1];

    // 1. row j of L, scaled by D, into W; the pivot's sum
    double part = 0.0;
    for (int q = rb + threadIdx.x; q < re; q += kThreads) {
      const int k = Rj[q];
      const double l = Lr[q];
      const double w = l * D[k];
      W[k] = w;
      part = fma(l, w, part);
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    const double d = Ax[diagpos[j]] - s;

    // 2. the item's rows of column j: one warp a row
    const int cb = Lp[j], ce = Lp[j + 1];
    const int pe = min(cb + r0 + kRows, ce);
    for (int p = cb + r0 + warp; p < pe; p += kWarps) {
      const int i = Li[p];
      double acc = 0.0;
      const int qe = Rp[i + 1];
      // kUnroll independent gathers in flight a lane; the terms still join
      // acc in pattern order
      for (int q0 = Rp[i] + lane; q0 < qe; q0 += 32 * kUnroll) {
        int k[kUnroll];
        double w[kUnroll], l[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          k[u] = q < qe ? Rj[q] : j;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = k[u] < j ? W[k[u]] : 0.0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) l[u] = w[u] != 0.0 ? Lr[q0 + 32 * u] : 0.0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = fma(l[u], w[u], acc);
        if (k[kUnroll - 1] >= j) break;  // columns are sorted: the rest are >= j
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const int kp = kmap[p];
        const double v = ((kp >= 0 ? Ax[kp] : 0.0) - acc) / d;
        Lx[p] = v;
        Lr[csc2csr[p]] = v;
      }
    }
    if (r0 == 0 && threadIdx.x == 0) {
      D[j] = d;
      Dinv[j] = 1.0 / d;
      if (d > 0.0) atomicAdd(stats, 1);
      else if (d == 0.0) atomicMax(stats + 1, n - j);  // the first zero pivot
    }
    __syncthreads();  // every read of W and red is done
    for (int q = rb + threadIdx.x; q < re; q += kThreads) W[Rj[q]] = 0.0;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// One numeric factorization: one launch per height of the elimination
// tree, on `stream`.  level_ptr is a host array (depth + 1 entries) into
// the device array of (column, first row) items.  stats (2 int32 on the
// card) gets the count of positive pivots and n - j for the first zero
// pivot j (0 if none).  *launched (a host int) gets the number of kernel
// launches made.  Returns the first launch error, or 0.
int ldl_factor_launch(int depth, const int* level_ptr, int gmax, const int* items,
                      const int* Lp, const int* Li, const int* Rp, const int* Rj,
                      const int* kmap, const int* diagpos, const int* csc2csr, const double* Ax,
                      double* Lx, double* Lr, double* D, double* Dinv, double* work, int* stats,
                      int n, cudaStream_t stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  for (int h = 0; h < depth; ++h) {
    const int first = level_ptr[h], count = level_ptr[h + 1] - first;
    if (count <= 0) continue;
    const int grid = count < gmax ? count : gmax;
    ldl_factor_level<<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const int2*>(items), first, count, Lp, Li, Rp, Rj, kmap, diagpos,
        csc2csr, Ax, Lx, Lr, D, Dinv, work, stats, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

}  // extern "C"
