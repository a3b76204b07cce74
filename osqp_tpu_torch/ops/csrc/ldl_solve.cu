// K6: the triangular solves of an LDL' factorization, float64:
// x = P' L'^-1 D^-1 L^-1 P b, in one launch whatever the depth of the
// elimination tree.
//
// Replaces no TPU kernel: the JAX package solves with the factor of its
// numpy algebra on the host (osqp_tpu/native/ldl.cpp::ldl_solve).  Plain
// version: ops/ldl.py::ldl_solve_plain (two dense triangular solves).
//
// Synchronization-free, after Liu et al., "A synchronization-free algorithm
// for parallel sparse triangular solves" (Euro-Par 2016): one block a
// task, the tasks in a topological order (ops/ldl.py::Symbolic.k6_tasks),
// each block claiming the next through an atomic ticket, so that a task
// waits only on tasks that blocks already resident hold.  The forward pass
// runs over the columns in increasing order, the backward pass from the
// last; permutation and 1/D are fused into them.
// - Thin rows and columns, one warp each (up to 8 a block), as sparse
//   gathers: forward, row k of L (CSR): y_k = b_perm[k] - sum_j L_kj y_j;
//   backward, column j (CSC): x_j = y_j / D_j - sum_i L_ij x_i.
// - A supernode in tiles of 64 of its columns, read in place in its panel
//   (ops/ldl.py::Symbolic): forward, the tile's rows gather the thin
//   columns' terms (one warp a row), then each earlier supernode whose
//   rows meet the tile's (its rows placed through its row list) and the
//   supernode's own columns before the tile, 64 columns at a time in
//   increasing order, each waiting on its y; then the tile's unit lower
//   triangle, one warp in registers.  Backward, the tile's columns gather
//   their panel rows below the tile, 64 at a time from the last, each
//   waiting on its x, then the transposed triangle.  The panel's columns
//   are contiguous, so a warp reads 32 neighbouring values.
// The value is its own ready flag: y and x are set to a NaN sentinel (all
// bits one, which `publish` never stores) before the launch, a finished
// task stores each value with one 8-byte store, and each term polls its
// source until the sentinel is gone (cuda::atomic_ref, relaxed, device
// scope; a short sleep between polls), so a link of the dependency chain
// costs about one L2 round trip.  A tile publishes its first value last,
// and a waiting tile polls that one value with one thread before it reads
// the rest (each still awaited): thousands of waiting threads would
// otherwise poll the same lines.
// Every sum runs in a fixed order (lane-strided or group-strided, then a
// fixed butterfly or sum): no atomic accumulation, so two runs give the
// same x bit for bit and the ADMM iterates do not change from run to run.
//
// Bound: L's values read once per pass plus the vectors, at the memory
// rate.  What holds it back: the chain of hand-overs, one a tile of a
// supernode (2 x 157 on the Portfolio's dense block, about 3-4 µs each:
// a poll of L2, the last slice's product, block barriers and the tile's
// triangle, four columns a step in one warp) and one a thin row or column
// on a chain of thin columns (2 x 131,071 on the banded KKT).

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // ops/ldl.py::SOLVE_WARPS
constexpr int kTile = 64;  // ops/ldl.py::TILE
constexpr int kGroups = kThreads / kTile;
static_assert(kWarps == 8 && kGroups == 4, "the task layout assumes 8 warps a block");

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // lane 0's value: one fixed order
}

constexpr unsigned long long kPending = ~0ull;  // the sentinel: a NaN no operation returns
constexpr unsigned kMaxSleep = 64;  // ns between polls at most
constexpr unsigned long long kNaN = 0x7ff8000000000000ull;

// The value at p once its task has stored it.  Between polls the thread
// sleeps, 8 ns at first and doubling to kMaxSleep: the many waiting warps
// then leave the issue slots and L2 to those that work.
__device__ __forceinline__ double await(const double* p) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> a(
      *reinterpret_cast<unsigned long long*>(const_cast<double*>(p)));
  unsigned long long v;
  unsigned ns = 8;
  while ((v = a.load(cuda::memory_order_relaxed)) == kPending) {
    __nanosleep(ns);
    if (ns < kMaxSleep) ns <<= 1;
  }
  return __longlong_as_double((long long)v);
}

__device__ __forceinline__ void publish(double* p, double v) {
  unsigned long long bits = (unsigned long long)__double_as_longlong(v);
  if (bits == kPending) bits = kNaN;
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
      *reinterpret_cast<unsigned long long*>(p)).store(bits, cuda::memory_order_relaxed);
}

}  // namespace

extern "C" {

// Everything one solve reads and writes, on the card.
struct LdlSolveArgs {
  int n, ntasks;
  const int* tasks;  // (ntasks, 4)
  const int* src;  // (nsrc, 4)
  const int* sn;  // (nsup, 4): first column, width, rows, row-list offset
  const int* sn_rows;
  const int* Rp;
  const int* Rj;
  const double* Lr;
  const int* Lp;
  const int* Li;
  const double* Lx;
  const double* Dinv;
  const int* Tp;
  const int* Tk;
  const int* Tc;
  const int64_t* perm;  // new index -> old, or null
  const double* b;
  double* out;
  double* y;  // 2n doubles: y, then x
  unsigned long long* ticket;
  unsigned long long base;  // the ticket counter's value before this launch
};

}  // extern "C"

namespace {

// u[k] for a k in 0..3 that differs from lane to lane, kept in registers
__device__ __forceinline__ double pick(const double (&u)[4], int k) {
  return k == 0 ? u[0] : k == 1 ? u[1] : k == 2 ? u[2] : u[3];
}

__device__ __forceinline__ void thin_row(const LdlSolveArgs& a, int k, int lane) {
  const double bk = lane == 0 ? a.b[a.perm ? a.perm[k] : k] : 0.0;
  double acc = 0.0;
  const int qe = a.Rp[k + 1];
  for (int q = a.Rp[k] + lane; q < qe; q += 32) acc = fma(a.Lr[q], await(a.y + a.Rj[q]), acc);
  acc = warp_sum(acc);
  if (lane == 0) publish(a.y + k, bk - acc);
}

__device__ __forceinline__ void thin_col(const LdlSolveArgs& a, int j, int lane) {
  double* x = a.y + a.n;
  const double zj = lane == 0 ? await(a.y + j) * a.Dinv[j] : 0.0;
  const int64_t oj = a.perm ? a.perm[j] : j;
  double acc = 0.0;
  const int cb = a.Lp[j];
  for (int q = a.Lp[j + 1] - 1 - lane; q >= cb; q -= 32) {  // rows from the last
    acc = fma(a.Lx[q], await(x + a.Li[q]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const double xj = zj - acc;
    publish(x + j, xj);
    a.out[oj] = xj;
  }
}

// Forward, the r-th tile of supernode s: rows R0..R0+nr-1.
__device__ void tile_forward(const LdlSolveArgs& a, int s, int r, int first_src, double* smem) {
  double* Lt = smem;  // Lt[c * 64 + i] = L(R0 + i, R0 + c)
  double* acc = Lt + kTile * kTile;
  double* ys = acc + kTile;
  double* red = ys + kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = a.sn[4 * s], w = a.sn[4 * s + 1];
  const int R0 = j0 + kTile * r, nr = min(kTile, w - kTile * r);
  for (int i = tid; i < kTile * kTile; i += kThreads) {  // waits on nothing
    const int c = i / kTile, ii = i % kTile;
    Lt[i] = c < nr && ii < nr && ii > c ? a.Lx[a.Lp[R0 + c] - c - 1 + ii] : 0.0;
  }
  // the tile's right-hand side, loaded before any wait
  double b0 = 0.0, b1 = 0.0;
  if (warp == 0) {
    if (lane < nr) b0 = a.b[a.perm ? a.perm[R0 + lane] : R0 + lane];
    if (lane + 32 < nr) b1 = a.b[a.perm ? a.perm[R0 + lane + 32] : R0 + lane + 32];
  }
  // the thin columns' terms, one warp a row
  for (int i = warp; i < kTile; i += kWarps) {
    double v = 0.0;
    if (i < nr) {
      const int e1 = a.Tp[R0 + i + 1];
      for (int e = a.Tp[R0 + i] + lane; e < e1; e += 32) {
        v = fma(a.Lr[a.Tc[e]], await(a.y + a.Tk[e]), v);
      }
    }
    v = warp_sum(v);
    if (lane == 0) acc[i] = v;
  }
  __syncthreads();
  // the supernodes' terms: sources (supernode, first and end row position)
  const int pos = tid % kTile, g = tid / kTile;
  auto groups = [&](int i) {  // a source's sum at row position i, its groups in order
    return ((red[i] + red[kTile + i]) + red[2 * kTile + i]) + red[3 * kTile + i];
  };
  for (int e = first_src;; ++e) {
    const int4 sr = reinterpret_cast<const int4*>(a.src)[e];
    if (sr.x < 0) break;
    const int t = sr.x, tj0 = a.sn[4 * sr.x], lo = sr.y, npos = sr.z - sr.y;
    const int ncols = t == s ? lo : a.sn[4 * t + 1];
    double part = 0.0;
    for (int k0 = 0; k0 < ncols; k0 += kTile) {
      const int kw = min(kTile, ncols - k0);
      // this thread's L values of the slice, loaded before the wait
      double lv[kTile / kGroups];
#pragma unroll
      for (int u = 0; u < kTile / kGroups; ++u) {
        const int k = k0 + g + kGroups * u;
        lv[u] = pos < npos && k < k0 + kw ? a.Lx[a.Lp[tj0 + k] - k - 1 + lo + pos] : 0.0;
      }
      // one thread polls the slice's first value, which its tile publishes
      // last; then each value is read (await: at once, in the usual case)
      if (tid == 0) await(a.y + tj0 + k0);
      __syncthreads();
      if (tid < kw) ys[tid] = await(a.y + tj0 + k0 + tid);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kTile / kGroups; ++u) {
        if (g + kGroups * u < kw) part = fma(lv[u], ys[g + kGroups * u], part);
      }
    }
    red[g * kTile + pos] = part;
    __syncthreads();
    if (t == s) break;  // the tile's own columns come last: warp 0 adds them
    if (tid < npos) acc[a.sn_rows[a.sn[4 * t + 3] + lo + tid] - R0] += groups(tid);
    __syncthreads();
  }
  // the tile's unit lower triangle: rows lane and lane + 32 in registers,
  // four columns a step (every lane solves the step's 4 x 4 triangle; each
  // row's terms join in column order, as one column a step would)
  if (warp == 0) {
    const int i0 = lane, i1 = lane + 32;
    double v0 = i0 < nr ? b0 - (acc[i0] + groups(i0)) : 0.0;
    double v1 = i1 < nr ? b1 - (acc[i1] + groups(i1)) : 0.0;
#pragma unroll
    for (int c = 0; c < kTile; c += 4) {
      const double* L = Lt + c * kTile;  // L[k * 64 + i] = L(c + i, c + k)
      double u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = __shfl_sync(0xffffffffu, c < 32 ? v0 : v1, (c + k) & 31);
      u[1] = fma(-L[c + 1], u[0], u[1]);
      u[2] = fma(-L[c + 2], u[0], u[2]);
      u[3] = fma(-L[c + 3], u[0], u[3]);
      u[2] = fma(-L[kTile + c + 2], u[1], u[2]);
      u[3] = fma(-L[kTile + c + 3], u[1], u[3]);
      u[3] = fma(-L[2 * kTile + c + 3], u[2], u[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 > c + k) v0 = fma(-L[k * kTile + i0], u[k], v0);
        if (i1 > c + k) v1 = fma(-L[k * kTile + i1], u[k], v1);
      }
      if (i0 >= c && i0 < c + 4) v0 = pick(u, i0 - c);
      if (i1 >= c && i1 < c + 4) v1 = pick(u, i1 - c);
    }
    // the first value last: the consumers' pollers watch it (each consumer
    // still waits on every value it reads)
    if (i1 < nr) publish(a.y + R0 + i1, v1);
    if (i0 < nr && i0 > 0) publish(a.y + R0 + i0, v0);
    __syncwarp();
    if (i0 == 0) publish(a.y + R0, v0);
  }
}

// Backward, the r-th tile of supernode s: columns R0..R0+nr-1.
__device__ void tile_backward(const LdlSolveArgs& a, int s, int r, double* smem) {
  double* Lt = smem;  // Lt[i * 64 + c] = L(R0 + i, R0 + c)
  double* outer = Lt + kTile * kTile;
  double* xs = outer + kTile;
  double* x = a.y + a.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = a.sn[4 * s], w = a.sn[4 * s + 1], nrows = a.sn[4 * s + 2];
  const int* rows = a.sn_rows + a.sn[4 * s + 3];
  const int C0 = kTile * r, nr = min(kTile, w - C0), R0 = j0 + C0;
  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {  // waits on nothing
    const int i = idx / kTile, c = idx % kTile;
    Lt[idx] = i < nr && c < i ? a.Lx[a.Lp[R0 + c] - c - 1 + i] : 0.0;
  }
  // warp w takes columns 8w..8w+7; lanes the rows of each 64-row slice
  constexpr int kCols = kTile / kWarps;
  double part[kCols];
  int base[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = warp * kCols + u;
    part[u] = 0.0;
    base[u] = c < nr ? a.Lp[R0 + c] - (C0 + c) - 1 : 0;
  }
  // z = y / D for the tile's columns, loaded before any wait on x
  double z0 = 0.0, z1 = 0.0;
  if (warp == 0) {
    if (lane < nr) z0 = await(a.y + R0 + lane) * a.Dinv[R0 + lane];
    if (lane + 32 < nr) z1 = await(a.y + R0 + lane + 32) * a.Dinv[R0 + lane + 32];
  }
  // slices of 64 row positions from the tile's end on, the farthest first,
  // so that the last slice is the next tile's columns
  const int start = C0 + nr;
  const int last = nrows > start ? start + (nrows - start - 1) / kTile * kTile : start - 1;
  for (int b0 = last; b0 >= start; b0 -= kTile) {
    const int cnt = min(kTile, nrows - b0);
    // this lane's L values of the slice, loaded before the wait
    double l0[kCols], l1[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const bool col = warp * kCols + u < nr;
      l0[u] = col && lane < cnt ? a.Lx[base[u] + b0 + lane] : 0.0;
      l1[u] = col && lane + 32 < cnt ? a.Lx[base[u] + b0 + lane + 32] : 0.0;
    }
    // one thread polls the slice's first row, the last to be solved in
    // the usual case; then each value is read
    if (tid == 0) await(x + rows[b0]);
    __syncthreads();
    if (tid < cnt) xs[tid] = await(x + rows[b0 + tid]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      if (warp * kCols + u >= nr) continue;
      if (lane < cnt) part[u] = fma(l0[u], xs[lane], part[u]);
      if (lane + 32 < cnt) part[u] = fma(l1[u], xs[lane + 32], part[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const double v = warp_sum(part[u]);
    if (lane == 0) outer[warp * kCols + u] = v;
  }
  __syncthreads();
  // the transposed triangle: columns lane and lane + 32 in registers
  if (warp == 0) {
    const int c0 = lane, c1 = lane + 32;
    double v0 = c0 < nr ? z0 - outer[c0] : 0.0;
    double v1 = c1 < nr ? z1 - outer[c1] : 0.0;
    // four rows a step from the last (every lane solves the step's 4 x 4
    // triangle; each column's terms join in row order, as one row a step
    // would)
#pragma unroll
    for (int i = kTile - 1; i > 0; i -= 4) {
      double u[4];  // u[k]: row i - k
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = __shfl_sync(0xffffffffu, i < 32 ? v0 : v1, (i - k) & 31);
      const double* L = Lt + i * kTile;  // L[-k * 64 + c] = L(R0 + i - k, R0 + c)
      u[1] = fma(-L[i - 1], u[0], u[1]);
      u[2] = fma(-L[i - 2], u[0], u[2]);
      u[3] = fma(-L[i - 3], u[0], u[3]);
      u[2] = fma(-L[-kTile + i - 2], u[1], u[2]);
      u[3] = fma(-L[-kTile + i - 3], u[1], u[3]);
      u[3] = fma(-L[-2 * kTile + i - 3], u[2], u[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 < i - k) v0 = fma(-L[-k * kTile + c0], u[k], v0);
        if (c1 < i - k) v1 = fma(-L[-k * kTile + c1], u[k], v1);
      }
      if (c0 <= i && c0 > i - 4) v0 = pick(u, i - c0);
      if (c1 <= i && c1 > i - 4) v1 = pick(u, i - c1);
    }
    // the first value last: the consumers' pollers watch it; the caller's
    // order after, off the chain
    if (c1 < nr) publish(x + R0 + c1, v1);
    if (c0 < nr && c0 > 0) publish(x + R0 + c0, v0);
    __syncwarp();
    if (c0 == 0) publish(x + R0, v0);
    if (c0 < nr) a.out[a.perm ? a.perm[R0 + c0] : R0 + c0] = v0;
    if (c1 < nr) a.out[a.perm ? a.perm[R0 + c1] : R0 + c1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads) ldl_solve_kernel(LdlSolveArgs a) {
  extern __shared__ double smem[];
  __shared__ unsigned long long claimed;
  if (threadIdx.x == 0) claimed = atomicAdd(a.ticket, 1ull) - a.base;
  __syncthreads();
  const unsigned long long t = claimed;
  if (t >= (unsigned long long)a.ntasks) return;
  const int4 task = reinterpret_cast<const int4*>(a.tasks)[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (task.x == 0) {
    if (warp < task.z) thin_row(a, task.y + warp, lane);
  } else if (task.x == 2) {
    if (warp < task.z) thin_col(a, task.y - warp, lane);
  } else if (task.x == 1) {
    tile_forward(a, task.y, task.z, task.w, smem);
  } else {
    tile_backward(a, task.y, task.z, smem);
  }
}

}  // namespace

extern "C" {

// One solve on `stream`: y and x set to the sentinel, then one block a
// task, each claiming one ticket; a->base is the ticket counter's value
// before this launch (every launch takes a->ntasks tickets).  smem: the
// supernode tiles' dynamic shared memory (0 where there is no supernode).
// Returns the first error, or 0.
int ldl_solve_launch(const LdlSolveArgs* a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(a->y, 0xff, 2 * (size_t)a->n * sizeof(double), stream);
  if (err != cudaSuccess) return (int)err;
  ldl_solve_kernel<<<a->ntasks, kThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
