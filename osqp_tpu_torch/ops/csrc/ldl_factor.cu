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
// Layout: L's values in CSC (Lx) and in CSR (Lr), D and 1/D.  A supernode
// (a run of columns with nested patterns, ops/ldl.py::Symbolic) is a dense
// panel of its row list by its columns, addressed in place in Lx: column
// c's entry at row position p > c sits at Lp[j0 + c] - c - 1 + p, each
// column contiguous down its rows.  Its pivots sit in D.
//
// Schedule: the host's plan walks the heights of the tree of tasks (thin
// columns and supernodes; every task depends on lower heights only).
// - Thin columns (ldl_factor_level), left-looking, cut into items of
//   kRows rows.  Each block scatters row j of L, scaled by D, into its own
//   dense workspace W (n doubles, zero outside the row) and sums the pivot
//   d_j = K_jj - sum_k L_jk^2 D_k over it; then each warp takes a row i:
//   L_ij = (K_ij - sum_{k<j} L_ik W_k) / d_j, gathering along row i of L
//   (CSR) and reading W only where it is nonzero.  A height of several
//   columns is one launch; a run of heights of one column each (a chain)
//   is one launch of one block that walks them in order: a block sees its
//   own global writes after __syncthreads.
// - A supernode s, left-looking by supernode: (1) ldl_factor_init gathers
//   K's values into its columns and subtracts from each pivot the thin
//   columns that have one entry in s's rows; (2) ldl_factor_gather copies
//   the other thin columns that update s into a dense panel G (s's rows by
//   those columns, each entry placed by a binary search in s's sorted row
//   list); (3) ldl_factor_update subtracts every earlier
//   supernode's product L[R, t] D_t L[C, t]' and G's, in 64 x 64 tiles of
//   s's lower panel, on the f64 tensor cores (mma.sync m8n8k4 .f64, DMMA):
//   slices of 16 columns staged in shared memory, double-buffered through
//   registers, each source's rows placed by its relative row map; (4) per
//   64 columns, ldl_factor_diag (one block) factors the diagonal block as
//   a dense LDL' in shared memory and writes it, D, 1/D and the pivots'
//   signs; ldl_factor_below (a block per 64 rows below) solves those rows
//   against the factored block and scales them by 1/D; ldl_factor_update
//   applies the panel to the columns on its right (the trailing update,
//   DMMA).  No block reads what another block of its launch writes.  The
//   final values go to both layouts.
// No value is accumulated atomically: every sum runs in a fixed order (a
// fixed butterfly, a fixed k order in each tile), so two runs give the
// same L and D bit for bit; the pivots' signs are counted with integer
// atomics.
//
// Bound: the multiply-adds sum_j Lnz_j (Lnz_j + 1) / 2 at the f64 tensor
// cores' peak, or L's bytes once, whichever is larger.  What holds it
// back: the supernodes' panels run in sequence (64 columns a step: three
// launches, two of them a 64-step dependency inside a block), the tiles
// of one update read their sources through L2 with no reuse beyond a
// 64 x 64 tile, and a chain of thin columns walks one column at a time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // rows of a thin column per item (ops/ldl.py::ROWS_PER_ITEM)
constexpr int kUnroll = 4;  // a lane's gathers in flight
constexpr int kTile = 64;  // a supernode's tile (ops/ldl.py::TILE)
constexpr int kK = 16;  // columns of a source in one staged slice
constexpr int kLd = kTile + 8;  // a slice's row in shared memory: a fragment load, two wavefronts
constexpr int kPanelSmem = 2 * kTile * kTile * (int)sizeof(double);

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

// The start of supernode s's columns (one block a column): K's values
// into the column, and its pivot's sum over the thin columns that have one
// entry in s's rows (Tone: they update that pivot only; Tc their CSR
// positions), in row order.
__global__ void __launch_bounds__(kThreads)
ldl_factor_init(int j0, const int* __restrict__ Lp, const int* __restrict__ kmap,
                const int* __restrict__ diagpos, const double* __restrict__ Ax,
                const int* __restrict__ Tp, const int* __restrict__ Tk,
                const int* __restrict__ Tc, const unsigned char* __restrict__ Tone,
                const double* __restrict__ Lr, double* __restrict__ Lx, double* __restrict__ D) {
  const int j = j0 + blockIdx.x;
  for (int p = Lp[j] + threadIdx.x; p < Lp[j + 1]; p += kThreads) {
    const int k = kmap[p];
    Lx[p] = k >= 0 ? Ax[k] : 0.0;
  }
  if (threadIdx.x == 0) {
    double d = Ax[diagpos[j]];
    for (int e = Tp[j]; e < Tp[j + 1]; ++e) {
      if (!Tone[e]) continue;
      const double l = Lr[Tc[e]];
      d -= l * l * D[Tk[e]];
    }
    D[j] = d;
  }
}

__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Supernode s's gathered panel G (nrows x ng, column-major): column e holds
// thin source e's entries (gsrc: column, first CSC position, count) at their
// positions in s's sorted row list `rows` (each found by a binary search),
// zero elsewhere; Dg[e] its pivot.
__global__ void __launch_bounds__(kThreads)
ldl_factor_gather(const int4* __restrict__ gsrc, const int* __restrict__ rows, int nrows,
                  const int* __restrict__ Li, const double* __restrict__ Lx,
                  const double* __restrict__ D, double* __restrict__ G, double* __restrict__ Dg) {
  const int4 g = gsrc[blockIdx.x];
  double* col = G + (size_t)blockIdx.x * nrows;
  for (int p = threadIdx.x; p < nrows; p += kThreads) col[p] = 0.0;
  __syncthreads();
  for (int i = threadIdx.x; i < g.z; i += kThreads) {
    col[lower_bound(rows, nrows, Li[g.y + i])] = Lx[g.y + i];
  }
  if (threadIdx.x == 0) Dg[blockIdx.x] = D[g.x];
}

// One update of supernode s's lower panel from row and column position
// `off` on: minus the sum over the sources, in order, of L[R, k] D_k
// L[C, k]' -- each earlier supernode in pairs (t, t's first row position
// in s, count, relmap offset), then the gathered panel G (ng columns),
// then s's own columns [k0, k1) (the trailing update of one panel).
struct UpdateArgs {
  int j0, w, nrows, off;
  int npairs, ng, k0, k1;
  const int4* pairs;
  const int* sn;  // (nsup, 4): first column, width, rows, row-list offset
  const int* Lp;
  const int* relmap;
  double* Lx;
  double* D;
  const double* G;
  const double* Dg;
};

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// A block takes the 64 x 64 output tile at rows p0.., columns q0..: the
// sum lives in registers (8 warps, each 32 x 16: 4 x 2 DMMA tiles of
// 8 x 8), the sources' slices of kK columns pass through shared memory
// (A: rows by k, B: columns by k, scaled by D_k), and the block
// subtracts it from the panel (the pivot on the diagonal) at the end.
__global__ void __launch_bounds__(kThreads)
ldl_factor_update(UpdateArgs a) {
  const int q0 = a.off + kTile * blockIdx.x;
  const int p0 = a.off + kTile * blockIdx.y;
  if (p0 + kTile <= q0) return;  // above the diagonal
  __shared__ double As[2][kK][kLd];
  __shared__ double Bs[2][kK][kLd];
  __shared__ int inv_r[kTile], inv_c[kTile];
  __shared__ int range[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m = tid & (kTile - 1), kq = tid / kTile;  // the loader's row and first k
  double acc[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  const int nsrc = a.npairs + (a.ng > 0) + (a.k1 > a.k0);
  for (int si = 0; si < nsrc; ++si) {
    // the source: 0 an earlier supernode, 1 the gathered panel, 2 s itself;
    // inv_r / inv_c: the source's row position at each row / column of the
    // tile, -1 where it has none
    int kind, sj0 = 0, kb = 0, ke = 0;
    if (si < a.npairs) {
      kind = 0;
      const int4 pr = a.pairs[si];
      sj0 = a.sn[4 * pr.x];
      ke = a.sn[4 * pr.x + 1];
      if (tid < 4) {
        const int v = tid == 0 ? p0 : tid == 1 ? p0 + kTile : tid == 2 ? q0 : min(q0 + kTile, a.w);
        range[tid] = lower_bound(a.relmap + pr.w, pr.z, v);
      }
      if (tid < kTile) inv_r[tid] = inv_c[tid] = -1;
      __syncthreads();
      for (int i = range[0] + tid; i < range[1]; i += kThreads)
        inv_r[a.relmap[pr.w + i] - p0] = pr.y + i;
      for (int i = range[2] + tid; i < range[3]; i += kThreads)
        inv_c[a.relmap[pr.w + i] - q0] = pr.y + i;
      const bool empty = range[0] == range[1] || range[2] == range[3];
      __syncthreads();
      if (empty) continue;
    } else {
      kind = si == a.npairs && a.ng > 0 ? 1 : 2;
      if (kind == 1) {
        ke = a.ng;
      } else {
        sj0 = a.j0;
        kb = a.k0;
        ke = a.k1;
      }
      if (tid < kTile) {
        inv_r[tid] = p0 + tid < a.nrows ? p0 + tid : -1;
        inv_c[tid] = q0 + tid < a.w ? q0 + tid : -1;
      }
      __syncthreads();
    }
    const int ir = inv_r[m], ic = inv_c[m];
    double ra[4], rb[4];
    auto load = [&](int kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kc + kq + 4 * i;
        double va = 0.0, vb = 0.0;
        if (k < ke) {
          const double* col;
          double d;
          if (kind == 1) {
            col = a.G + (size_t)k * a.nrows;
            d = a.Dg[k];
          } else {
            col = a.Lx + (a.Lp[sj0 + k] - k - 1);
            d = a.D[sj0 + k];
          }
          if (ir >= 0) va = col[ir];
          if (ic >= 0) vb = d * col[ic];
        }
        ra[i] = va;
        rb[i] = vb;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[buf][kq + 4 * i][m] = ra[i];
        Bs[buf][kq + 4 * i][m] = rb[i];
      }
    };
    const int nchunks = (ke - kb + kK - 1) / kK;
    load(kb);
    store(0);
    __syncthreads();
    for (int ch = 0; ch < nchunks; ++ch) {
      if (ch + 1 < nchunks) load(kb + (ch + 1) * kK);
      const int buf = ch & 1;
#pragma unroll
      for (int ks = 0; ks < kK / 4; ++ks) {
        const int kr = 4 * ks + (lane & 3);
        double fa[4], fb[2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) fa[mt] = As[buf][kr][wm * 32 + mt * 8 + (lane >> 2)];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) fb[nt] = Bs[buf][kr][wn * 16 + nt * 8 + (lane >> 2)];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) dmma(acc[mt][nt], fa[mt], fb[nt]);
      }
      if (ch + 1 < nchunks) store((ch + 1) & 1);
      __syncthreads();
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = p0 + wm * 32 + mt * 8 + (lane >> 2);
        const int c = q0 + wn * 16 + nt * 8 + (lane & 3) * 2 + i;
        if (p >= a.nrows || c >= a.w || p < c) continue;
        const double v = acc[mt][nt][i];
        if (p == c) a.D[a.j0 + c] -= v;
        else a.Lx[a.Lp[a.j0 + c] - c - 1 + p] -= v;
      }
}

// One panel of supernode s, columns c0..c0+b-1 (b <= 64), in two launches
// so that no block reads what another block of its launch writes.
// ldl_factor_diag (one block) loads the panel's diagonal block S
// (column-major, pivots on the diagonal), factors it in shared memory
// column by column, keeping each column's values unscaled (L = S / d),
// and writes L, D, 1/D and the pivots' signs.
__global__ void __launch_bounds__(kThreads)
ldl_factor_diag(int j0, int c0, int b, const int* __restrict__ Lp,
                const int* __restrict__ csc2csr, double* __restrict__ Lx,
                double* __restrict__ Lr, double* __restrict__ D, double* __restrict__ Dinv,
                int* __restrict__ stats, int n) {
  __shared__ double S[kTile * kTile];
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile, r = i % kTile;
    double v = 0.0;
    if (c < b && r < b && r >= c)
      v = r == c ? D[j0 + c0 + c] : Lx[Lp[j0 + c0 + c] - (c0 + c) - 1 + c0 + r];
    S[i] = v;
  }
  __syncthreads();
  const int r = tid & (kTile - 1), g = tid / kTile;
  for (int c = 0; c < b; ++c) {
    const double ls = S[c * kTile + r] / S[c * kTile + c];
    for (int c2 = c + 1 + g; c2 < b; c2 += kThreads / kTile) {
      if (r >= c2) S[c2 * kTile + r] -= ls * S[c * kTile + c2];  // S(c2, c), unscaled
    }
    __syncthreads();
  }
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile, rr = i % kTile;
    if (c >= b || rr >= b || rr <= c) continue;
    const int q = Lp[j0 + c0 + c] - (c0 + c) - 1 + c0 + rr;
    const double v = S[i] / S[c * kTile + c];
    Lx[q] = v;
    Lr[csc2csr[q]] = v;
  }
  if (tid < b) {
    const int j = j0 + c0 + tid;
    const double d = S[tid * kTile + tid];
    D[j] = d;
    Dinv[j] = 1.0 / d;
    if (d > 0.0) atomicAdd(stats, 1);
    else if (d == 0.0) atomicMax(stats + 1, n - j);  // the first zero pivot
  }
}

// The panel's rows below its diagonal block, after ldl_factor_diag: block
// x takes rows c0 + b + 64 x.. (X, unscaled: L_rc d_c) and solves
// X = A L^-T in the diagonal block's steps (X_rc2 -= X_rc L_c2c), then
// scales by 1/D.  It reads only the factored diagonal block and its own
// rows.  Final values go to Lx and Lr.
__global__ void __launch_bounds__(kThreads)
ldl_factor_below(int j0, int nrows, int c0, int b, const int* __restrict__ Lp,
                 const int* __restrict__ csc2csr, double* __restrict__ Lx,
                 double* __restrict__ Lr, const double* __restrict__ D) {
  extern __shared__ double smem[];
  double* Ls = smem;  // the diagonal block's L, column-major
  double* X = smem + kTile * kTile;
  const int tid = threadIdx.x;
  const int pb = c0 + b + kTile * blockIdx.x;
  const int nr = min(kTile, nrows - pb);
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile, r = i % kTile;
    const int base = c < b ? Lp[j0 + c0 + c] - (c0 + c) - 1 : 0;  // column c0 + c's offset
    Ls[i] = c < b && r < b && r > c ? Lx[base + c0 + r] : 0.0;
    X[i] = c < b && r < nr ? Lx[base + pb + r] : 0.0;
  }
  __syncthreads();
  const int r = tid & (kTile - 1), g = tid / kTile;
  for (int c = 0; c < b; ++c) {
    const double x = X[c * kTile + r];
    for (int c2 = c + 1 + g; c2 < b; c2 += kThreads / kTile) X[c2 * kTile + r] -= x * Ls[c * kTile + c2];
    __syncthreads();
  }
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile, rr = i % kTile;
    if (c >= b || rr >= nr) continue;
    const int q = Lp[j0 + c0 + c] - (c0 + c) - 1 + pb + rr;
    const double v = X[i] / D[j0 + c0 + c];
    Lx[q] = v;
    Lr[csc2csr[q]] = v;
  }
}

__host__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Everything one factorization reads and writes.  Host arrays: plan
// (nops x 3, ops/ldl.py::Symbolic.plan), sn_host (nsup x 4), pair_ptr and
// gsrc_ptr (nsup + 1 each); the rest on the card.
struct LdlFactorArgs {
  int n, gmax, nops, nsup;
  const int* plan;
  const int* sn_host;
  const int* pair_ptr;
  const int* gsrc_ptr;
  const int* sn;
  const int* sn_rows;
  const int* items;
  const int* Lp;
  const int* Li;
  const int* Rp;
  const int* Rj;
  const int* kmap;
  const int* diagpos;
  const int* csc2csr;
  const double* Ax;
  double* Lx;
  double* Lr;
  double* D;
  double* Dinv;
  double* work;
  int* stats;
  const int* Tp;
  const int* Tk;
  const int* Tc;
  const unsigned char* Tone;
  const int* pairs;
  const int* gsrc;
  const int* relmap;
  double* G;
  double* Dg;
};

// One numeric factorization on `stream`, following the plan.  stats (2
// int32 on the card) gets the count of positive pivots and n - j for the
// first zero pivot j (0 if none).  *launched (a host int) gets the number
// of kernel launches made (ops/ldl.py::Symbolic.k5_launches).  Returns the
// first launch error, or 0.
int ldl_factor_launch(const LdlFactorArgs* a, cudaStream_t stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaMemsetAsync(a->stats, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ldl_factor_below, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPanelSmem);
  if (err != cudaSuccess) return (int)err;
#define LDL_CHECK()                              \
  do {                                           \
    err = cudaGetLastError();                    \
    if (err != cudaSuccess) return (int)err;     \
    ++*launched;                                 \
  } while (0)
  for (int o = 0; o < a->nops; ++o) {
    const int kind = a->plan[3 * o], x = a->plan[3 * o + 1], y = a->plan[3 * o + 2];
    if (kind != 2) {  // thin columns: a level, or a chain walked by one block
      const int grid = kind == 1 ? 1 : (y < a->gmax ? y : a->gmax);
      ldl_factor_level<<<grid, kThreads, 0, stream>>>(
          reinterpret_cast<const int2*>(a->items), x, y, a->Lp, a->Li, a->Rp, a->Rj, a->kmap,
          a->diagpos, a->csc2csr, a->Ax, a->Lx, a->Lr, a->D, a->Dinv, a->work, a->stats, a->n);
      LDL_CHECK();
      continue;
    }
    const int s = x;
    const int j0 = a->sn_host[4 * s], w = a->sn_host[4 * s + 1], nrows = a->sn_host[4 * s + 2];
    const int pb = a->pair_ptr[s], npairs = a->pair_ptr[s + 1] - pb;
    const int gb = a->gsrc_ptr[s], ng = a->gsrc_ptr[s + 1] - gb;
    ldl_factor_init<<<w, kThreads, 0, stream>>>(j0, a->Lp, a->kmap, a->diagpos, a->Ax, a->Tp,
                                                a->Tk, a->Tc, a->Tone, a->Lr, a->Lx, a->D);
    LDL_CHECK();
    if (ng > 0) {
      ldl_factor_gather<<<ng, kThreads, 0, stream>>>(
          reinterpret_cast<const int4*>(a->gsrc) + gb, a->sn_rows + a->sn_host[4 * s + 3], nrows,
          a->Li, a->Lx, a->D, a->G, a->Dg);
      LDL_CHECK();
    }
    UpdateArgs u{j0, w, nrows, 0, npairs, ng, 0, 0, reinterpret_cast<const int4*>(a->pairs) + pb,
                 a->sn, a->Lp, a->relmap, a->Lx, a->D, a->G, a->Dg};
    if (npairs > 0 || ng > 0) {
      ldl_factor_update<<<dim3(cdiv(w, kTile), cdiv(nrows, kTile)), kThreads, 0, stream>>>(u);
      LDL_CHECK();
    }
    for (int c0 = 0; c0 < w; c0 += kTile) {
      const int b = w - c0 < kTile ? w - c0 : kTile;
      ldl_factor_diag<<<1, kThreads, 0, stream>>>(j0, c0, b, a->Lp, a->csc2csr, a->Lx, a->Lr,
                                                   a->D, a->Dinv, a->stats, a->n);
      LDL_CHECK();
      if (nrows > c0 + b) {
        ldl_factor_below<<<cdiv(nrows - c0 - b, kTile), kThreads, kPanelSmem, stream>>>(
            j0, nrows, c0, b, a->Lp, a->csc2csr, a->Lx, a->Lr, a->D);
        LDL_CHECK();
      }
      if (c0 + b < w) {
        UpdateArgs t = u;
        t.off = c0 + b;
        t.npairs = t.ng = 0;
        t.k0 = c0;
        t.k1 = c0 + b;
        ldl_factor_update<<<dim3(cdiv(w - t.off, kTile), cdiv(nrows - t.off, kTile)), kThreads, 0,
                            stream>>>(t);
        LDL_CHECK();
      }
    }
  }
#undef LDL_CHECK
  return 0;
}

}  // extern "C"
