// Fused shared-structure ADMM epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel osqp_tpu/ops/shared_epoch.py::_body_kernel
// (launched by shared_body_pallas).  One launch runs one whole epoch of the
// shared-structure batched engine for every batch column:
//   1. K affine ADMM iterations  V = F @ S + c0,  z = clip(V[n:], l, u),
//      then the y and x relaxation updates (S = [x; z; y], (n+2m, B));
//   2. the active-column merge (terminated columns stay frozen);
//   3. the full per-column termination check (residuals, objective, dual
//      objective and gap with its noise floor, both infeasibility
//      certificates, the non-convexity guard);
//   4. capture of newly terminated columns (fS, fdX, fdY).
// Its plain PyTorch version is osqp_tpu_torch/ops/shared_epoch.py::
// shared_epoch_plain; the two compute the same function.
//
// What bounds it: operations.  Per epoch the work is about
// K * 2 (n+m)(n+2m) B flops for the iterations (2.1 GFLOP at n=32, m=48,
// B=4096, K=25) against one read and one write of the state, a few MB, so
// the bound is the card's fp32 (or fp64) peak rate, not memory.
//
// Design: one block per tile of TB batch columns (TB a power of two up to 32).
// Everything the block touches within an epoch lives in shared memory (the
// Layout below): its slice of the state S, dX, dY; the epoch-constant tiles
// c0, L, U and Q and the vectors rho, 1/rho; and the iteration matrix F,
// stored transposed (k-major, row stride LDW), so that the four rows a thread
// needs at one k are contiguous and one vector load fetches them.  F stays
// resident for the epoch where it fits beside the tiles (KS = n + 2m: 40 KB at
// n=32, m=48 in f32); otherwise it is streamed through in slabs of KS rows of
// k in every iteration (640 KB at n=128, m=192).  [P; A] and A' of the check
// pass through the same buffer after the iterations.  The tiles and the
// resident matrices arrive by cp.async, all of a phase's copies in flight at
// once, so a phase costs one trip to memory.
//
// The product is register-tiled: each thread owns a 4 x TC micro-tile of
// V (4 rows, TC columns), and for each k it makes one vector load of F' and
// one of S, then 4 TC FMAs, summing k in order (at n=32, m=48 the iterates
// then equal the plain version's bit for bit on an H100).  The block
// has ceil((n+m)/4) * TB/TC threads, one micro-tile each, so the rows of V
// are split evenly with no idle second pass.  The sums stay in registers;
// after a barrier the owning thread applies the clip and the x, z, y updates
// straight from them with vector accesses, rounding each product and sum on
// its own as the plain version's elementwise kernels do, so V never goes to
// shared memory in the iterations.  LDW is 16 bytes past a multiple of 128
// bytes, so the transposing stores of F (one 16-byte store per thread,
// consecutive k on consecutive threads) and the reads of F' (one k, adjacent
// 16-byte chunks across the warp) are free of bank conflicts; the state
// tiles have row stride TB, since every walk over them is
// column-contiguous.
//
// The termination check runs its matvecs with the same routine.  Its column
// reductions are split into independent tasks (a thread per task and
// column), each in feature order, and one thread per column combines them.
// The check is plain IEEE fp32 or fp64 on the CUDA cores in every mode; its
// products and sums may be contracted to FMA.  Tiles whose columns have all
// terminated skip the iterations.  The ragged batch edge is masked; nothing
// is padded in device memory.
//
// Reduced iteration precision (float32 only; H bfloat16 halves, the JAX
// kernel's iter_mode): 'high' (H = 2) computes F S as
// F_hi S_hi + (F_hi S_lo + F_lo S_hi) and 'default' (H = 1) as F_hi S_hi,
// where X_hi = bf16(X) and X_lo = bf16(X - X_hi), rounded to nearest even.
// Each product of bfloat16 values is exact in fp32 and summed in fp32, as on
// the TPU's matrix unit, by the tensor cores: mma.sync m16n8k16 bf16 tiles
// with fp32 accumulators, one warp per 16-row, 8-column tile of V (up to
// kMaxTiles of them).  F's halves are made while F is staged (once per epoch
// when resident, per slab and iteration otherwise), row-major with rows
// zero-padded to 16 and k to 16; the state's halves are rewritten from the
// fp32 state, which stays fp32, in every iteration, column-major (k
// contiguous).  Row strides are 8 bfloat16 past a multiple of 16, so each
// fragment load (8 rows by 4 words per warp) hits 32 banks.  The epilogue
// runs on each thread's accumulator fragment, element by element, with the
// rounding of the fp32 path; the block's threads are rounded up to whole
// warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kSolved = 1;
constexpr int kPinf = 3;
constexpr int kDinf = 5;
constexpr int kNonCvx = 9;
constexpr int kUnsolved = 11;

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

template <typename T> __device__ __forceinline__ T absv(T x) { return Limits<T>::abs(x); }

// Products, sums and differences rounded on their own (never contracted to
// FMA), as the plain version's separate elementwise kernels round them.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T> struct Scalars {
  T alpha, eps_abs, eps_rel, eps_pinf, eps_dinf, c, cinv;
  int K, unscaled, check_dualgap;
};

template <typename T> struct Args {
  // inputs
  const T *F, *CH, *At, *rho, *rhoinv, *D, *Dinv, *E, *Einv;
  const T *c0, *Q, *L, *U, *S, *dX, *dY, *fS, *fdX, *fdY;
  const int *status;
  // outputs
  T *So, *dXo, *dYo, *fSo, *fdXo, *fdYo;
  int *status_o;
  T *pri_o, *dua_o, *obj_o, *dobj_o;
};

// NaN-propagating max and min, as jnp.maximum / torch.maximum.
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// Row stride of the staged F' in elements: the rows of V rounded up to 4,
// then up to 16 bytes past a multiple of 128 bytes (see the design note).
__host__ __device__ inline int w_stride(int nm, int size) {
  const int r4 = (nm + 3) / 4 * 4;
  const int mod = 128 / size, want = 16 / size;
  return r4 + ((want - r4 % mod) % mod + mod) % mod;
}

// Row stride, in 32-bit words, of a bfloat16 matrix of k columns in shared
// memory: k rounded up to 16, plus 8 bfloat16 (4 words, so that the 8 rows of
// a fragment load start in 8 different groups of 4 banks).
__host__ __device__ inline int bf16_words(int k) { return (k + 15) / 16 * 8 + 4; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout of one block, in elements of T; each region is
// rounded up to 16 bytes.  H is the number of bfloat16 halves of the reduced
// modes (0 in 'highest').  smem_bytes in ops/shared_epoch.py mirrors it (and
// its test reads the region list below from this file).
constexpr int kRegions = 14;
struct Layout {
  int off[kRegions + 1];
  int MP, LDA2, LDK2;  // rows of V padded to 16; words per row of F's and S's halves
  __host__ __device__ Layout(int n, int m, int TB, int KS, int LDW, int size, int H) {
    const int N2 = n + 2 * m, nm = n + m;
    MP = (nm + 15) / 16 * 16;
    LDA2 = bf16_words(KS);
    LDK2 = bf16_words(N2);
    const int sizes[kRegions] = {
        imax(KS * LDW, H * MP * LDA2),  // W: F' k-major (resident or one slab), or F's
                                        // halves, then [P; A]' and A''
        N2 * TB,   // S = [x; z; y]
        nm * TB,   // V: [P; A] x, then [P; A] dx (check only)
        n * TB,    // T: A' y, then A' dy (check only)
        n * TB,    // dX
        m * TB,    // dY
        nm * TB,   // c0
        m * TB,    // L
        m * TB,    // U
        n * TB,    // Q
        m,         // rho
        m,         // 1 / rho
        16 * TB,   // per-column partial results of the check
        H * TB * LDK2,  // the state's bfloat16 halves, column-major
    };
    const int align = 16 / size;
    off[0] = 0;
    for (int i = 0; i < kRegions; ++i) off[i + 1] = off[i] + (sizes[i] + align - 1) / align * align;
  }
  __host__ __device__ int total() const { return off[kRegions]; }
};

// Vector loads and stores of 1, 2 or 4 consecutive elements (16-byte aligned
// for 4 floats or 2 doubles).
__device__ __forceinline__ void ld(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void ld(const float* p, float (&o)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  o[0] = t.x; o[1] = t.y;
}
__device__ __forceinline__ void ld(const float* p, float (&o)[1]) { o[0] = *p; }
__device__ __forceinline__ void ld(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void ld(const double* p, double (&o)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  o[0] = t.x; o[1] = t.y;
}
__device__ __forceinline__ void ld(const double* p, double (&o)[1]) { o[0] = *p; }
__device__ __forceinline__ void st(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void st(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void st(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st(double* p, const double (&v)[1]) { *p = v[0]; }

// Asynchronous copy of one element from global to shared memory (cp.async):
// a thread issues any number of them and waits once, so all of a phase's
// loads cross memory together.  With `valid` false it reads nothing and
// writes a zero.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A walk over the (rows, cols) index grid in steps of blockDim.x from this
// thread's first index, without a division per step.
struct GridWalk {
  int row, col, drow, dcol, cols;
  __device__ GridWalk(int cols_)
      : row(threadIdx.x / cols_), col(threadIdx.x % cols_), drow(blockDim.x / cols_),
        dcol(blockDim.x % cols_), cols(cols_) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// sW[k, r] = W[r, k0 + k] for k < ks and r < 4 ceil(R/4) (zero past R): W is
// (R, Kd) row-major in global memory.  Consecutive threads take consecutive
// k, so the global reads are coalesced; each writes 4-row chunks, two at a
// time with their 8 loads in flight.  Used for the slabs of F, every
// iteration.
template <typename T>
__device__ void stage(const T* __restrict__ W, int R, int Kd, int k0, int ks, T* sW,
                      int LDW) {
  const int G = (R + 3) / 4;
  GridWalk p(ks);
  while (p.row < G) {
    GridWalk q = p;
    q.next();
    T w[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = 4 * p.row + j, r1 = 4 * q.row + j;
      w[0][j] = r0 < R ? __ldg(W + (size_t)r0 * Kd + k0 + p.col) : T(0);
      w[1][j] = r1 < R ? __ldg(W + (size_t)r1 * Kd + k0 + q.col) : T(0);
    }
    st(sW + p.col * LDW + 4 * p.row, w[0]);
    if (q.row < G) st(sW + q.col * LDW + 4 * q.row, w[1]);
    p = q;
    p.next();
  }
}

// The same staging of all of W (k0 = 0, ks = Kd) by asynchronous element
// copies: for matrices staged once per epoch, whose loads then travel with
// the tiles'.  Complete after cp_async_wait and a barrier.
template <typename T>
__device__ void stage_async(const T* __restrict__ W, int R, int Kd, T* sW, int LDW) {
  const int R4 = (R + 3) / 4 * 4;
  for (GridWalk p(Kd); p.row < R4; p.next()) {
    const bool ok = p.row < R;
    cp_async(sW + p.col * LDW + p.row, ok ? W + (size_t)p.row * Kd + p.col : W, ok);
  }
}

// acc[i][j] = sum_k W[4g + i, k] In[k, TC tc + j]: W (R, Kd) in global
// memory, passed through sW in slabs of KS rows of k (or, given `staged`,
// already all in sW); In a shared tile of row stride TB.  Threads whose rows
// start at or past R compute nothing.  Every thread of the block calls it.
template <typename T, int TC>
__device__ void tile_product(const T* __restrict__ W, int R, int Kd, const T* In, int TB,
                             T* sW, int KS, int LDW, bool staged, int g, int tc,
                             T (&acc)[4][TC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = T(0);
  const bool mine = 4 * g < R;
  for (int k0 = 0; k0 < Kd; k0 += KS) {
    const int ks = min(KS, Kd - k0);
    if (!staged) {
      __syncthreads();  // the previous slab (or user of sW) is done
      stage(W, R, Kd, k0, ks, sW, LDW);
      __syncthreads();
    }
    if (!mine) continue;
    const T* w_p = sW + 4 * g;
    const T* s_p = In + (size_t)k0 * TB + TC * tc;
#pragma unroll 4
    for (int k = 0; k < ks; ++k) {
      T w[4], s[TC];
      ld(w_p + k * LDW, w);
      ld(s_p + k * TB, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] += w[i] * s[j];
    }
  }
}

// Out[r, c] = acc for the thread's rows r < R, into a tile of row stride TB.
template <typename T, int TC>
__device__ void store_acc(const T (&acc)[4][TC], T* Out, int R, int TB, int g, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * g + i;
    if (r >= R) break;
#pragma unroll
    for (int j = 0; j < TC; ++j) Out[r * TB + TC * tc + j] = acc[i][j];
  }
}

// log2 of a power of two (TB is one), so that tile walks shift and mask
// rather than divide.
__device__ __forceinline__ int log2i(int p) { return __ffs(p) - 1; }

// ---- the reduced modes' tensor-core product (float32 only) ----

constexpr int kMaxTiles = 4;  // 16 x 8 tiles of V per warp at most (_MAX_TILES)

// The bfloat16 halves of x, as raw bits: hi = bf16(x), lo = bf16(x - hi),
// both rounded to nearest even (x - hi is exact in fp32).
__device__ __forceinline__ void split_bf16(float x, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h))));
}

// sF[r, k] = halves of W[r, k0 + k] for r < MP and k < ksp (zero past R rows
// and ks columns): W is (R, Kd) row-major fp32 in global memory; the hi half
// is row-major with LDA2 words per row, the lo half (H = 2) follows it.  A
// word is two k; consecutive threads take consecutive words, and each
// thread has the 8 loads of its next 4 words in flight before it splits
// them.  Used for the slabs of F, every iteration.
template <int H>
__device__ void stage_split(const float* __restrict__ W, int R, int Kd, int k0, int ks,
                            int ksp, int MP, unsigned* sF, int LDA2) {
  constexpr int kWords = 4;
  unsigned* sF_lo = sF + MP * LDA2;
  const int words = ksp / 2, total = MP * words;
  for (int i0 = threadIdx.x; i0 < total; i0 += kWords * blockDim.x) {
    float v[kWords][2];
    int at[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int i = i0 + u * blockDim.x, r = i / words, w = i - r * words, k = 2 * w;
      at[u] = i < total ? r * LDA2 + w : -1;
      const bool row_ok = i < total && r < R;
      const float* p = W + (size_t)r * Kd + k0 + k;
      v[u][0] = row_ok && k < ks ? __ldg(p) : 0.f;
      v[u][1] = row_ok && k + 1 < ks ? __ldg(p + 1) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      if (at[u] < 0) continue;
      unsigned h0, l0, h1, l1;
      split_bf16(v[u][0], h0, l0);
      split_bf16(v[u][1], h1, l1);
      sF[at[u]] = h0 | (h1 << 16);
      if (H == 2) sF_lo[at[u]] = l0 | (l1 << 16);
    }
  }
}

// The state's halves, column-major: sSb[c, k] = halves of sS[k, c] for k < KP
// (zero past N2), LDK2 words per column; the lo half (H = 2) follows.
template <int H>
__device__ void split_state(const float* sS, int N2, int KP, int TB, unsigned* sSb, int LDK2) {
  unsigned* sSb_lo = sSb + TB * LDK2;
  const int sh = log2i(TB);
  for (int i = threadIdx.x; i < (KP / 2) * TB; i += blockDim.x) {
    const int c = i & (TB - 1), w = i >> sh, k = 2 * w;
    const float v0 = k < N2 ? sS[k * TB + c] : 0.f;
    const float v1 = k + 1 < N2 ? sS[(k + 1) * TB + c] : 0.f;
    unsigned h0, l0, h1, l1;
    split_bf16(v0, h0, l0);
    split_bf16(v1, h1, l1);
    sSb[c * LDK2 + w] = h0 | (h1 << 16);
    if (H == 2) sSb_lo[c * LDK2 + w] = l0 | (l1 << 16);
  }
}

// d += a b on the tensor cores: a 16 x 16 bfloat16 tile (row-major), b 16 x 8
// (column-major), d 16 x 8 fp32, in the fragment layouts of the PTX ISA.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: p at word (row r0 + gid, k word w0 + tig) of a row-major
// matrix of LDA2 words per row; rows +8 and k +8 (4 words) complete it.
__device__ __forceinline__ void ld_a(const unsigned* p, int LDA2, unsigned (&a)[4]) {
  a[0] = p[0];
  a[1] = p[8 * LDA2];
  a[2] = p[4];
  a[3] = p[8 * LDA2 + 4];
}
// B fragment: p at word (column gid, k word w0 + tig) of a column-major matrix.
__device__ __forceinline__ void ld_b(const unsigned* p, unsigned (&b)[2]) {
  b[0] = p[0];
  b[1] = p[4];
}

// The iteration product of the reduced modes for the warp's tiles of V
// (tile warp + j * warps, j < kMaxTiles; 16 rows by 8 columns each):
// hh[j] = F_hi S_hi and, for H = 2, cx[j] = F_hi S_lo + F_lo S_hi, in fp32.
// F is resident in sF (staged once per epoch) or streamed through it in
// slabs of KS columns of k (a multiple of 16).  Every thread of the block
// calls it (the slabs are staged by all); only whole warps exist.
template <int H>
__device__ void mma_product(const float* __restrict__ F, int nm, int N2, int MP, int KS,
                            bool resident, unsigned* sF, int LDA2, const unsigned* sSb,
                            int LDK2, int TB, float (&hh)[kMaxTiles][4],
                            float (&cx)[kMaxTiles][4]) {
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) hh[j][i] = cx[j][i] = 0.f;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int sh = log2i(TB / 8), tiles = (MP / 16) << sh;
  const unsigned* sSb_lo = sSb + TB * LDK2;
  const unsigned* sF_lo = sF + MP * LDA2;
  for (int k0 = 0; k0 < N2; k0 += KS) {
    const int ks = min(KS, N2 - k0), kw_end = (ks + 15) / 16 * 8;
    if (!resident) {
      __syncthreads();  // the previous slab is done
      stage_split<H>(F, nm, N2, k0, ks, 2 * kw_end, MP, sF, LDA2);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + j * warps;
      if (t >= tiles) continue;
      const int mt = t >> sh, nt = t & ((1 << sh) - 1);
      const int a_off = (mt * 16 + gid) * LDA2 + tig;
      const int b_off = (nt * 8 + gid) * LDK2 + k0 / 2 + tig;
      for (int kw = 0; kw < kw_end; kw += 8) {
        unsigned a[4], b[2];
        ld_a(sF + a_off + kw, LDA2, a);
        ld_b(sSb + b_off + kw, b);
        mma_bf16(hh[j], a, b);
        if (H == 2) {
          unsigned a_lo[4], b_lo[2];
          ld_a(sF_lo + a_off + kw, LDA2, a_lo);
          ld_b(sSb_lo + b_off + kw, b_lo);
          mma_bf16(cx[j], a, b_lo);
          mma_bf16(cx[j], a_lo, b);
        }
      }
    }
  }
}

// Start copying rows [0, rows) of a (rows, B) global array into a shared
// tile, zero past the ragged edge; given `flag`, only the valid columns
// whose flag is 0.  Complete after cp_async_wait and a barrier.
template <typename T>
__device__ void load_tile(const T* __restrict__ G, int rows, int B, int col0,
                          int ncol, T* sm, int TB, const int* flag) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i >> log2i(TB), c = i & (TB - 1);
    if (flag != nullptr && (c >= ncol || flag[c])) continue;
    cp_async(sm + i, c < ncol ? G + (size_t)f * B + col0 + c : G, c < ncol);
  }
}

template <typename T>
__device__ void store_tile(T* __restrict__ G, int rows, int B, int col0,
                           int ncol, const T* sm, int TB) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i >> log2i(TB), c = i & (TB - 1);
    if (c < ncol) G[(size_t)f * B + col0 + c] = sm[i];
  }
}

// out = in over the block's columns, global to global; each thread issues
// kBatch loads before it stores any, so they cross memory together.
constexpr int kBatch = 8;
template <typename T>
__device__ void copy_cols(T* __restrict__ out, const T* __restrict__ in, int rows, int B,
                          int col0, int ncol, int TB) {
  const int N = rows * TB, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < N; i0 += kBatch * step) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step, f = i >> log2i(TB), c = i & (TB - 1);
      if (i < N && c < ncol) v[u] = in[(size_t)f * B + col0 + c];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * step, f = i >> log2i(TB), c = i & (TB - 1);
      if (i < N && c < ncol) out[(size_t)f * B + col0 + c] = v[u];
    }
  }
}

// Capture: out = sm for the newly terminated columns (the others already
// hold their input values, from copy_cols).
template <typename T>
__device__ void capture_tile(T* __restrict__ G, int rows, int B, int col0, int ncol,
                             const T* sm, int TB, const int* newly) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i >> log2i(TB), c = i & (TB - 1);
    if (c < ncol && newly[c]) G[(size_t)f * B + col0 + c] = sm[i];
  }
}

// H: the bfloat16 halves of the iteration product (0: 'highest', exact in
// T; 1: 'default'; 2: 'high'; float32 only).
template <typename T, int TC, int H>
__global__ void __launch_bounds__(kMaxThreads, 1)
shared_epoch_kernel(int n, int m, int B, int TB, int KS, Scalars<T> sc, Args<T> a) {
  static_assert(H == 0 || std::is_same<T, float>::value, "reduced modes are float32 only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_active[32];
  __shared__ int s_newly[32];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nm = n + m, N2 = n + 2 * m;
  const int LDW = w_stride(nm, sizeof(T));
  const Layout lay(n, m, TB, KS, LDW, sizeof(T), H);
  T* sW = sm + lay.off[0];
  T* sS = sm + lay.off[1];
  T* sV = sm + lay.off[2];
  T* sT = sm + lay.off[3];
  T* sdX = sm + lay.off[4];
  T* sdY = sm + lay.off[5];
  T* sC0 = sm + lay.off[6];
  T* sL = sm + lay.off[7];
  T* sU = sm + lay.off[8];
  T* sQ = sm + lay.off[9];
  T* sRho = sm + lay.off[10];
  T* sRhoinv = sm + lay.off[11];
  T* sRed = sm + lay.off[12];
  const int col0 = blockIdx.x * TB;
  const int ncol = min(TB, B - col0);
  const int tid = threadIdx.x;
  const int tc = tid % (TB / TC), g = tid / (TB / TC);
  const bool resident = KS >= N2;

  // ---- 0. the block's tiles into shared memory, all loads in flight at once ----
  int my_active = 0;
  if (tid < TB) {
    my_active = tid < ncol && a.status[col0 + tid] == kUnsolved;
    s_active[tid] = my_active;
  }
  const int* all = nullptr;
  load_tile(a.S, N2, B, col0, ncol, sS, TB, all);
  load_tile(a.dX, n, B, col0, ncol, sdX, TB, all);
  load_tile(a.dY, m, B, col0, ncol, sdY, TB, all);
  load_tile(a.c0, nm, B, col0, ncol, sC0, TB, all);
  load_tile(a.L, m, B, col0, ncol, sL, TB, all);
  load_tile(a.U, m, B, col0, ncol, sU, TB, all);
  load_tile(a.Q, n, B, col0, ncol, sQ, TB, all);
  for (int j = tid; j < m; j += blockDim.x) {
    cp_async(sRho + j, a.rho + j, true);
    cp_async(sRhoinv + j, a.rhoinv + j, true);
  }
  // the captured state starts as the input's; newly terminated columns are
  // overwritten at the end
  copy_cols(a.fSo, a.fS, N2, B, col0, ncol, TB);
  copy_cols(a.fdXo, a.fdX, n, B, col0, ncol, TB);
  copy_cols(a.fdYo, a.fdY, m, B, col0, ncol, TB);
  if (resident) {
    if constexpr (H == 0)
      stage_async(a.F, nm, N2, sW, LDW);
    else  // F's bfloat16 halves, once for the epoch
      stage_split<H>(a.F, nm, N2, 0, N2, (N2 + 15) / 16 * 16, lay.MP,
                     reinterpret_cast<unsigned*>(sW), lay.LDA2);
  }
  cp_async_wait();
  const int any_active = __syncthreads_or(my_active);

  // ---- 1. K ADMM iterations (affine form) ----
  if constexpr (H != 0) {
    if (any_active) {
      const float alpha = sc.alpha;
      const float one_m_alpha = 1.f - alpha;
      unsigned* sF = reinterpret_cast<unsigned*>(sW);
      unsigned* sSb = reinterpret_cast<unsigned*>(sm + lay.off[13]);
      const int KP = (N2 + 15) / 16 * 16;
      const int warp = tid >> 5, warps = blockDim.x >> 5, lane = tid & 31;
      const int gid = lane >> 2, tig = lane & 3;
      const int sh = log2i(TB / 8), tiles = (lay.MP / 16) << sh;
      for (int it = 0; it < sc.K; ++it) {
        split_state<H>(sS, N2, KP, TB, sSb, lay.LDK2);
        __syncthreads();
        float hh[kMaxTiles][4], cx[kMaxTiles][4];
        mma_product<H>(a.F, nm, N2, lay.MP, KS, resident, sF, lay.LDA2, sSb, lay.LDK2, TB,
                       hh, cx);
        // each thread updates the elements of its accumulator fragments (rows
        // gid and gid + 8, columns 2 tig and 2 tig + 1 of each tile); the
        // product read only the halves, so sS is free to write
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          const int t = warp + j * warps;
          if (t >= tiles) continue;
          const int mt = t >> sh, nt = t & ((1 << sh) - 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + gid + 8 * (e >> 1), col = nt * 8 + 2 * tig + (e & 1);
            if (r >= nm) continue;
            const float p = H == 2 ? add_rn(hh[j][e], cx[j][e]) : hh[j][e];
            const float v = add_rn(p, sC0[r * TB + col]);
            if (r < n) {
              const float x = sS[r * TB + col];
              const float xn = add_rn(mul_rn(alpha, v), mul_rn(one_m_alpha, x));
              sS[r * TB + col] = xn;
              sdX[r * TB + col] = sub_rn(xn, x);
            } else {
              const int jr = r - n, oj = jr * TB + col, oy = (nm + jr) * TB + col;
              const float rho = sRho[jr], rhoinv = sRhoinv[jr], y = sS[oy];
              const float zn = nmin(nmax(v, sL[oj]), sU[oj]);
              const float yn = add_rn(y, mul_rn(rho, sub_rn(sub_rn(v, mul_rn(rhoinv, y)), zn)));
              sS[r * TB + col] = zn;
              sS[oy] = yn;
              sdY[oj] = sub_rn(yn, y);
            }
          }
        }
        __syncthreads();
      }
    }
  } else if (any_active) {
    const T alpha = sc.alpha;
    const T one_m_alpha = T(1) - alpha;
    for (int it = 0; it < sc.K; ++it) {
      T acc[4][TC];
      tile_product<T, TC>(a.F, nm, N2, sS, TB, sW, KS, LDW, resident, g, tc, acc);
      __syncthreads();  // every read of S is done; the owners update it
      // each owner updates its 4 rows, TC columns at a time with vector
      // accesses; the columns past the ragged edge hold zeros and stay so
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * g + i;
        if (r >= nm) break;
        const int o = r * TB + TC * tc;
        T c0v[TC];
        ld(sC0 + o, c0v);
        if (r < n) {
          T x[TC], xn[TC], dx[TC];
          ld(sS + o, x);
#pragma unroll
          for (int jc = 0; jc < TC; ++jc) {
            const T v = add_rn(acc[i][jc], c0v[jc]);
            xn[jc] = add_rn(mul_rn(alpha, v), mul_rn(one_m_alpha, x[jc]));
            dx[jc] = sub_rn(xn[jc], x[jc]);
          }
          st(sS + o, xn);
          st(sdX + o, dx);
        } else {
          const int j = r - n, oj = j * TB + TC * tc, oy = (nm + j) * TB + TC * tc;
          const T rho = sRho[j], rhoinv = sRhoinv[j];
          T l[TC], u[TC], y[TC], zn[TC], yn[TC], dy[TC];
          ld(sL + oj, l);
          ld(sU + oj, u);
          ld(sS + oy, y);
#pragma unroll
          for (int jc = 0; jc < TC; ++jc) {
            const T v = add_rn(acc[i][jc], c0v[jc]);
            zn[jc] = nmin(nmax(v, l[jc]), u[jc]);
            yn[jc] = add_rn(y[jc], mul_rn(rho, sub_rn(sub_rn(v, mul_rn(rhoinv, y[jc])), zn[jc])));
            dy[jc] = sub_rn(yn[jc], y[jc]);
          }
          st(sS + o, zn);
          st(sS + oy, yn);
          st(sdY + oj, dy);
        }
      }
      __syncthreads();
    }
  }

  // ---- 2. merge: terminated columns take their input state back ----
  load_tile(a.S, N2, B, col0, ncol, sS, TB, s_active);
  load_tile(a.dX, n, B, col0, ncol, sdX, TB, s_active);
  load_tile(a.dY, m, B, col0, ncol, sdY, TB, s_active);

  // ---- 3. termination check ----
  // [P; A]' and A'' pass through sW: both at once, for all four products,
  // where they fit (n + m <= KS, always so when F is resident); otherwise
  // each product streams its own slabs.
  const bool check_staged = n + m <= KS;
  T* sCH = sW;
  T* sAt = check_staged ? sW + n * LDW : sW;
  if (check_staged) {  // sW is free: the iterations ended at a barrier
    stage_async(a.CH, nm, n, sCH, LDW);
    stage_async(a.At, n, m, sAt, LDW);
  }
  cp_async_wait();  // the merge
  if (check_staged) __syncthreads();  // (streamed products begin at one)
  {
    T acc[4][TC];
    tile_product<T, TC>(a.CH, nm, n, sS, TB, sCH, KS, LDW, check_staged, g, tc, acc);  // [P x; A x]
    store_acc<T, TC>(acc, sV, nm, TB, g, tc);
    tile_product<T, TC>(a.At, n, m, sS + nm * TB, TB, sAt, KS, LDW, check_staged, g, tc, acc);  // A' y
    store_acc<T, TC>(acc, sT, n, TB, g, tc);
  }
  __syncthreads();

  // The column reductions, split into independent tasks (one thread per
  // task and column), each summing in feature order; their results meet in
  // sRed (slot s of column c at sRed[s * TB + c]) and one thread per column
  // combines them.
  const T eps = Limits<T>::eps();
  const T loose = T(1e30 * 1e-4);
  const T infty = T(1e30);
  const bool unscaled = sc.unscaled != 0;
  const T cinv = sc.cinv;
  const T* X = sS;
  const T* Z = sS + n * TB;
  const T* Y = sS + nm * TB;
  const T* PX = sV;
  const T* AX = sV + n * TB;
  for (int t = tid; t < 3 * TB; t += blockDim.x) {
    const int task = t >> log2i(TB), c = t & (TB - 1);
    if (c >= ncol) continue;
    T* red = sRed + c;
    if (task == 0) {
      T dmax = 0, quad2 = 0, qx = 0, xx = 0, atym = 0, pxm = 0, qm = 0;
      for (int i = 0; i < n; ++i) {
        const T x = X[i * TB + c], px = PX[i * TB + c], aty = sT[i * TB + c];
        const T q = sQ[i * TB + c];
        const T dinv = __ldg(a.Dinv + i);
        const T dv = px + q + aty;
        dmax = nmax(dmax, absv(unscaled ? dinv * dv : dv));
        quad2 += x * px;
        qx += q * x;
        xx += x * x;
        atym = nmax(atym, absv(unscaled ? dinv * aty : aty));
        pxm = nmax(pxm, absv(unscaled ? dinv * px : px));
        qm = nmax(qm, absv(unscaled ? dinv * q : q));
      }
      red[0] = dmax; red[TB] = quad2; red[2 * TB] = qx; red[3 * TB] = xx;
      red[4 * TB] = atym; red[5 * TB] = pxm; red[6 * TB] = qm;
    } else if (task == 1) {
      T ymax = 0;
      for (int j = 0; j < m; ++j) {
        ymax = nmax(ymax, absv(cinv * (__ldg(a.E + j) * Y[j * TB + c])));
      }
      const T y_tol = eps * ymax;
      T sum_p = 0, sum_n = 0, mag_p = 0, mag_n = 0;
      for (int j = 0; j < m; ++j) {
        const T einv = __ldg(a.Einv + j);
        T yu = cinv * (__ldg(a.E + j) * Y[j * TB + c]);
        yu = absv(yu) > y_tol ? yu : T(0);
        const T lu = einv * sL[j * TB + c], uu = einv * sU[j * TB + c];
        const T sp = uu < loose ? uu * nmax(yu, T(0)) : T(0);
        const T sn = lu > -loose ? lu * nmin(yu, T(0)) : T(0);
        sum_p += sp;
        sum_n += sn;
        mag_p += absv(sp);
        mag_n += absv(sn);
      }
      red[7 * TB] = sum_p; red[8 * TB] = sum_n; red[9 * TB] = mag_p; red[10 * TB] = mag_n;
    } else {
      T pmax = 0, axm = 0, zm = 0;
      for (int j = 0; j < m; ++j) {
        const T einv = __ldg(a.Einv + j);
        const T ax = AX[j * TB + c], z = Z[j * TB + c];
        const T pv = ax - z;
        pmax = nmax(pmax, absv(unscaled ? einv * pv : pv));
        axm = nmax(axm, absv(unscaled ? einv * ax : ax));
        zm = nmax(zm, absv(unscaled ? einv * z : z));
      }
      red[11 * TB] = pmax; red[12 * TB] = axm; red[13 * TB] = zm;
    }
  }
  __syncthreads();

  const int c = tid;
  const int col = col0 + c;
  T pri = 0, dua = 0, obj = 0, dobj = 0, gap_noise = 0;
  bool pri_check = false, dua_check = false, noncvx = false;
  if (c < ncol) {
    const T* red = sRed + c;
    const T dmax = red[0], quad2 = red[TB], qx = red[2 * TB], xx = red[3 * TB];
    const T atym = red[4 * TB], pxm = red[5 * TB], qm = red[6 * TB];
    const T sum_p = red[7 * TB], sum_n = red[8 * TB], mag_p = red[9 * TB], mag_n = red[10 * TB];
    const T pmax = red[11 * TB], axm = red[12 * TB], zm = red[13 * TB];
    dua = unscaled ? cinv * dmax : dmax;
    const T quad = T(0.5) * quad2;
    obj = (quad + qx) * cinv;
    pri = pmax;
    const bool noncvx_neg = (quad * cinv) < (T(-1e-12) * nmax(T(1), xx));
    if (noncvx_neg) pri = T(2e30);
    const T sup = sum_p + sum_n;
    const T sup_mag = mag_p + mag_n;
    dobj = -quad * cinv - sup;
    gap_noise = eps * (sup_mag + absv(quad * cinv) + absv(qx) * cinv);

    const T eps_pri = sc.eps_abs + sc.eps_rel * nmax(axm, zm);
    const T scale_d = unscaled ? cinv : T(1);
    const T eps_dua = sc.eps_abs + sc.eps_rel * scale_d * nmax(nmax(atym, pxm), qm);
    noncvx = (pri > infty) || (dua > infty);
    pri_check = pri < eps_pri;
    dua_check = dua < eps_dua;
  }

  {
    // V, T and sRed are free: the column loops ended at the barrier above,
    // and the products below begin or end at one before sRed is reused
    T acc[4][TC];
    tile_product<T, TC>(a.CH, nm, n, sdX, TB, sCH, KS, LDW, check_staged, g, tc, acc);  // [P dx; A dx]
    store_acc<T, TC>(acc, sV, nm, TB, g, tc);
    tile_product<T, TC>(a.At, n, m, sdY, TB, sAt, KS, LDW, check_staged, g, tc, acc);  // A' dy
    store_acc<T, TC>(acc, sT, n, TB, g, tc);
  }
  __syncthreads();

  for (int t = tid; t < 4 * TB; t += blockDim.x) {
    const int task = t >> log2i(TB), c = t & (TB - 1);
    if (c >= ncol) continue;
    T* red = sRed + c;
    if (task == 0) {  // primal infeasibility: ||dy|| and u'dy+ + l'dy-
      T ndy = 0, lhs = 0;
      for (int j = 0; j < m; ++j) {
        const T dy = sdY[j * TB + c];
        ndy = nmax(ndy, absv(unscaled ? __ldg(a.E + j) * dy : dy));
        lhs += sU[j * TB + c] * nmax(dy, T(0)) + sL[j * TB + c] * nmin(dy, T(0));
      }
      red[0] = ndy; red[TB] = lhs;
    } else if (task == 1) {  // ||A' dy||
      T atdy = 0;
      for (int i = 0; i < n; ++i) {
        const T v = sT[i * TB + c];
        atdy = nmax(atdy, absv(unscaled ? __ldg(a.Dinv + i) * v : v));
      }
      red[2 * TB] = atdy;
    } else if (task == 2) {  // dual infeasibility: ||dx||, q'dx, ||P dx||
      T ndx = 0, qdx = 0, pdx = 0;
      for (int i = 0; i < n; ++i) {
        const T dx = sdX[i * TB + c], v = sV[i * TB + c];
        ndx = nmax(ndx, absv(unscaled ? __ldg(a.D + i) * dx : dx));
        qdx += sQ[i * TB + c] * dx;
        pdx = nmax(pdx, absv(unscaled ? __ldg(a.Dinv + i) * v : v));
      }
      red[3 * TB] = ndx; red[4 * TB] = qdx; red[5 * TB] = pdx;
    } else {
      // the largest A dx over finite upper bounds and the smallest over
      // finite lower bounds, NaN entries skipped: "some entry crosses the
      // bound" exactly as an entry-by-entry test
      T hi = T(-INFINITY), lo = T(INFINITY);
      for (int j = 0; j < m; ++j) {
        T adx = sV[(n + j) * TB + c];
        if (unscaled) adx = __ldg(a.Einv + j) * adx;
        if (sU[j * TB + c] < loose) hi = fmax(hi, adx);
        if (sL[j * TB + c] > -loose) lo = fmin(lo, adx);
      }
      red[6 * TB] = hi; red[7 * TB] = lo;
    }
  }
  __syncthreads();

  if (c < ncol) {
    const T* red = sRed + c;
    const T ndy = red[0], lhs = red[TB], atdy = red[2 * TB];
    const T ndx = red[3 * TB], qdx = red[4 * TB], pdx = red[5 * TB];
    const T hi = red[6 * TB], lo = red[7 * TB];
    const T ep = sc.eps_pinf;
    const bool pinf = (ndy > ep) && (lhs < -ep * ndy) && (atdy < ep * ndy) && !pri_check;

    const T ed = sc.eps_dinf;
    const T cost_scale = unscaled ? sc.c : T(1);
    bool dinf = (ndx > ed) && (qdx < -cost_scale * ed * ndx) && (pdx < cost_scale * ed * ndx);
    const bool bad = (hi > ed * ndx) || (lo < -ed * ndx);
    dinf = dinf && !bad && !dua_check;

    const T gap = obj - dobj;
    const T eps_gap = sc.eps_abs + sc.eps_rel * nmax(absv(obj), absv(dobj)) + T(10) * gap_noise;
    const bool gap_ok = !sc.check_dualgap || (absv(gap) <= Limits<T>::max() && absv(gap) < eps_gap);

    const int cand = noncvx ? kNonCvx
                   : (pri_check && dua_check && gap_ok) ? kSolved
                   : pinf ? kPinf
                   : dinf ? kDinf
                   : kUnsolved;
    if (cand == kNonCvx) obj = T(NAN);
    else if (cand == kPinf) obj = infty;
    else if (cand == kDinf) obj = -infty;

    const int newly = s_active[c] && cand != kUnsolved;
    s_newly[c] = newly;
    a.status_o[col] = newly ? cand : a.status[col];
    a.pri_o[col] = pri;
    a.dua_o[col] = dua;
    a.obj_o[col] = obj;
    a.dobj_o[col] = dobj;
  }
  __syncthreads();

  // ---- 4. state out and capture of newly terminated columns ----
  store_tile(a.So, N2, B, col0, ncol, sS, TB);
  store_tile(a.dXo, n, B, col0, ncol, sdX, TB);
  store_tile(a.dYo, m, B, col0, ncol, sdY, TB);
  capture_tile(a.fSo, N2, B, col0, ncol, sS, TB, s_newly);
  capture_tile(a.fdXo, n, B, col0, ncol, sdX, TB, s_newly);
  capture_tile(a.fdYo, m, B, col0, ncol, sdY, TB, s_newly);
}

template <typename T, int TC, int H>
cudaError_t start(int n, int m, int B, int TB, int KS, int threads, size_t smem,
                  const Scalars<T>& sc, const Args<T>& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(shared_epoch_kernel<T, TC, H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (B + TB - 1) / TB;
  shared_epoch_kernel<T, TC, H><<<grid, threads, smem, stream>>>(n, m, B, TB, KS, sc, a);
  return cudaGetLastError();
}

template <typename T>
int launch(int n, int m, int B, int TB, int TC, int KS, int H, int K, int unscaled,
           int check_dualgap, const void* scal, void* const* p, void* stream) {
  if (B == 0) return cudaSuccess;
  // the plan must be one this source can run
  const int nm = n + m, N2 = n + 2 * m;
  int threads = (nm + 3) / 4 * (TB / max(TC, 1));
  if (H != 0) threads = (threads + 31) / 32 * 32;  // whole warps for the mma tiles
  if (TB < 1 || TB > 32 || (TB & (TB - 1)) != 0 || (TC != 1 && TC != 2) || TC > TB ||
      KS < 1 || KS > N2 || threads < TB || threads > kMaxThreads || H < 0 || H > 2)
    return cudaErrorInvalidValue;
  if (H != 0) {  // float32, 8-column tiles, slabs of whole k tiles, kMaxTiles per warp
    const int tiles = (nm + 15) / 16 * (TB / 8), warps = threads / 32;
    if (!std::is_same<T, float>::value || TB < 8 || (KS < N2 && KS % 16 != 0) ||
        (tiles + warps - 1) / warps > kMaxTiles)
      return cudaErrorInvalidValue;
  }
  const size_t smem =
      (size_t)Layout(n, m, TB, KS, w_stride(nm, sizeof(T)), sizeof(T), H).total() * sizeof(T);
  const T* s = static_cast<const T*>(scal);
  Scalars<T> sc{s[0], s[1], s[2], s[3], s[4], s[5], s[6], K, unscaled, check_dualgap};
  Args<T> a;
  const T** in[] = {&a.F, &a.CH, &a.At, &a.rho, &a.rhoinv, &a.D, &a.Dinv, &a.E,
                    &a.Einv, &a.c0, &a.Q, &a.L, &a.U, &a.S, &a.dX, &a.dY,
                    &a.fS, &a.fdX, &a.fdY};
  int k = 0;
  for (const T** q : in) *q = static_cast<const T*>(p[k++]);
  a.status = static_cast<const int*>(p[k++]);
  T** out[] = {&a.So, &a.dXo, &a.dYo, &a.fSo, &a.fdXo, &a.fdYo};
  for (T** q : out) *q = static_cast<T*>(p[k++]);
  a.status_o = static_cast<int*>(p[k++]);
  T** rows[] = {&a.pri_o, &a.dua_o, &a.obj_o, &a.dobj_o};
  for (T** q : rows) *q = static_cast<T*>(p[k++]);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    if (H == 1)
      return TC == 1 ? start<T, 1, 1>(n, m, B, TB, KS, threads, smem, sc, a, st)
                     : start<T, 2, 1>(n, m, B, TB, KS, threads, smem, sc, a, st);
    if (H == 2)
      return TC == 1 ? start<T, 1, 2>(n, m, B, TB, KS, threads, smem, sc, a, st)
                     : start<T, 2, 2>(n, m, B, TB, KS, threads, smem, sc, a, st);
  }
  if (TC == 1) return start<T, 1, 0>(n, m, B, TB, KS, threads, smem, sc, a, st);
  return start<T, 2, 0>(n, m, B, TB, KS, threads, smem, sc, a, st);
}

}  // namespace

// C entry points.  The plan (TB batch columns per block, TC columns per
// thread, KS rows of F' staged at a time) comes from plan_tile in
// ops/shared_epoch.py; the launch takes the Layout's shared memory.  H is
// the iteration product's bfloat16 halves (0 'highest', 1 'default', 2
// 'high'; float32 only, else cudaErrorInvalidValue).  Pointer order: scal
// (host: alpha, eps_abs, eps_rel, eps_prim_inf, eps_dual_inf, c, cinv), then
// the 20 inputs F CH At rho_vec rho_inv D Dinv E Einv c0 Q L U S dX dY fS fdX
// fdY status, then the 11 outputs S dX dY fS fdX fdY status pri dua obj dobj,
// then the stream.  Returns the cudaError_t of the launch.
#define SHARED_EPOCH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(int n, int m, int B, int TB, int TC, int KS, int H, int K, \
                      int unscaled, int check_dualgap, const void* scal,        \
                      void* F, void* CH, void* At, void* rho, void* rhoinv,     \
                      void* D, void* Dinv, void* E, void* Einv, void* c0,       \
                      void* Q, void* L, void* U, void* S, void* dX, void* dY,   \
                      void* fS, void* fdX, void* fdY, void* status,             \
                      void* So, void* dXo, void* dYo, void* fSo, void* fdXo,    \
                      void* fdYo, void* status_o, void* pri, void* dua,         \
                      void* obj, void* dobj, void* stream) {                    \
    void* const p[] = {F, CH, At, rho, rhoinv, D, Dinv, E, Einv, c0, Q, L, U,   \
                       S, dX, dY, fS, fdX, fdY, status, So, dXo, dYo, fSo,      \
                       fdXo, fdYo, status_o, pri, dua, obj, dobj};              \
    return launch<T>(n, m, B, TB, TC, KS, H, K, unscaled, check_dualgap, scal,  \
                     p, stream);                                                \
  }

SHARED_EPOCH_ENTRY(shared_epoch_f32, float)
SHARED_EPOCH_ENTRY(shared_epoch_f64, double)
