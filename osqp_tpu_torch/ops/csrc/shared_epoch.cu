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
// shared_epoch_plain; the two compute the same function.  Three designs of
// the iterations share phases 2-4 (check_phase); plan_tile in
// ops/shared_epoch.py picks one.
//
// 'highest' (float32 and float64; shared_epoch_kernel, H = 0).  What bounds
// it: operations, about K * 2 (n+m)(n+2m) B flops for the iterations (2.1
// GFLOP at n=32, m=48, B=4096, K=25) against one read and one write of the
// state, a few MB.  One block per tile of TB batch columns (a power of two up
// to 32) keeps its slice of S, dX, dY, the epoch-constant tiles c0, L, U, Q
// and rho, 1/rho in shared memory, and F transposed (k-major, row stride LDW:
// 16 bytes past a multiple of 128, so that transposing stores and reads are
// free of bank conflicts), resident where it fits beside the tiles and
// streamed in slabs of KS rows of k otherwise (640 KB at n=128, m=192).  Each
// thread owns a 4 x TC micro-tile of V, sums k in order (at the headline the
// iterates equal the plain version's bit for bit on an H100) and, after a
// barrier, applies the clip and the x, z, y updates from its registers,
// rounding each product and sum on its own as the plain version's
// elementwise kernels do.  The tiles arrive by cp.async, all of a phase's
// copies in flight at once.
//
// 'high' and 'default', register-resident (float32; shared_epoch_kernel_wg).
// The product runs on the tensor cores in bfloat16 halves, X_hi = bf16(X),
// X_lo = bf16(X - X_hi) to nearest even: 'high' (H = 2) F_hi S_hi +
// (F_hi S_lo + F_lo S_hi), the two sums rounded once; 'default' (H = 1)
// F_hi S_hi; each product of bfloat16 values exact in fp32 and summed in fp32,
// as on the TPU's matrix unit.  What bounds it: latency per iteration.  Its
// bytes take 0.00513 ms at the headline (B=4096, n=32, m=48: one read and
// write of the state and the tiles) and its tensor work less, but each of the
// K iterations needs the one before, so an epoch costs K times the latency of
// one product and its epilogue.  The design keeps that chain short:
//   - The product runs transposed, V' = S' F', so that batch columns are
//     wgmma's M: the first warpgroup of a block of 32 columns owns them
//     and all 8 (XC + YC) outputs (N; 80 at the headline), one column a
//     thread (rows gid of the warp's 16 rows of M).  A (the state's halves)
//     comes from registers, split from the fp32 state, which stays fp32,
//     before each product; B (F's halves, split once an epoch while staged)
//     from shared memory behind a matrix descriptor (K-major, no swizzle).
//     Every A fragment is built first, then one wgmma fence and all the
//     products, one commit and one wait.  'high' fills the padding rows
//     gid + 8 of M with S_lo and then S_hi against F_lo, so that hh and cx
//     share one accumulator (rows gid and gid + 8 of the same thread) in two
//     products a k step.
//   - The accumulator fragment of V' gives each thread the (column, feature)
//     pairs that the A fragment of the next product needs, so the state
//     lives in registers for the whole epoch and the epilogue runs on them.
//     The internal feature order (wg_orig; wg_positions in the Python
//     module) puts x_i at i, z_j at 8 XC + j and y_j at 8 (XC + YC) + j, so
//     that Pz_j, z_j and y_j sit in one thread, 8 YC apart; F's rows and
//     columns are permuted and zero-padded to it while staged.
//   - c0, L, U and rho, 1/rho stay in shared memory in the order each thread
//     reads them (vector loads, no bank conflicts), and no iteration but the
//     last stores anything, so the epilogue's loads run ahead of its
//     arithmetic.
//   - No block barrier in the loop: the warpgroup runs all K iterations with
//     wgmma's fence, commit and wait only; dX and dY come from the last.
//   - The tiles arrive by cp.async.bulk on an mbarrier where rows are 16-byte
//     aligned (B a multiple of 4), else by cp.async; the other threads copy
//     the captures while the first warpgroup iterates.  After the loop the
//     state goes back to shared memory in the (feature, column) layout and
//     the check runs as in 'highest', in fp32 on the CUDA cores; at K = 0
//     the outputs equal 'highest''s bit for bit.
// (XC, YC) are template parameters, instantiated (4, 6): n <= 32, m <= 48.
//
// 'high' and 'default' where that padding does not hold n and m (n > 32 or
// m > 48; at n=128, m=192, F's halves alone take 320-640 KB;
// shared_epoch_kernel, H > 0).  The streamed design: F's halves made while F is staged (once per
// epoch when resident, per slab and iteration otherwise), row-major with
// rows zero-padded to 16 and k to 16 (8 bfloat16 past a multiple of 16 a
// row, so each fragment load hits 32 banks); the state's halves rewritten
// from the fp32 state in every iteration, column-major; mma.sync m16n8k16
// bf16 tiles with fp32 accumulators, one warp per 16-row, 8-column tile of V
// (up to kMaxTiles of them), the epilogue per accumulator element with the
// rounding of the fp32 path, and two block barriers an iteration.
//
// The check is plain IEEE fp32 or fp64 on the CUDA cores in every mode; its
// products and sums may be contracted to FMA.  Its column reductions are
// split into independent tasks (a thread per task and column), each in
// feature order, and one thread per column combines them.  Tiles whose
// columns have all terminated skip the iterations.  The ragged batch edge is
// masked; nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
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

// ---- the streamed design's tensor-core product ('high', 'default') ----

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

// Rows of a (rows, B) float32 array whose block columns [col0, col0 + ncol)
// start and end on 16 bytes.
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* G, int B, int col0, int ncol) {
  return std::is_same<T, float>::value && (B | col0 | ncol) % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(G) & 15) == 0;
}

// out = in over the block's columns, global to global, by threads
// [first, first + count) of the block, each with kBatch loads in flight so
// that they cross memory together: an access of 16 bytes where both arrays'
// float32 rows are aligned, else of one element.
constexpr int kBatch = 8;
template <typename V, typename T>
__device__ void copy_cols_by(T* __restrict__ out, const T* __restrict__ in, int rows, int B,
                             int col0, int ncol, int first, int count) {
  constexpr int w = sizeof(V) / sizeof(T);
  const int per_row = ncol / w, N = rows * per_row;
  for (int i0 = threadIdx.x - first; i0 < N; i0 += kBatch * count) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * count, f = i / per_row, c = w * (i - f * per_row);
      if (i < N) v[u] = *reinterpret_cast<const V*>(in + (size_t)f * B + col0 + c);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * count, f = i / per_row, c = w * (i - f * per_row);
      if (i < N) *reinterpret_cast<V*>(out + (size_t)f * B + col0 + c) = v[u];
    }
  }
}
template <typename T>
__device__ void copy_cols(T* __restrict__ out, const T* __restrict__ in, int rows, int B,
                          int col0, int ncol, int first, int count) {
  if (rows_aligned(in, B, col0, ncol) && rows_aligned(out, B, col0, ncol))
    copy_cols_by<std::conditional_t<std::is_same<T, float>::value, float4, T>>(
        out, in, rows, B, col0, ncol, first, count);
  else
    copy_cols_by<T>(out, in, rows, B, col0, ncol, first, count);
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

// The shared-memory tiles of one block that the check reads and writes.
template <typename T> struct Tiles {
  T *W, *S, *V, *Tv, *dX, *dY, *L, *U, *Q, *Red;
};

// Phases 3 and 4 of the epoch, for every design: the termination check of
// the block's TB columns on the merged state in s.S, s.dX, s.dY, its
// results, the state out and the capture of newly terminated columns.
// [P; A]' and A'' pass through s.W (KS rows of F' deep, LDW apart).  Every
// thread of the block calls it, after the merge's copies were issued and
// the iterations' last use of s.W ended at a barrier; blockDim.x >= TB.
template <typename T, int TC>
__device__ __forceinline__ void check_phase(int n, int m, int B, int TB, int KS, int LDW,
                                            int col0, int ncol, const Scalars<T>& sc,
                                            const Args<T>& a, const Tiles<T>& s,
                                            const int* s_active, int* s_newly) {
  const int nm = n + m, N2 = n + 2 * m;
  const int tid = threadIdx.x;
  T* sW = s.W;
  T* sS = s.S;
  T* sV = s.V;
  T* sT = s.Tv;
  T* sdX = s.dX;
  T* sdY = s.dY;
  const T* sL = s.L;
  const T* sU = s.U;
  const T* sQ = s.Q;
  T* sRed = s.Red;

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
  // each thread takes the micro-tiles tid, tid + blockDim.x, ... (one in
  // the CUDA-core design, whose threads match its micro-tiles); a streamed
  // product is one pass of every thread, since all of them stage its slabs
  const int per = TB / TC;
  const int passes = check_staged ? ((nm + 3) / 4 * per + blockDim.x - 1) / blockDim.x : 1;
  for (int p = 0; p < passes; ++p) {
    const int u = tid + p * blockDim.x, g = u / per, tc = u % per;
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

  // V, T and sRed are free: the column loops ended at the barrier above,
  // and the products below begin or end at one before sRed is reused
  for (int p = 0; p < passes; ++p) {
    const int u = tid + p * blockDim.x, g = u / per, tc = u % per;
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
  copy_cols(a.fSo, a.fS, N2, B, col0, ncol, 0, (int)blockDim.x);
  copy_cols(a.fdXo, a.fdX, n, B, col0, ncol, 0, (int)blockDim.x);
  copy_cols(a.fdYo, a.fdY, m, B, col0, ncol, 0, (int)blockDim.x);
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

  // ---- 3, 4. the check, the state out and the capture ----
  const Tiles<T> smt{sW, sS, sV, sT, sdX, sdY, sL, sU, sQ, sRed};
  check_phase<T, TC>(n, m, B, TB, KS, LDW, col0, ncol, sc, a, smt, s_active, s_newly);
}

// ---- 'high' and 'default', register-resident on wgmma (float32) ----

// A block iterates 32 batch columns in its first warpgroup, one a thread
// (rows gid of each warp's 16 rows of wgmma's M = 64; rows gid + 8 carry
// 'high''s cross terms, else zeros).  The other threads copy the captures
// meanwhile, and all of them run the check.
constexpr int kWgCols = 32;
// Two warpgroups: at most 255 registers a thread, which the iterations of
// 'high' need (a third would cap them at 168).
constexpr int kWgThreads = 256;

// k steps of 16 in the internal state of 8 (XC + 2 YC) features.
__host__ __device__ constexpr int wg_ksteps(int XC, int YC) { return (XC + 2 * YC + 1) / 2; }

// Shared-memory layout of the wgmma design for TB columns (kWgCols), in
// floats; each region is rounded up to 16 bytes.  wg_smem_bytes in
// ops/shared_epoch.py mirrors it (and its test reads the region list below
// from this file).
constexpr int kWgRegions = 13;
struct WgLayout {
  int off[kWgRegions + 1];
  __host__ __device__ WgLayout(int n, int m, int H, int XC, int YC, int TB) {
    const int N2 = n + 2 * m, nm = n + m, LDW = w_stride(nm, 4);
    const int NV = XC + YC, KT = wg_ksteps(XC, YC);
    const int sizes[kWgRegions] = {
        imax(H * KT * NV * 64, nm * LDW),  // W: F's halves for wgmma, then [P; A]' and A''
        N2 * TB,    // S = [x; z; y]
        nm * TB,    // V: c0 as loaded, then [P; A] x and [P; A] dx (check)
        n * TB,     // T: A' y, then A' dy (check)
        n * TB,     // dX
        m * TB,     // dY
        m * TB,     // L
        m * TB,     // U
        n * TB,     // Q
        16 * TB,    // per-column partial results of the check
        16 * YC,    // rho, then 1 / rho, in the internal z order
        NV * 8 * TB,   // c0 in fragment order: per 8 features of V, 2 a thread
        YC * 16 * TB,  // L, then U, in fragment order
    };
    off[0] = 0;
    for (int i = 0; i < kWgRegions; ++i) off[i + 1] = off[i] + (sizes[i] + 3) / 4 * 4;
  }
  __host__ __device__ int total() const { return off[kWgRegions]; }
};

// The original feature of S at internal position 8 j + sub (sub < 8), or -1
// for padding: x_i sits at i, z_j at 8 XC + j, y_j at 8 (XC + YC) + j
// (wg_positions in ops/shared_epoch.py).  The features of V, x~ and Pz, sit
// where x and z do, so that Pz_j, z_j and y_j fall in one thread's
// fragments, 8 YC apart.  With j known at compile time the segment is too.
template <int XC, int YC>
__device__ __forceinline__ int wg_orig(int j, int sub, int n, int m) {
  if (j < XC) return 8 * j + sub < n ? 8 * j + sub : -1;
  if (j < XC + YC) return 8 * (j - XC) + sub < m ? n + 8 * (j - XC) + sub : -1;
  if (j < XC + 2 * YC) return 8 * (j - XC - YC) + sub < m ? n + m + 8 * (j - XC - YC) + sub : -1;
  return -1;
}

// The bfloat16 halves of a pair, packed as wgmma's operands take them (the
// first in the low 16 bits): hi = bf16(x), lo = bf16(x - hi), to nearest even.
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ unsigned pack_hi(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_hi(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// F's bfloat16 halves into sB in the layout wgmma reads B from: K-major,
// no swizzle, an 8 x 8 core matrix (8 features of V by 8 k, 16 bytes a row)
// at word ((t NV + g) 2 + c) 32 for k step t, group g of 8 features of V
// and half c of the step's k, so 128 bytes apart along k (the descriptor's
// LBO) and 256 along V (SBO); the lo half (H = 2) follows at word KT NV 64.
// Rows and columns in the internal order, padding zero.  Consecutive
// threads take consecutive pairs of k; each has the loads of its next
// kBatch words in flight before it splits them.
template <int H, int XC, int YC>
__device__ void stage_wg(const float* __restrict__ F, int n, int m, unsigned* sB) {
  constexpr int NV = XC + YC, KT = wg_ksteps(XC, YC), kWords = 8 * KT;
  constexpr int total = 8 * NV * kWords;
  const int N2 = n + 2 * m;
  unsigned* sB_lo = sB + KT * NV * 64;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float v[kBatch][2];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, row = i / kWords, k = 2 * (i - row * kWords);
      // row of F (V's x~ and Pz sit where x and z do), columns of k, k + 1
      const int r = wg_orig<XC, YC>(row >> 3, row & 7, n, m);
      const int k0 = wg_orig<XC, YC>(k >> 3, k & 7, n, m);
      const int k1 = wg_orig<XC, YC>(k >> 3, (k & 7) + 1, n, m);
      const bool ok = i < total && r >= 0;
      v[u][0] = ok && k0 >= 0 ? __ldg(F + (size_t)r * N2 + k0) : 0.f;
      v[u][1] = ok && k1 >= 0 ? __ldg(F + (size_t)r * N2 + k1) : 0.f;
      at[u] = i < total ? ((((k >> 4) * NV + (row >> 3)) * 2 + ((k >> 3) & 1)) * 32 +
                           (row & 7) * 4 + ((k & 7) >> 1))
                        : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] < 0) continue;
      unsigned hi, lo;
      split_pair(v[u][0], v[u][1], hi, lo);
      sB[at[u]] = hi;
      if (H == 2) sB_lo[at[u]] = lo;
    }
  }
}

// A matrix descriptor of wgmma for a K-major operand without swizzle at
// shared address `addr`: core matrices 128 bytes apart along k (LBO) and
// 256 bytes apart along the other dimension (SBO).
__device__ __forceinline__ uint64_t wg_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of these registers across the
// asm statements around them (the wgmma fence and wait).
template <int N> __device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void reg_fence(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 80, fp32; += unless scale_d is 0) = a (64 x 16 bf16, the
// warpgroup's registers) times the 16 x 80 bf16 tile that desc points to:
// N = 8 (XC + YC) at the instantiated padding.
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const unsigned (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// mbarrier and bulk copies (cp.async.bulk) for the block's tiles.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Start copying rows [0, rows) of a (rows, B) global array into a shared
// tile of row stride TB, zero past the ragged edge: one bulk copy per row
// on `bar` where the rows are aligned, else cp.async per element.  Returns
// the bytes the bulk copies deliver; complete after cp_async_wait, a wait
// on `bar` and a barrier.
__device__ unsigned load_rows(const float* __restrict__ G, int rows, int B, int col0, int ncol,
                              float* sm, int TB, uint64_t* bar) {
  if (!rows_aligned(G, B, col0, ncol)) {
    load_tile(G, rows, B, col0, ncol, sm, TB, static_cast<const int*>(nullptr));
    return 0;
  }
  const int pad = TB - ncol;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int r = i / pad;
    sm[r * TB + ncol + (i - r * pad)] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    bulk_load(sm + r * TB, G + (size_t)r * B + col0, 4u * ncol, bar);
  return 4u * ncol * rows;
}

// H halves ('default' 1, 'high' 2); x padded to 8 XC features, z and y to
// 8 YC each (n <= 8 XC, m <= 8 YC).
template <int H, int XC, int YC>
__global__ void __launch_bounds__(kWgThreads, 1)
shared_epoch_kernel_wg(int n, int m, int B, Scalars<float> sc, Args<float> a) {
  static_assert(H == 1 || H == 2, "the reduced modes");
  constexpr int NV = XC + YC, KT = wg_ksteps(XC, YC), NS = 2 * KT, TB = kWgCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_active[TB];
  __shared__ int s_newly[TB];
  __shared__ __align__(8) uint64_t s_bar;
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int nm = n + m, N2 = n + 2 * m;
  const WgLayout lay(n, m, H, XC, YC, TB);
  float* sW = sm + lay.off[0];
  float* sS = sm + lay.off[1];
  float* sV = sm + lay.off[2];
  float* sT = sm + lay.off[3];
  float* sdX = sm + lay.off[4];
  float* sdY = sm + lay.off[5];
  float* sL = sm + lay.off[6];
  float* sU = sm + lay.off[7];
  float* sQ = sm + lay.off[8];
  float* sRed = sm + lay.off[9];
  float* sRz = sm + lay.off[10];
  float* c0f = sm + lay.off[11];
  float* Lf = sm + lay.off[12];
  float* Uf = Lf + YC * 8 * TB;
  const int col0 = blockIdx.x * TB;
  const int ncol = min(TB, B - col0);
  const int tid = threadIdx.x;

  // ---- 0. the block's tiles into shared memory, all copies in flight at once ----
  if (tid == 0) mbar_init(&s_bar, 1);
  __syncthreads();
  unsigned bytes = load_rows(a.S, N2, B, col0, ncol, sS, TB, &s_bar);
  bytes += load_rows(a.dX, n, B, col0, ncol, sdX, TB, &s_bar);
  bytes += load_rows(a.dY, m, B, col0, ncol, sdY, TB, &s_bar);
  bytes += load_rows(a.c0, nm, B, col0, ncol, sV, TB, &s_bar);
  bytes += load_rows(a.L, m, B, col0, ncol, sL, TB, &s_bar);
  bytes += load_rows(a.U, m, B, col0, ncol, sU, TB, &s_bar);
  bytes += load_rows(a.Q, n, B, col0, ncol, sQ, TB, &s_bar);
  if (tid == 0) mbar_expect_tx(&s_bar, bytes);
  int my_active = 0;
  if (tid < TB) {
    my_active = tid < ncol && a.status[col0 + tid] == kUnsolved;
    s_active[tid] = my_active;
  }
  const bool iterate = __syncthreads_or(my_active) && sc.K > 0;
  if (iterate) {  // F's halves, once for the epoch, and rho, 1 / rho in z's order
    stage_wg<H, XC, YC>(a.F, n, m, reinterpret_cast<unsigned*>(sW));
    for (int j = tid; j < 8 * YC; j += blockDim.x) {
      sRz[j] = j < m ? __ldg(a.rho + j) : 0.f;
      sRz[8 * YC + j] = j < m ? __ldg(a.rhoinv + j) : 0.f;
    }
    // wgmma reads F's halves through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  cp_async_wait();
  mbar_wait(&s_bar, 0);
  __syncthreads();

  // ---- 1. K ADMM iterations (affine form) in the first warpgroup ----
  // Thread (warp w, lane 4 gid + tig) holds column col = 8 w + gid at
  // features 8 j + 2 tig + e (e = 0, 1) of every chunk j of 8.  That is
  // wgmma's accumulator layout of V' in rows gid of the warp's 16, and
  // chunks 2 t and 2 t + 1 of the state are the A fragment of k step t.
  if (tid < 128 && iterate) {
    const int lane = tid & 31, tig = lane & 3;
    const int col = 8 * (tid >> 5) + (lane >> 2);
    const bool act = s_active[col] != 0;
    float state[NS][2];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wg_orig<XC, YC>(j, 2 * tig + e, n, m);
        state[j][e] = r >= 0 ? sS[r * TB + col] : 0.f;
      }
    // c0, L and U in fragment order: each thread reads back only what it
    // wrote, so no barrier is needed
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float c[2], l[2], u[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wg_orig<XC, YC>(j, 2 * tig + e, n, m);
        c[e] = r >= 0 ? sV[r * TB + col] : 0.f;
        l[e] = r >= n ? sL[(r - n) * TB + col] : 0.f;
        u[e] = r >= n ? sU[(r - n) * TB + col] : 0.f;
      }
      st(c0f + (j * 128 + tid) * 2, c);
      if (j >= XC) {
        st(Lf + ((j - XC) * 128 + tid) * 2, l);
        st(Uf + ((j - XC) * 128 + tid) * 2, u);
      }
    }
    const unsigned base = smem_u32(sW);
    const uint64_t desc_hi = wg_desc(base), desc_lo = wg_desc(base + KT * NV * 256);
    const float alpha = sc.alpha;
    const float one_m_alpha = 1.f - alpha;
    float acc[4 * NV];
#pragma unroll
    for (int i = 0; i < 4 * NV; ++i) acc[i] = 0.f;
    // V' = S' F': rows gid of acc sum S_hi' F_hi'.  For 'high' the padding
    // rows gid + 8 carry S_lo against F_hi and then S_hi against F_lo, so
    // that they sum cx = S_lo' F_hi' + S_hi' F_lo' (the order of
    // F_hi S_lo + F_lo S_hi): two products a k step into one accumulator.
    // Every A fragment first, then one fence and all the products.
    auto product = [&]() {
      unsigned ah[KT][4], al[KT][4];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        // registers 0 and 2: rows gid at k halves 0 and 1; 1 and 3: rows gid + 8
        const float* s0 = state[2 * t];
        const float* s1 = state[2 * t + 1];
        if constexpr (H == 2) {
          unsigned hi0, lo0, hi1, lo1;
          split_pair(s0[0], s0[1], hi0, lo0);
          split_pair(s1[0], s1[1], hi1, lo1);
          ah[t][0] = hi0; ah[t][1] = lo0; ah[t][2] = hi1; ah[t][3] = lo1;
          al[t][0] = 0u; al[t][1] = hi0; al[t][2] = 0u; al[t][3] = hi1;
          reg_fence(al[t]);
        } else {
          ah[t][0] = pack_hi(s0[0], s0[1]); ah[t][1] = 0u;
          ah[t][2] = pack_hi(s1[0], s1[1]); ah[t][3] = 0u;
        }
        reg_fence(ah[t]);
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const uint64_t dt = (uint64_t)(t * NV * 256) >> 4;
        wgmma_rs(acc, ah[t], desc_hi + dt, t > 0);
        if constexpr (H == 2) wgmma_rs(acc, al[t], desc_lo + dt, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    };
    // F S at accumulator element k (< 4 NV, of rows gid): hh + cx, rounded once
    auto product_at = [](const float (&d)[4 * NV], int k) {
      if constexpr (H == 2) return add_rn(d[k], d[k + 2]);
      else return d[k];
    };
    // The epilogue, in registers, each product and sum rounded on its own
    // as in the CUDA-core design.  Only the last iteration stores (dX, dY),
    // so the others' loads are free to run ahead.
    auto update = [&](auto last_tag) {
      constexpr bool last = decltype(last_tag)::value;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float c0v[2];
        ld(c0f + (j * 128 + tid) * 2, c0v);
        if (j < XC) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = product_at(acc, 4 * j + e);
            const float v = add_rn(p, c0v[e]);
            const float x = state[j][e];
            const float xn = add_rn(mul_rn(alpha, v), mul_rn(one_m_alpha, x));
            state[j][e] = xn;
            const int r = 8 * j + 2 * tig + e;
            if (last && r < n && act) sdX[r * TB + col] = sub_rn(xn, x);
          }
        } else {
          const int jz = j - XC;
          float l[2], u[2], rho[2], rhoinv[2];
          ld(Lf + (jz * 128 + tid) * 2, l);
          ld(Uf + (jz * 128 + tid) * 2, u);
          ld(sRz + 8 * jz + 2 * tig, rho);
          ld(sRz + 8 * YC + 8 * jz + 2 * tig, rhoinv);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = product_at(acc, 4 * j + e);
            const float v = add_rn(p, c0v[e]);
            const float y = state[j + YC][e];
            const float zn = nmin(nmax(v, l[e]), u[e]);
            const float yn =
                add_rn(y, mul_rn(rho[e], sub_rn(sub_rn(v, mul_rn(rhoinv[e], y)), zn)));
            state[j][e] = zn;
            state[j + YC][e] = yn;
            const int q = 8 * jz + 2 * tig + e;
            if (last && q < m && act) sdY[q * TB + col] = sub_rn(yn, y);
          }
        }
      }
    };
    for (int it = 1; it < sc.K; ++it) {
      product();
      update(std::false_type());
    }
    product();
    update(std::true_type());
    // the state back in the (feature, column) layout, active columns only
    // (the others keep their input: the merge)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wg_orig<XC, YC>(j, 2 * tig + e, n, m);
        if (r >= 0 && act) sS[r * TB + col] = state[j][e];
      }
  } else {  // the captures start as the input's
    const int first = iterate ? 128 : 0;
    copy_cols(a.fSo, a.fS, N2, B, col0, ncol, first, (int)blockDim.x - first);
    copy_cols(a.fdXo, a.fdX, n, B, col0, ncol, first, (int)blockDim.x - first);
    copy_cols(a.fdYo, a.fdY, m, B, col0, ncol, first, (int)blockDim.x - first);
  }
  __syncthreads();

  // ---- 2-4. (merged above), the check, the state out and the capture ----
  const Tiles<float> smt{sW, sS, sV, sT, sdX, sdY, sL, sU, sQ, sRed};
  check_phase<float, 2>(n, m, B, TB, N2, w_stride(nm, 4), col0, ncol, sc, a, smt, s_active,
                        s_newly);
}

// The wgmma instantiations: H at the padding (XC, YC) = (4, 6).
template <int H>
cudaError_t start_wg(int n, int m, int B, size_t smem, const Scalars<float>& sc,
                     const Args<float>& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(shared_epoch_kernel_wg<H, 4, 6>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (B + kWgCols - 1) / kWgCols;
  shared_epoch_kernel_wg<H, 4, 6><<<grid, kWgThreads, smem, stream>>>(n, m, B, sc, a);
  return cudaGetLastError();
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
int launch(int n, int m, int B, int TB, int TC, int KS, int H, int XC, int YC, int K,
           int unscaled, int check_dualgap, const void* scal, void* const* p, void* stream) {
  if (B == 0) return cudaSuccess;
  // the plan must be one this source can run
  const int nm = n + m, N2 = n + 2 * m;
  const bool wg = XC != 0 || YC != 0;
  if (wg && (!std::is_same<T, float>::value || (H != 1 && H != 2) || TB != kWgCols || TC != 2 ||
             KS != N2 || XC != 4 || YC != 6 || n > 8 * XC || m > 8 * YC))
    return cudaErrorInvalidValue;
  int threads = (nm + 3) / 4 * (TB / max(TC, 1));
  if (H != 0) threads = (threads + 31) / 32 * 32;  // whole warps for the mma tiles
  if (!wg && (TB < 1 || TB > 32 || (TB & (TB - 1)) != 0 || (TC != 1 && TC != 2) || TC > TB ||
      KS < 1 || KS > N2 || threads < TB || threads > kMaxThreads || H < 0 || H > 2))
    return cudaErrorInvalidValue;
  if (H != 0 && !wg) {  // float32, 8-column tiles, slabs of whole k tiles, kMaxTiles per warp
    const int tiles = (nm + 15) / 16 * (TB / 8), warps = threads / 32;
    if (!std::is_same<T, float>::value || TB < 8 || (KS < N2 && KS % 16 != 0) ||
        (tiles + warps - 1) / warps > kMaxTiles)
      return cudaErrorInvalidValue;
  }
  const size_t smem =
      wg ? (size_t)WgLayout(n, m, H, XC, YC, TB).total() * sizeof(float)
         : (size_t)Layout(n, m, TB, KS, w_stride(nm, sizeof(T)), sizeof(T), H).total() * sizeof(T);
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
    if (wg)
      return H == 1 ? start_wg<1>(n, m, B, smem, sc, a, st) : start_wg<2>(n, m, B, smem, sc, a, st);
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
// thread, KS rows of F' staged at a time; XC, YC the wgmma design's
// padding, 0 for the others) comes from plan_tile in ops/shared_epoch.py;
// the launch takes the Layout's (or WgLayout's) shared memory.  H is the
// iteration product's bfloat16 halves (0 'highest', 1 'default', 2 'high';
// float32 only, else cudaErrorInvalidValue).  Pointer order: scal
// (host: alpha, eps_abs, eps_rel, eps_prim_inf, eps_dual_inf, c, cinv), then
// the 20 inputs F CH At rho_vec rho_inv D Dinv E Einv c0 Q L U S dX dY fS fdX
// fdY status, then the 11 outputs S dX dY fS fdX fdY status pri dua obj dobj,
// then the stream.  Returns the cudaError_t of the launch.
#define SHARED_EPOCH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(int n, int m, int B, int TB, int TC, int KS, int H, int XC, \
                      int YC, int K, int unscaled, int check_dualgap,           \
                      const void* scal,                                         \
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
    return launch<T>(n, m, B, TB, TC, KS, H, XC, YC, K, unscaled, check_dualgap, \
                     scal, p, stream);                                          \
  }

SHARED_EPOCH_ENTRY(shared_epoch_f32, float)
SHARED_EPOCH_ENTRY(shared_epoch_f64, double)
