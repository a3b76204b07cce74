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
// the bound is the fp32 (or fp64) CUDA-core rate, not memory.
//
// Design: one block per tile of TB batch columns (TB a power of two up to 32,
// chosen by the wrapper so that the tile fits shared memory and the grid
// covers the SMs).  The block's slice of S, dX and dY lives in shared memory
// for the whole epoch, so state crosses device memory once per epoch, not
// once per iteration.  F, [P; A] and A' are read from global memory through
// the read-only cache: they are shared by all blocks and stay in L2 (F is
// 40 KB at n=32, m=48 but 640 KB at n=128, m=192, too large for shared
// memory at every shape).  Each thread of the tile matmul owns one column and
// four rows, so a shared-memory load of S feeds four FMAs.  The termination
// check runs its matvecs as the same tile matmuls, then one thread per
// column does the column reductions in order.  All arithmetic is plain IEEE
// fp32 or fp64 on the CUDA cores (iter_prec 'highest').  Tiles whose columns
// have all terminated skip the iterations.  Shared-memory rows have a stride
// of TB + 1 so that column-wise and row-wise walks are free of bank
// conflicts.  The ragged batch edge is masked; nothing is padded.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kThreads = 256;
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

// Out[r, c] = sum_k W[r, k] In[k, c] for r < R, over the block's TB columns.
// W is (R, Kd) row-major in global memory; In and Out are shared-memory tiles
// with row stride LD.  Each thread owns column c and rows r0..r0+3.
template <typename T>
__device__ void tile_matmul(const T* __restrict__ W, int R, int Kd,
                            const T* In, T* Out, int TB, int LD) {
  const int c = threadIdx.x % TB;
  const int g = threadIdx.x / TB;
  const int G = blockDim.x / TB;
  for (int r0 = 4 * g; r0 < R; r0 += 4 * G) {
    // rows past R re-read row R-1 and are not stored
    const T* w0 = W + (size_t)r0 * Kd;
    const T* w1 = W + (size_t)min(r0 + 1, R - 1) * Kd;
    const T* w2 = W + (size_t)min(r0 + 2, R - 1) * Kd;
    const T* w3 = W + (size_t)min(r0 + 3, R - 1) * Kd;
    T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int k = 0; k < Kd; ++k) {
      const T s = In[k * LD + c];
      a0 += __ldg(w0 + k) * s;
      a1 += __ldg(w1 + k) * s;
      a2 += __ldg(w2 + k) * s;
      a3 += __ldg(w3 + k) * s;
    }
    Out[r0 * LD + c] = a0;
    if (r0 + 1 < R) Out[(r0 + 1) * LD + c] = a1;
    if (r0 + 2 < R) Out[(r0 + 2) * LD + c] = a2;
    if (r0 + 3 < R) Out[(r0 + 3) * LD + c] = a3;
  }
}

// Copy rows [0, rows) of a (rows, B) global array into a shared tile, zero
// past the ragged edge; given `flag`, only the valid columns whose flag is 0.
template <typename T>
__device__ void load_tile(const T* __restrict__ G, int rows, int B, int col0,
                          int ncol, T* sm, int TB, int LD, const int* flag) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i / TB, c = i % TB;
    if (flag != nullptr && (c >= ncol || flag[c])) continue;
    sm[f * LD + c] = c < ncol ? G[(size_t)f * B + col0 + c] : T(0);
  }
}

template <typename T>
__device__ void store_tile(T* __restrict__ G, int rows, int B, int col0,
                           int ncol, const T* sm, int TB, int LD) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i / TB, c = i % TB;
    if (c < ncol) G[(size_t)f * B + col0 + c] = sm[f * LD + c];
  }
}

// Capture: out = newly ? sm : old, per column.
template <typename T>
__device__ void capture_tile(T* __restrict__ G, const T* __restrict__ old,
                             int rows, int B, int col0, int ncol, const T* sm,
                             int TB, int LD, const int* newly) {
  for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
    const int f = i / TB, c = i % TB;
    if (c >= ncol) continue;
    const size_t g = (size_t)f * B + col0 + c;
    G[g] = newly[c] ? sm[f * LD + c] : old[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shared_epoch_kernel(int n, int m, int B, int TB, Scalars<T> sc, Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_active[32];
  __shared__ int s_newly[32];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int LD = TB + 1;
  const int nm = n + m, N2 = n + 2 * m;
  T* sS = sm;             // (n+2m, LD)  [x; z; y]
  T* sV = sS + N2 * LD;   // (n+m, LD)   F S, then [P; A] x, then [P; A] dx
  T* sdX = sV + nm * LD;  // (n, LD)
  T* sdY = sdX + n * LD;  // (m, LD)
  T* sT = sdY + m * LD;   // (n, LD)     A' y, then A' dy
  const int col0 = blockIdx.x * TB;
  const int ncol = min(TB, B - col0);
  const int tid = threadIdx.x;

  int my_active = 0;
  if (tid < TB) {
    my_active = tid < ncol && a.status[col0 + tid] == kUnsolved;
    s_active[tid] = my_active;
  }
  load_tile(a.S, N2, B, col0, ncol, sS, TB, LD, (const int*)nullptr);
  load_tile(a.dX, n, B, col0, ncol, sdX, TB, LD, (const int*)nullptr);
  load_tile(a.dY, m, B, col0, ncol, sdY, TB, LD, (const int*)nullptr);
  const int any_active = __syncthreads_or(my_active);

  // ---- 1. K ADMM iterations (affine form) ----
  if (any_active) {
    const T alpha = sc.alpha;
    const T one_m_alpha = T(1) - alpha;
    for (int it = 0; it < sc.K; ++it) {
      tile_matmul(a.F, nm, N2, sS, sV, TB, LD);
      __syncthreads();
      for (int i = tid; i < n * TB; i += blockDim.x) {
        const int f = i / TB, c = i % TB;
        if (c >= ncol) continue;
        const T x = sS[f * LD + c];
        const T xt = sV[f * LD + c] + a.c0[(size_t)f * B + col0 + c];
        const T xn = alpha * xt + one_m_alpha * x;
        sS[f * LD + c] = xn;
        sdX[f * LD + c] = xn - x;
      }
      for (int i = tid; i < m * TB; i += blockDim.x) {
        const int j = i / TB, c = i % TB;
        if (c >= ncol) continue;
        const size_t g = (size_t)j * B + col0 + c;
        const T pz = sV[(n + j) * LD + c] + a.c0[(size_t)(n + j) * B + col0 + c];
        const T zn = nmin(nmax(pz, a.L[g]), a.U[g]);
        const T y = sS[(nm + j) * LD + c];
        const T yn = y + a.rho[j] * (pz - a.rhoinv[j] * y - zn);
        sS[(n + j) * LD + c] = zn;
        sS[(nm + j) * LD + c] = yn;
        sdY[j * LD + c] = yn - y;
      }
      __syncthreads();
    }
  }

  // ---- 2. merge: terminated columns take their input state back ----
  load_tile(a.S, N2, B, col0, ncol, sS, TB, LD, s_active);
  load_tile(a.dX, n, B, col0, ncol, sdX, TB, LD, s_active);
  load_tile(a.dY, m, B, col0, ncol, sdY, TB, LD, s_active);
  __syncthreads();

  // ---- 3. termination check ----
  tile_matmul(a.CH, nm, n, sS, sV, TB, LD);        // [P x; A x]
  tile_matmul(a.At, n, m, sS + nm * LD, sT, TB, LD);  // A' y
  __syncthreads();

  const T eps = Limits<T>::eps();
  const T loose = T(1e30 * 1e-4);
  const T infty = T(1e30);
  const bool unscaled = sc.unscaled != 0;
  const T cinv = sc.cinv;
  const int c = tid;
  const int col = col0 + c;
  T pri = 0, dua = 0, obj = 0, dobj = 0, gap_noise = 0;
  bool pri_check = false, dua_check = false, noncvx = false;

  if (c < ncol) {
    const T* X = sS;
    const T* Z = sS + n * LD;
    const T* Y = sS + nm * LD;
    const T* PX = sV;
    const T* AX = sV + n * LD;
    T dmax = 0, quad2 = 0, qx = 0, xx = 0, atym = 0, pxm = 0, qm = 0;
    for (int i = 0; i < n; ++i) {
      const T x = X[i * LD + c], px = PX[i * LD + c], aty = sT[i * LD + c];
      const T q = a.Q[(size_t)i * B + col];
      const T dinv = a.Dinv[i];
      const T dv = px + q + aty;
      dmax = nmax(dmax, absv(unscaled ? dinv * dv : dv));
      quad2 += x * px;
      qx += q * x;
      xx += x * x;
      atym = nmax(atym, absv(unscaled ? dinv * aty : aty));
      pxm = nmax(pxm, absv(unscaled ? dinv * px : px));
      qm = nmax(qm, absv(unscaled ? dinv * q : q));
    }
    dua = unscaled ? cinv * dmax : dmax;
    const T quad = T(0.5) * quad2;
    obj = (quad + qx) * cinv;

    T ymax = 0;
    for (int j = 0; j < m; ++j) {
      ymax = nmax(ymax, absv(cinv * (a.E[j] * Y[j * LD + c])));
    }
    const T y_tol = eps * ymax;
    T pmax = 0, axm = 0, zm = 0, sum_p = 0, sum_n = 0, mag_p = 0, mag_n = 0;
    for (int j = 0; j < m; ++j) {
      const T einv = a.Einv[j];
      const T ax = AX[j * LD + c], z = Z[j * LD + c];
      const T pv = ax - z;
      pmax = nmax(pmax, absv(unscaled ? einv * pv : pv));
      axm = nmax(axm, absv(unscaled ? einv * ax : ax));
      zm = nmax(zm, absv(unscaled ? einv * z : z));
      T yu = cinv * (a.E[j] * Y[j * LD + c]);
      yu = absv(yu) > y_tol ? yu : T(0);
      const size_t g = (size_t)j * B + col;
      const T lu = einv * a.L[g], uu = einv * a.U[g];
      const T sp = uu < loose ? uu * nmax(yu, T(0)) : T(0);
      const T sn = lu > -loose ? lu * nmin(yu, T(0)) : T(0);
      sum_p += sp;
      sum_n += sn;
      mag_p += absv(sp);
      mag_n += absv(sn);
    }
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
  __syncthreads();

  tile_matmul(a.CH, nm, n, sdX, sV, TB, LD);  // [P dx; A dx]
  tile_matmul(a.At, n, m, sdY, sT, TB, LD);   // A' dy
  __syncthreads();

  if (c < ncol) {
    // primal infeasibility certificate
    T ndy = 0, lhs = 0, atdy = 0;
    for (int j = 0; j < m; ++j) {
      const T dy = sdY[j * LD + c];
      const size_t g = (size_t)j * B + col;
      ndy = nmax(ndy, absv(unscaled ? a.E[j] * dy : dy));
      lhs += a.U[g] * nmax(dy, T(0)) + a.L[g] * nmin(dy, T(0));
    }
    for (int i = 0; i < n; ++i) {
      const T v = sT[i * LD + c];
      atdy = nmax(atdy, absv(unscaled ? a.Dinv[i] * v : v));
    }
    const T ep = sc.eps_pinf;
    const bool pinf = (ndy > ep) && (lhs < -ep * ndy) && (atdy < ep * ndy) && !pri_check;

    // dual infeasibility certificate
    T ndx = 0, qdx = 0, pdx = 0;
    for (int i = 0; i < n; ++i) {
      const T dx = sdX[i * LD + c], v = sV[i * LD + c];
      ndx = nmax(ndx, absv(unscaled ? a.D[i] * dx : dx));
      qdx += a.Q[(size_t)i * B + col] * dx;
      pdx = nmax(pdx, absv(unscaled ? a.Dinv[i] * v : v));
    }
    const T ed = sc.eps_dinf;
    const T cost_scale = unscaled ? sc.c : T(1);
    bool dinf = (ndx > ed) && (qdx < -cost_scale * ed * ndx) && (pdx < cost_scale * ed * ndx);
    bool bad = false;
    for (int j = 0; j < m; ++j) {
      T adx = sV[(n + j) * LD + c];
      if (unscaled) adx = a.Einv[j] * adx;
      const size_t g = (size_t)j * B + col;
      bad |= ((a.U[g] < loose) && (adx > ed * ndx)) || ((a.L[g] > -loose) && (adx < -ed * ndx));
    }
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
  store_tile(a.So, N2, B, col0, ncol, sS, TB, LD);
  store_tile(a.dXo, n, B, col0, ncol, sdX, TB, LD);
  store_tile(a.dYo, m, B, col0, ncol, sdY, TB, LD);
  capture_tile(a.fSo, a.fS, N2, B, col0, ncol, sS, TB, LD, s_newly);
  capture_tile(a.fdXo, a.fdX, n, B, col0, ncol, sdX, TB, LD, s_newly);
  capture_tile(a.fdYo, a.fdY, m, B, col0, ncol, sdY, TB, LD, s_newly);
}

template <typename T>
int launch(int n, int m, int B, int TB, int K, int unscaled, int check_dualgap,
           const void* scal, void* const* p, void* stream) {
  if (B == 0) return cudaSuccess;
  if (TB < 1 || TB > 32 || (TB & (TB - 1)) != 0) return cudaErrorInvalidValue;
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

  const size_t smem = (size_t)(4 * n + 4 * m) * (TB + 1) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(shared_epoch_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (B + TB - 1) / TB;
  shared_epoch_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, m, B, TB, sc, a);
  return cudaGetLastError();
}

}  // namespace

// C entry points.  Pointer order: scal (host: alpha, eps_abs, eps_rel,
// eps_prim_inf, eps_dual_inf, c, cinv), then the 20 inputs F CH At rho_vec
// rho_inv D Dinv E Einv c0 Q L U S dX dY fS fdX fdY status, then the 11
// outputs S dX dY fS fdX fdY status pri dua obj dobj, then the stream.
// Returns the cudaError_t of the launch.
#define SHARED_EPOCH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(int n, int m, int B, int TB, int K, int unscaled,         \
                      int check_dualgap, const void* scal,                      \
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
    return launch<T>(n, m, B, TB, K, unscaled, check_dualgap, scal, p, stream); \
  }

SHARED_EPOCH_ENTRY(shared_epoch_f32, float)
SHARED_EPOCH_ENTRY(shared_epoch_f64, double)
