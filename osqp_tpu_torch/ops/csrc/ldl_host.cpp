// Symbolic analysis of the sparse LDL' factorization (host code, C ABI).
//
// The port's copy of osqp_tpu/native/ldl.cpp's symbolic pass
// (``ldl_symbolic``), extended with what the card's kernels need: the full
// pattern of L in CSC (rows sorted in each column) and in CSR (columns
// sorted in each row), the map between the two, where each entry of K sits
// in L's pattern, and the heights of the elimination tree that schedule the
// numeric factorization (ldl_factor.cu) level by level.
//
// All matrices are upper-triangular CSC with int32 indices; no numeric work
// is done here.  Built with the system C++ compiler at first use
// (osqp_tpu_torch/ops/_build.py::build_host).

#include <cstdint>

extern "C" {

// Elimination tree and column counts of L (strictly lower entries per
// column).  Ap/Ai: the upper-triangular CSC pattern; its diagonal must be
// stored.  Returns nnz(L) >= 0, -1 on a lower-triangular entry or a
// missing diagonal, or -2 where nnz(L) passes `cap` (or int32): the walk
// stops there, so its cost is bounded by the cap.
int32_t ldl_etree(int32_t n, const int32_t* Ap, const int32_t* Ai, int32_t* parent,
                  int32_t* Lnz, int32_t* flag, int64_t cap) {
  if (cap > INT32_MAX) cap = INT32_MAX;
  int64_t total = 0;
  for (int32_t k = 0; k < n; ++k) {
    parent[k] = -1;
    flag[k] = k;
    Lnz[k] = 0;
    bool has_diag = false;
    for (int32_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int32_t i = Ai[p];
      if (i > k) return -1;  // not upper triangular
      if (i == k) has_diag = true;
      while (flag[i] != k) {  // walk up the tree from i to k
        if (parent[i] == -1) parent[i] = k;
        Lnz[i]++;
        if (++total > cap) return -2;
        flag[i] = k;
        i = parent[i];
      }
    }
    if (!has_diag) return -1;
  }
  return (int32_t)total;
}

// The pattern of L in CSC: Li (rows of each column in increasing order, the
// order in which the up-looking traversal of row k meets them), kmap (for
// each entry of L, the position in Ax of K's entry there, or -1 for fill)
// and diagpos (the position in Ax of each diagonal entry).  Lp is the prefix
// sum of ldl_etree's Lnz.  Work arrays of n int32: flag, pos, cnt.
void ldl_pattern(int32_t n, const int32_t* Ap, const int32_t* Ai, const int32_t* parent,
                 const int32_t* Lp, int32_t* Li, int32_t* kmap, int32_t* diagpos,
                 int32_t* flag, int32_t* pos, int32_t* cnt) {
  for (int32_t k = 0; k < n; ++k) {
    flag[k] = -1;
    cnt[k] = 0;
    diagpos[k] = -1;
  }
  for (int32_t k = 0; k < n; ++k) {
    flag[k] = k;
    for (int32_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      const int32_t i = Ai[p];
      if (i == k) {
        diagpos[k] = p;
        continue;
      }
      // every node on the path from i up to k holds an entry of row k
      for (int32_t j = i; flag[j] != k; j = parent[j]) {
        const int32_t q = Lp[j] + cnt[j]++;
        Li[q] = k;
        kmap[q] = -1;
        pos[j] = q;
        flag[j] = k;
      }
      kmap[pos[i]] = p;  // K's entry (i, k) is L's (k, i)
    }
  }
}

// The row pattern of L (CSR: Rp, Rj with columns in increasing order) and
// csc2csr, the CSR position of each CSC entry.  Work: next (n int32).
void ldl_transpose(int32_t n, const int32_t* Lp, const int32_t* Li, int32_t* Rp, int32_t* Rj,
                   int32_t* csc2csr, int32_t* next) {
  for (int32_t i = 0; i <= n; ++i) Rp[i] = 0;
  for (int32_t p = 0; p < Lp[n]; ++p) Rp[Li[p] + 1]++;
  for (int32_t i = 0; i < n; ++i) Rp[i + 1] += Rp[i];
  for (int32_t i = 0; i < n; ++i) next[i] = Rp[i];
  for (int32_t j = 0; j < n; ++j) {
    for (int32_t p = Lp[j]; p < Lp[j + 1]; ++p) {
      const int32_t q = next[Li[p]]++;
      Rj[q] = j;
      csc2csr[p] = q;
    }
  }
}

// Height of each node in the elimination tree (0 for a leaf, else one more
// than its highest child): a column's row pattern holds only its
// descendants, so the columns of one height depend on lower heights only.
// A parent's index exceeds its children's, so one pass in index order
// finishes every child before its parent.  Returns the number of heights
// (the tree's depth in nodes).
int32_t ldl_heights(int32_t n, const int32_t* parent, int32_t* height) {
  for (int32_t j = 0; j < n; ++j) height[j] = 0;
  int32_t top = 0;
  for (int32_t j = 0; j < n; ++j) {
    const int32_t p = parent[j];
    if (p >= 0 && height[p] < height[j] + 1) height[p] = height[j] + 1;
    if (height[j] > top) top = height[j];
  }
  return n ? top + 1 : 0;
}

}  // extern "C"
