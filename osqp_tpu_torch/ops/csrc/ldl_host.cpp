// Symbolic analysis of the sparse LDL' factorization (host code, C ABI).
//
// The port's copy of osqp_tpu/native/ldl.cpp's symbolic pass
// (``ldl_symbolic``), extended with what the card's kernels need: the full
// pattern of L in CSC (rows sorted in each column) and in CSR (columns
// sorted in each row), the map between the two, where each entry of K sits
// in L's pattern, the heights of the elimination tree, the heights of the
// tree of tasks (thin columns and supernodes) that schedule the numeric
// factorization (ldl_factor.cu) level by level, and the tables that join
// the supernodes to the columns that update them.
//
// All matrices are upper-triangular CSC with int32 indices; no numeric work
// is done here.  Built with the system C++ compiler at first use
// (osqp_tpu_torch/ops/_build.py::build_host).

#include <algorithm>
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

// Heights in the tree of tasks, where each supernode is one node: node[j]
// is the first column of column j's supernode, or j for a thin column.
// height[node] gets 0 for a leaf, else one more than its highest child
// (entries of non-first supernode columns stay 0).  A node's columns and
// all its children come before its parent's first column, so one pass in
// index order finishes every node before its parent.
void ldl_node_heights(int32_t n, const int32_t* parent, const int32_t* node, int32_t* height) {
  for (int32_t j = 0; j < n; ++j) height[j] = 0;
  for (int32_t j = 0; j < n; ++j) {
    const int32_t p = parent[j];
    if (p < 0 || node[p] == node[j]) continue;
    const int32_t a = node[p], c = node[j];
    if (height[a] < height[c] + 1) height[a] = height[c] + 1;
  }
}

// The thin columns that update a supernode through two or more entries,
// in two passes.  A thin column's (snode[j] < 0) entries in one supernode's
// columns (snode[row] >= 0) form a group; from its first entry on, every
// entry of the column lies in that supernode's rows, so the group's count
// is the rest of the column.  ldl_group_count fills gptr (nsup + 1: the
// groups of two or more entries by supernode) and returns their count.
int32_t ldl_group_count(int32_t n, int32_t nsup, const int32_t* Lp, const int32_t* Li,
                        const int32_t* snode, int32_t* gptr) {
  for (int32_t s = 0; s <= nsup; ++s) gptr[s] = 0;
  for (int32_t j = 0; j < n; ++j) {
    if (snode[j] >= 0) continue;
    int32_t prev = -1;
    for (int32_t p = Lp[j]; p < Lp[j + 1] - 1; ++p) {  // a last entry starts no such group
      const int32_t o = snode[Li[p]];
      if (o >= 0 && o != prev) gptr[o + 1]++;
      prev = o;
    }
  }
  for (int32_t s = 0; s < nsup; ++s) gptr[s + 1] += gptr[s];
  return gptr[nsup];
}

// The second pass: by supernode, columns ascending, each group of two or
// more (gsrc, 4 a group): column, CSC position of its first entry, count,
// 0.  Work: gnext (nsup).
void ldl_group_fill(int32_t n, int32_t nsup, const int32_t* Lp, const int32_t* Li,
                    const int32_t* snode, const int32_t* gptr, int32_t* gsrc, int32_t* gnext) {
  for (int32_t s = 0; s < nsup; ++s) gnext[s] = gptr[s];
  for (int32_t j = 0; j < n; ++j) {
    if (snode[j] >= 0) continue;
    int32_t prev = -1;
    for (int32_t p = Lp[j]; p < Lp[j + 1] - 1; ++p) {
      const int32_t o = snode[Li[p]];
      if (o >= 0 && o != prev) {
        int32_t* g = gsrc + 4 * (int64_t)gnext[o]++;
        g[0] = j;
        g[1] = p;
        g[2] = Lp[j + 1] - p;
        g[3] = 0;
      }
      prev = o;
    }
  }
}

// The thin columns' entries in rows that are supernode columns, by row,
// columns ascending, read along L's rows (CSR) with each run of a
// supernode's columns skipped by a binary search.  With Tk null it fills
// Tp (n + 1, CSR over all rows) and returns the count of entries; else it
// fills each entry's column (Tk), its CSR position (Tc) and 1 where it is
// its group's one entry (Tone: it updates the supernode's pivot only; the
// column's last entry, its previous entry outside the supernode).  sn
// (nsup x 4): first column, width, rows, row-list offset.  Work: last,
// prev_own (n each).
int32_t ldl_thin_rows(int32_t n, const int32_t* sn, const int32_t* Lp, const int32_t* Li,
                      const int32_t* Rp, const int32_t* Rj, const int32_t* snode, int32_t* Tp,
                      int32_t* Tk, int32_t* Tc, uint8_t* Tone, int32_t* last,
                      int32_t* prev_own) {
  if (Tk) {
    for (int32_t j = 0; j < n; ++j) {
      const int32_t cnt = Lp[j + 1] - Lp[j];
      last[j] = cnt ? Li[Lp[j + 1] - 1] : -1;
      prev_own[j] = cnt >= 2 ? snode[Li[Lp[j + 1] - 2]] : -1;
    }
  } else {
    Tp[0] = 0;
  }
  int32_t e = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t s = snode[i];
    if (s >= 0) {
      const int32_t qe = Rp[i + 1];
      for (int32_t q = Rp[i]; q < qe;) {
        const int32_t j = Rj[q], o = snode[j];
        if (o >= 0) {  // skip supernode o's columns
          const int32_t* end = Rj + qe;
          q = (int32_t)(std::lower_bound(Rj + q, end, sn[4 * o] + sn[4 * o + 1]) - Rj);
          continue;
        }
        if (Tk) {
          Tk[e] = j;
          Tc[e] = q;
          Tone[e] = last[j] == i && prev_own[j] != s;
        }
        ++e;
        ++q;
      }
    }
    if (!Tk) Tp[i + 1] = e;
  }
  return e;
}

// The supernode pairs: supernode t updates supernode s where t's rows below
// its columns meet s's columns, and from the first such row on all of t's
// rows lie in s's row list.  sn (nsup x 4): first column, width, rows,
// offset of the row list in rows.  ldl_pair_count fills pptr (nsup + 1:
// the pairs by s) and returns the total length of their maps.
int64_t ldl_pair_count(int32_t nsup, const int32_t* sn, const int32_t* rows,
                       const int32_t* snode, int32_t* pptr) {
  for (int32_t s = 0; s <= nsup; ++s) pptr[s] = 0;
  int64_t total = 0;
  for (int32_t t = 0; t < nsup; ++t) {
    const int32_t* r = rows + sn[4 * t + 3];
    const int32_t w = sn[4 * t + 1], nr = sn[4 * t + 2];
    int32_t prev = -1;
    for (int32_t a = w; a < nr; ++a) {
      const int32_t o = snode[r[a]];
      if (o >= 0 && o != prev) {
        pptr[o + 1]++;
        total += nr - a;
      }
      prev = o;
    }
  }
  for (int32_t s = 0; s < nsup; ++s) pptr[s + 1] += pptr[s];
  return total;
}

// The second pass: for each s, its pairs with t ascending (pairs, 4 a
// pair): t, t's first row position in s's rows, the count of t's rows from
// there, offset of their positions in s's row list in relmap (each
// supernode's maps one after another).  Work: where (n), pnext (nsup).
void ldl_pair_fill(int32_t n, int32_t nsup, const int32_t* sn, const int32_t* rows,
                   const int32_t* snode, const int32_t* pptr, int32_t* pairs, int32_t* relmap,
                   int32_t* where, int32_t* pnext) {
  for (int32_t s = 0; s < nsup; ++s) pnext[s] = pptr[s];
  for (int32_t t = 0; t < nsup; ++t) {
    const int32_t* r = rows + sn[4 * t + 3];
    const int32_t w = sn[4 * t + 1], nr = sn[4 * t + 2];
    int32_t prev = -1;
    for (int32_t a = w; a < nr; ++a) {
      const int32_t o = snode[r[a]];
      if (o >= 0 && o != prev) {
        int32_t* pr = pairs + 4 * (int64_t)pnext[o]++;
        pr[0] = t;
        pr[1] = a;
        pr[2] = nr - a;
      }
      prev = o;
    }
  }
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) where[i] = -1;
  for (int32_t s = 0; s < nsup; ++s) {
    const int32_t* rs = rows + sn[4 * s + 3];
    for (int32_t p = 0; p < sn[4 * s + 2]; ++p) where[rs[p]] = p;
    for (int32_t e = pptr[s]; e < pptr[s + 1]; ++e) {
      int32_t* pr = pairs + 4 * (int64_t)e;
      const int32_t* r = rows + sn[4 * pr[0] + 3] + pr[1];
      pr[3] = (int32_t)off;
      for (int32_t i = 0; i < pr[2]; ++i) relmap[off++] = where[r[i]];
    }
  }
}

}  // extern "C"
