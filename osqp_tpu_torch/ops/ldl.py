"""Sparse LDL' of a quasi-definite symmetric matrix: the host's symbolic
analysis, the card's numeric factorization (K5) and triangular solves (K6),
and their plain PyTorch versions.

Counterpart of ``osqp_tpu/native/ldl.py::LDLFactor`` (the QDLDL-class
direct solver of the ``numpy`` algebra) and of ``native/ldl.cpp``.  The JAX
package runs that factorization on the host; it has no Pallas kernel, so K5
and K6 replace no TPU kernel: they move the numpy algebra's linear-system
core onto the card.

- Symbolic (host, ``csrc/ldl_host.cpp``, built by g++, and numpy): the
  elimination tree and column counts, the pattern of L in CSC and in CSR,
  and the choice between reverse Cuthill-McKee and the natural ordering by
  symbolic fill, keeping RCM only where it strictly reduces nnz(L) (the
  JAX package's rule).  The caller's data order is kept through a map, for
  unsorted indices and for the permutation.  Then the supernodes (runs of
  columns whose patterns nest, ``Symbolic``), the maps that place each
  updating column's rows in a supernode's rows, K5's launch plan
  (``Symbolic.plan``, its launch count ``k5_launches``) and K6's tasks.
- K5 (``csrc/ldl_factor.cu``): the numeric factorization in float64 into
  that pattern: thin columns by gathers, a height of the tree of tasks a
  launch (a chain of one-item heights in one), supernodes left-looking as
  dense panels, their products on the f64 tensor cores.  It writes L in
  both layouts, D, 1/D and the count of positive pivots, which one host
  sync reads (a zero pivot raises ``ZeroDivisionError``).
- K6 (``csrc/ldl_solve.cu``): ``x = P' L'^-1 D^-1 L^-1 P b`` in float64, one
  launch whatever the tree's depth: thin rows and columns a warp each,
  supernodes in tiles of ``TILE`` columns a block each.

``LDLFactor`` launches K5 and K6 for CUDA tensors (and raises if it cannot)
and runs the plain versions for CPU tensors, up to ``CPU_MAX_N``: the plain
factorization is a blocked left-looking loop over the columns of a dense
copy, the plain solve two dense triangular solves.  On the card
``factor_launches`` counts K5's launches (the launcher adds one for each:
``Symbolic.k5_launches`` a factorization), ``factor_calls`` the numeric
factorizations and ``solve_launches`` K6's launches, one a solve.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import tracing
from ..device import resolve_device

# Counts on the card since the last reset, read by chip_smoke.py: K5's
# launches, its calls (numeric factorizations) and K6's launches.
factor_launches = 0
factor_calls = 0
solve_launches = 0

# The plain versions densify: past this order the CPU path raises.
CPU_MAX_N = 16_384
ROWS_PER_ITEM = 32  # rows of one thin column a K5 block takes (kRows in ldl_factor.cu)
SUPERNODE_MIN = 32  # the narrowest supernode: narrower runs stay thin columns
TILE = 64  # a supernode's tile in K5 and K6 (kTile in ldl_factor.cu and ldl_solve.cu)
BLOCKS_PER_SM = 4  # K5's thin-column blocks per SM, one workspace of n doubles each
SOLVE_WARPS = 8  # K6's thin rows or columns a block, one warp each (kWarps in ldl_solve.cu)
PLAIN_BLOCK = 64  # column block of the plain factorization


# ---------------------------------------------------------------------------
# Symbolic analysis (host)
# ---------------------------------------------------------------------------


def _host_lib():
    from . import _build

    lib = _build.load_host_library('ldl_host')
    if not getattr(lib, '_ldl_typed', False):
        vp = ctypes.c_void_p
        lib.ldl_etree.restype = ctypes.c_int32
        lib.ldl_etree.argtypes = [ctypes.c_int32] + [vp] * 5 + [ctypes.c_int64]
        lib.ldl_pattern.restype = None
        lib.ldl_pattern.argtypes = [ctypes.c_int32] + [vp] * 10
        lib.ldl_transpose.restype = None
        lib.ldl_transpose.argtypes = [ctypes.c_int32] + [vp] * 6
        lib.ldl_heights.restype = ctypes.c_int32
        lib.ldl_heights.argtypes = [ctypes.c_int32, vp, vp]
        lib.ldl_node_heights.restype = None
        lib.ldl_node_heights.argtypes = [ctypes.c_int32, vp, vp, vp]
        lib.ldl_group_count.restype = ctypes.c_int32
        lib.ldl_group_count.argtypes = [ctypes.c_int32] * 2 + [vp] * 4
        lib.ldl_group_fill.restype = None
        lib.ldl_group_fill.argtypes = [ctypes.c_int32] * 2 + [vp] * 6
        lib.ldl_thin_rows.restype = ctypes.c_int32
        lib.ldl_thin_rows.argtypes = [ctypes.c_int32] + [vp] * 12
        lib.ldl_pair_count.restype = ctypes.c_int64
        lib.ldl_pair_count.argtypes = [ctypes.c_int32] + [vp] * 4
        lib.ldl_pair_fill.restype = None
        lib.ldl_pair_fill.argtypes = [ctypes.c_int32] * 2 + [vp] * 8
        lib._ldl_typed = True
    return lib


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _p(a):
    return a.ctypes.data


def _etree(n, Ap, Ai, cap=np.iinfo(np.int32).max):
    """Elimination tree and column counts; total nnz(L), or -2 past ``cap``."""
    parent = np.zeros(n, np.int32)
    Lnz = np.zeros(n, np.int32)
    flag = np.zeros(n, np.int32)
    total = _host_lib().ldl_etree(n, _p(Ap), _p(Ai), _p(parent), _p(Lnz), _p(flag), int(cap))
    return int(total), parent, Lnz


def _validate(K, n):
    """The loud failures of the native factor's first symbolic pass: a
    lower-triangular entry or a missing diagonal."""
    cols = np.repeat(np.arange(n), np.diff(K.indptr))
    diag = np.zeros(n, bool)
    diag[K.indices[K.indices == cols]] = True
    if np.any(K.indices > cols) or not diag.all():
        raise ValueError('ldl symbolic analysis failed (matrix must be upper-triangular CSC '
                         'with its diagonal)')


def _fill_reducing_perm(K_triu):
    """Reverse Cuthill-McKee on the symmetrized pattern; None where it is
    the identity (``osqp_tpu/native/ldl.py::_fill_reducing_perm``)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = (K_triu + K_triu.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True), np.int64)
    if np.array_equal(perm, np.arange(K_triu.shape[0])):
        return None
    return perm


class Symbolic(NamedTuple):
    """The host's analysis of one pattern; index arrays are int32 numpy.

    A supernode is a run of at least ``SUPERNODE_MIN`` columns j0..j0+w-1
    where, for each column j but the last, ``parent[j] == j + 1`` and
    column j holds one entry more than column j + 1: column j's rows are
    j + 1 and column j + 1's rows, so the run's columns share one dense
    panel.  Its row list is its columns, then the rows below them, sorted;
    its panel's entry at row position p > c of column c sits in place in
    ``Lx`` at ``Lp[j0 + c] - c - 1 + p`` (CSC), so every layout reads the
    same values.  Every other column is thin."""

    n: int
    perm: Optional[np.ndarray]  # new index -> old index, None for natural
    data_map: Optional[np.ndarray]  # caller's data position of each Ax entry
    Ap: np.ndarray  # the permuted upper triangle, CSC, sorted
    Ai: np.ndarray
    parent: np.ndarray  # elimination tree
    Lp: np.ndarray  # L, CSC (strictly lower, rows sorted)
    Li: np.ndarray
    kmap: np.ndarray  # Ax position of K's entry at each L entry, -1 for fill
    diagpos: np.ndarray  # Ax position of each diagonal entry
    Rp: np.ndarray  # L, CSR (columns sorted)
    Rj: np.ndarray
    csc2csr: np.ndarray
    depth: int  # the elimination tree's depth in nodes
    sn: np.ndarray  # (nsup, 4): first column, width, rows, offset of its row list
    sn_rows: np.ndarray  # the supernodes' row lists, one after another
    snode: np.ndarray  # supernode of each column, -1 for a thin column
    # each earlier supernode t that updates supernode s (for s, rows
    # pair_ptr[s]:pair_ptr[s + 1], t ascending): t, t's first row position
    # in s's rows, the count of t's rows from there (all of them lie in
    # s's rows), offset of their positions in s's row list in relmap
    pairs: np.ndarray
    pair_ptr: np.ndarray
    # each thin column with two or more entries in supernode s's rows that
    # updates s (gsrc_ptr as pair_ptr): column, CSC position of its first
    # such entry, their count, 0 (K5 finds their positions in s's sorted
    # row list: a column's tail would be stored once per supernode it meets)
    gsrc: np.ndarray
    gsrc_ptr: np.ndarray
    relmap: np.ndarray
    # the thin columns' entries in rows that are supernode columns, by row
    # (CSR over all n rows): column, CSR position (the kernels read them in
    # Lr), and 1 where it is the column's only entry in that supernode's
    # rows (it updates the pivot only)
    Tp: np.ndarray
    Tk: np.ndarray
    Tc: np.ndarray
    Tone: np.ndarray
    items: np.ndarray  # (n_items, 2): thin column, first row of the column's chunk
    # K5's launch plan, in order: (0, first item, count) a level of thin
    # columns, (1, first item, count) a chain of levels of one item each
    # walked by one block, (2, s, 0) a supernode
    plan: np.ndarray
    k5_launches: int  # kernel launches of one factorization
    k6_tasks: np.ndarray  # (ntasks, 4): K6's block tasks in ticket order
    k6_src: np.ndarray  # (nsrc, 4): the supernode sources of K6's forward tasks

    @property
    def nnz_L(self) -> int:
        return int(self.Lp[-1])

    @property
    def nsup(self) -> int:
        return len(self.sn)


def symbolic(K_triu, ordering: str = 'rcm') -> Symbolic:
    """Symbolic analysis of the upper triangle ``K_triu`` (scipy, CSC).

    Raises ``ValueError`` for a lower-triangular entry, a missing diagonal
    or both triangles stored, as ``osqp_tpu.native.ldl.LDLFactor`` does."""
    if ordering not in ('rcm', 'natural'):
        raise ValueError(f"ordering must be 'rcm' or 'natural', got {ordering!r}")
    K = sp.csc_matrix(K_triu).copy()
    n = K.shape[0]
    nnz0 = int(K.nnz)
    # canonical sorted form, remembering the caller's data order
    if K.has_sorted_indices:
        sort_map = None
    else:
        tag = sp.csc_matrix((np.arange(1, nnz0 + 1, dtype=np.float64), K.indices.copy(),
                             K.indptr.copy()), shape=K.shape)
        tag.sort_indices()
        sort_map = (tag.data - 1.0).astype(np.int64)
        K.sort_indices()

    _validate(K, n)
    Ap, Ai = _i32(K.indptr), _i32(K.indices)
    # RCM's pass first: the natural pass then stops as soon as its fill
    # passes RCM's (-2), which keeps RCM (a fill past int32 likewise)
    perm, data_map = None, sort_map
    total = -2
    if ordering == 'rcm' and n > 1:
        p = _fill_reducing_perm(K)
        if p is not None:
            Kc = K.tocoo()
            pinv = np.empty(n, np.int64)
            pinv[p] = np.arange(n)
            r_new, c_new = pinv[Kc.row], pinv[Kc.col]
            ids = np.arange(1, Kc.nnz + 1, dtype=np.float64)
            Kp = sp.csc_matrix((ids, (np.minimum(r_new, c_new), np.maximum(r_new, c_new))),
                               shape=(n, n))
            Kp.sort_indices()
            if int(Kp.nnz) != nnz0:
                raise ValueError('input stores both triangles (duplicate entries collapse '
                                 'under symmetric permutation); pass the upper triangle only')
            Ap_r, Ai_r = _i32(Kp.indptr), _i32(Kp.indices)
            total_r, parent_r, Lnz_r = _etree(n, Ap_r, Ai_r)
            if total_r >= 0:
                total, parent, Lnz = _etree(n, Ap, Ai, cap=total_r)
                if total < 0:  # RCM only where it strictly reduces fill
                    rcm_map = (Kp.data - 1.0).astype(np.int64)
                    perm = p
                    data_map = sort_map[rcm_map] if sort_map is not None else rcm_map
                    Ap, Ai, total, parent, Lnz = Ap_r, Ai_r, total_r, parent_r, Lnz_r
    if perm is None and total < 0:
        total, parent, Lnz = _etree(n, Ap, Ai)
    if total < 0:
        raise ValueError('nnz(L) is past int32 in every ordering tried')
    lib = _host_lib()
    Lp = np.zeros(n + 1, np.int32)
    np.cumsum(Lnz, out=Lp[1:])
    Li = np.zeros(max(total, 1), np.int32)
    kmap = np.zeros(max(total, 1), np.int32)
    diagpos = np.zeros(n, np.int32)
    work = [np.zeros(n, np.int32) for _ in range(3)]
    lib.ldl_pattern(n, _p(Ap), _p(Ai), _p(parent), _p(Lp), _p(Li), _p(kmap), _p(diagpos),
                    *(_p(w) for w in work))
    Rp = np.zeros(n + 1, np.int32)
    Rj = np.zeros(max(total, 1), np.int32)
    csc2csr = np.zeros(max(total, 1), np.int32)
    lib.ldl_transpose(n, _p(Lp), _p(Li), _p(Rp), _p(Rj), _p(csc2csr), _p(work[0]))
    depth = int(lib.ldl_heights(n, _p(parent), _p(work[1])))
    Li = Li[:total]
    sup = _supernodes(n, parent, Lp, Li, Rp, Rj[:total])
    plan, items, k5_launches = _k5_plan(n, parent, Lp, sup)
    k6_tasks, k6_src = _k6_tasks(n, sup)
    return Symbolic(n=n, perm=perm, data_map=data_map, Ap=Ap, Ai=Ai, parent=parent, Lp=Lp,
                    Li=Li, kmap=kmap[:total], diagpos=diagpos, Rp=Rp, Rj=Rj[:total],
                    csc2csr=csc2csr[:total], depth=depth, items=items, plan=plan,
                    k5_launches=k5_launches, k6_tasks=k6_tasks, k6_src=k6_src, **sup)


def _ranges(starts, lens) -> np.ndarray:
    """The concatenated ranges [starts[i], starts[i] + lens[i]), int64."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    if not len(lens):
        return np.zeros(0, np.int64)
    step = np.ones(int(lens.sum()), np.int64)
    step[0] = starts[0]
    ends = np.cumsum(lens)[:-1]
    step[ends] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(step)


def _supernodes(n, parent, Lp, Li, Rp, Rj) -> dict:
    """The supernodes (``Symbolic``'s rule), their row lists, the maps from
    each updating supernode's rows into a supernode's row list, and the
    thin columns that update each supernode."""
    Lnz = np.diff(Lp).astype(np.int64)
    nested = np.zeros(n, bool)
    if n > 1:
        nested[:-1] = (parent[:-1] == np.arange(1, n)) & (Lnz[:-1] == Lnz[1:] + 1)
    last = np.flatnonzero(~nested)  # maximal runs end where the rule breaks
    first = np.concatenate([[0], last[:-1] + 1]).astype(np.int64)
    width = last - first + 1
    keep = width >= SUPERNODE_MIN
    first, width = first[keep], width[keep]
    nsup = len(first)
    nrows = Lnz[first] + 1
    rptr = np.zeros(nsup + 1, np.int64)
    np.cumsum(nrows, out=rptr[1:])
    sn_rows = np.empty(int(rptr[-1]), np.int64)
    sn_rows[rptr[:-1]] = first
    below = np.ones(len(sn_rows), bool)
    below[rptr[:-1]] = False
    sn_rows[below] = Li[_ranges(Lp[first], Lnz[first])]
    snode = np.full(n, -1, np.int32)
    snode[_ranges(first, width)] = np.repeat(np.arange(nsup), width)
    sn = _i32(np.stack([first, width, nrows, rptr[:-1]], axis=1).reshape(-1, 4))
    sn_rows = _i32(sn_rows)
    lib = _host_lib()

    # supernode t updates supernode s where t's rows meet s's columns: from
    # the first such row on, all of t's rows lie in s's row list
    pair_ptr = np.zeros(nsup + 1, np.int32)
    nmap = lib.ldl_pair_count(nsup, _p(sn), _p(sn_rows), _p(snode), _p(pair_ptr))
    pairs = np.zeros((int(pair_ptr[-1]), 4), np.int32)
    relmap = np.zeros(nmap, np.int32)
    work, cursor = np.zeros(n, np.int32), np.zeros(nsup, np.int32)
    lib.ldl_pair_fill(n, nsup, _p(sn), _p(sn_rows), _p(snode), _p(pair_ptr), _p(pairs),
                      _p(relmap), _p(work), _p(cursor))

    # the thin columns with two or more entries in a supernode's rows
    gsrc_ptr = np.zeros(nsup + 1, np.int32)
    gsrc = np.zeros((lib.ldl_group_count(n, nsup, _p(Lp), _p(Li), _p(snode), _p(gsrc_ptr)), 4),
                    np.int32)
    lib.ldl_group_fill(n, nsup, _p(Lp), _p(Li), _p(snode), _p(gsrc_ptr), _p(gsrc), _p(cursor))
    # the thin entries of the supernodes' columns' rows, by row
    Tp = np.zeros(n + 1, np.int32)
    nthin = lib.ldl_thin_rows(n, _p(sn), _p(Lp), _p(Li), _p(Rp), _p(Rj), _p(snode), _p(Tp),
                              None, None, None, None, None)
    Tk, Tc = np.zeros(nthin, np.int32), np.zeros(nthin, np.int32)
    Tone = np.zeros(nthin, np.uint8)
    work2 = np.zeros(n, np.int32)
    lib.ldl_thin_rows(n, _p(sn), _p(Lp), _p(Li), _p(Rp), _p(Rj), _p(snode), _p(Tp), _p(Tk),
                      _p(Tc), _p(Tone), _p(work), _p(work2))
    return dict(sn=sn, sn_rows=sn_rows, snode=snode, pairs=pairs, pair_ptr=pair_ptr, gsrc=gsrc,
                gsrc_ptr=gsrc_ptr, relmap=relmap, Tp=Tp, Tk=Tk, Tc=Tc, Tone=Tone)


def _supernode_launches(sup: dict, s: int) -> int:
    """K5's launches for supernode s: its columns' start (K's values and
    the one-entry thin updates), the gathered panel of its thin sources,
    the update by its sources, and per TILE-wide panel of its columns the
    diagonal block's launch, the rows below it where there are any, and a
    trailing update after each panel but the last."""
    ng = int(sup['gsrc_ptr'][s + 1] - sup['gsrc_ptr'][s])
    npairs = int(sup['pair_ptr'][s + 1] - sup['pair_ptr'][s])
    _, w, nrows, _ = (int(v) for v in sup['sn'][s])
    steps = -(-w // TILE)
    below = steps - (nrows == w)  # the last panel of a root has no rows below
    return 1 + (ng > 0) + (ng > 0 or npairs > 0) + 2 * steps - 1 + below


def _k5_plan(n, parent, Lp, sup):
    """K5's launch plan over the heights of the tree of tasks (thin columns
    and supernodes): per height a launch for its thin columns' items and
    the supernodes' launches, where a run of heights of one item each (a
    chain of short thin columns) becomes one launch of one block.  Returns
    (plan, items, launches)."""
    sn, snode = sup['sn'], sup['snode']
    node = np.arange(n, dtype=np.int32)
    node[_ranges(sn[:, 0], sn[:, 1])] = np.repeat(sn[:, 0], sn[:, 1])
    height = np.zeros(n, np.int32)
    _host_lib().ldl_node_heights(n, _p(_i32(parent)), _p(node), _p(height))
    heads = np.flatnonzero(node == np.arange(n))
    heads = heads[np.lexsort((heads, height[heads]))]
    h = height[heads]
    nlev = int(h[-1]) + 1 if n else 0
    is_thin = snode[heads] < 0
    thin_cols = heads[is_thin]
    nthin = np.bincount(h[is_thin], minlength=nlev)
    nsupl = np.bincount(h[~is_thin], minlength=nlev)
    Lnz = np.diff(Lp).astype(np.int64)
    chunks = np.maximum(1, -(-Lnz[thin_cols] // ROWS_PER_ITEM))
    cols = np.repeat(thin_cols, chunks)
    starts = np.repeat(np.cumsum(chunks) - chunks, chunks)
    rows = (np.arange(len(cols)) - starts) * ROWS_PER_ITEM
    items = _i32(np.stack([cols, rows], axis=1)) if len(cols) else np.zeros((0, 2), np.int32)
    item_ptr = np.zeros(nlev + 1, np.int64)
    np.cumsum(np.bincount(h[is_thin], weights=chunks, minlength=nlev), out=item_ptr[1:])
    sup_at = snode[heads[~is_thin]]  # supernodes in height order
    # a height of one item (one thin column of at most ROWS_PER_ITEM rows):
    # runs of them are walked by one block; a longer column keeps its
    # launch, where its items run side by side
    single = (np.diff(item_ptr) == 1) & (nsupl == 0)
    edge = np.diff(np.r_[0, single.astype(np.int8), 0])
    run0, run1 = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    lev = np.flatnonzero(~single & (nthin > 0))
    # the ops, ordered by height, then a height's thin launch before its
    # supernodes (in order)
    height_of = np.r_[run0, lev, h[~is_thin]]
    sub = np.r_[np.zeros(len(run0) + len(lev), np.int64), 1 + np.arange(len(sup_at))]
    ops = np.stack([
        np.r_[np.ones(len(run0), np.int64), np.zeros(len(lev), np.int64),
              np.full(len(sup_at), 2, np.int64)],
        np.r_[item_ptr[run0], item_ptr[lev], sup_at],
        np.r_[item_ptr[run1] - item_ptr[run0], item_ptr[lev + 1] - item_ptr[lev],
              np.zeros(len(sup_at), np.int64)]], axis=1)
    plan = ops[np.lexsort((sub, height_of))]
    launches = len(run0) + len(lev) + sum(_supernode_launches(sup, s) for s in range(len(sn)))
    return _i32(plan.reshape(-1, 3)), items, launches


def _k6_tasks(n, sup):
    """K6's block tasks in ticket order, forward then backward: (0, first
    row, count) up to SOLVE_WARPS thin rows, one warp each; (1, s, r,
    first source) the r-th TILE rows of supernode s; (2, last column,
    count) up to SOLVE_WARPS thin columns from the last; (3, s, r, 0).
    A forward tile's sources (``k6_src``: supernode, first and end row
    position, 0) are each earlier supernode whose rows meet the tile's, in
    order, then the supernode itself up to the tile, ended by -1."""
    sn, pairs, pair_ptr, relmap = sup['sn'], sup['pairs'], sup['pair_ptr'], sup['relmap']
    bounds = [(int(j0), int(j0 + w), s) for s, (j0, w, _, _) in enumerate(sn)]
    segs, j = [], 0  # thin runs (a, b, -1) and supernodes (j0, j0 + w, s)
    for a, b, s in bounds:
        if a > j:
            segs.append((j, a, -1))
        segs.append((a, b, s))
        j = b
    if j < n:
        segs.append((j, n, -1))
    fwd, bwd, src = [], [], []

    def thin(kind, x, count):
        return np.stack([np.full(len(x), kind), x, count, np.zeros(len(x), np.int64)], axis=1)

    for a, b, s in segs:
        if s < 0:
            x = np.arange(a, b, SOLVE_WARPS)
            fwd.append(thin(0, x, np.minimum(SOLVE_WARPS, b - x)))
            continue
        w = b - a
        for r in range(-(-w // TILE)):
            lo_p, hi_p = r * TILE, min(w, (r + 1) * TILE)
            fwd.append(np.array([(1, s, r, len(src))]))
            for t, at, cnt, off in pairs[pair_ptr[s]:pair_ptr[s + 1]]:
                rm = relmap[off:off + cnt]
                lo, hi = np.searchsorted(rm, lo_p), np.searchsorted(rm, hi_p)
                if hi > lo:
                    src.append((int(t), int(at + lo), int(at + hi), 0))
            src.append((s, lo_p, hi_p, 0))
            src.append((-1, 0, 0, 0))
    for a, b, s in reversed(segs):
        if s < 0:
            x = np.arange(b - 1, a - 1, -SOLVE_WARPS)
            bwd.append(thin(2, x, np.minimum(SOLVE_WARPS, x - a + 1)))
            continue
        bwd.append(np.array([(3, s, r, 0) for r in reversed(range(-(-(b - a) // TILE)))]))
    tasks = np.concatenate(fwd + bwd) if fwd else np.zeros((0, 4), np.int64)
    return _i32(tasks), _i32(np.array(src, np.int64).reshape(-1, 4))


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the card's checks)
# ---------------------------------------------------------------------------


def _entry_cols(ptr: torch.Tensor) -> torch.Tensor:
    """The column of each entry of a CSC pattern."""
    n = ptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device), ptr[1:] - ptr[:-1])


def dense_kkt(Ap, Ai, Ax, n):
    """The full symmetric matrix of a permuted upper triangle (tensors)."""
    K = Ax.new_zeros((n, n))
    rows, cols = Ai.long(), _entry_cols(Ap.long())
    K[rows, cols] = Ax
    K[cols, rows] = Ax
    return K


def dense_l(Lp, Li, Lx, n):
    """L (unit lower triangular) as a dense tensor from its CSC pattern."""
    L = torch.eye(n, dtype=Lx.dtype, device=Lx.device)
    L[Li.long(), _entry_cols(Lp.long())] = Lx
    return L


def ldl_factor_plain(Ap, Ai, Ax, Lp, Li, n, block: int = PLAIN_BLOCK):
    """The numeric factorization in plain torch ops: a blocked left-looking
    loop over the columns of a dense copy of K (a product with all earlier
    columns per block, then column by column inside it).  Returns
    ``(Lx, D, Dinv, L)``: L's values read back into the symbolic pattern and
    the dense L.  Entries outside the pattern come out exact zeros (every
    product there has a structural-zero factor).  No pivot check."""
    K = dense_kkt(Ap, Ai, Ax, n)
    L = torch.eye(n, dtype=Ax.dtype, device=Ax.device)
    D = Ax.new_zeros(n)
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        C = K[j0:, j0:j1]
        if j0:
            C = C - L[j0:, :j0] @ (D[:j0, None] * L[j0:j1, :j0].T)
        for j in range(j0, j1):
            c = j - j0
            col = C[c:, c]
            if j > j0:
                col = col - L[j:, j0:j] @ (D[j0:j] * L[j, j0:j])
            D[j] = col[0]
            L[j + 1:, j] = col[1:] / col[0]
    Lx = L[Li.long(), _entry_cols(Lp.long())]
    return Lx, D, 1.0 / D, L


def ldl_solve_plain(L, Dinv, perm, b):
    """``x = P' L'^-1 D^-1 L^-1 P b`` with two dense triangular solves
    (``perm``: new index -> old index, or None)."""
    bp = b[perm] if perm is not None else b
    y = torch.linalg.solve_triangular(L, bp[:, None], upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(L.T, Dinv[:, None] * y, upper=True, unitriangular=True)
    x = x[:, 0]
    if perm is None:
        return x
    out = torch.empty_like(x)
    out[perm] = x
    return out


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


_FACTOR_ARGS = ('plan', 'sn_host', 'pair_ptr', 'gsrc_ptr', 'sn', 'sn_rows', 'items', 'Lp', 'Li',
                'Rp', 'Rj', 'kmap', 'diagpos', 'csc2csr', 'Ax', 'Lx', 'Lr', 'D', 'Dinv', 'work',
                'stats', 'Tp', 'Tk', 'Tc', 'Tone', 'pairs', 'gsrc', 'relmap', 'G', 'Dg')
_SOLVE_ARGS = ('tasks', 'src', 'sn', 'sn_rows', 'Rp', 'Rj', 'Lr', 'Lp', 'Li', 'Lx', 'Dinv', 'Tp',
               'Tk', 'Tc', 'perm', 'b', 'out', 'y', 'ticket')


class _FactorArgs(ctypes.Structure):
    """``LdlFactorArgs`` of ``csrc/ldl_factor.cu``."""

    _fields_ = ([(k, ctypes.c_int) for k in ('n', 'gmax', 'nops', 'nsup')]
                + [(k, ctypes.c_void_p) for k in _FACTOR_ARGS])


class _SolveArgs(ctypes.Structure):
    """``LdlSolveArgs`` of ``csrc/ldl_solve.cu``."""

    _fields_ = ([('n', ctypes.c_int), ('ntasks', ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in _SOLVE_ARGS] + [('base', ctypes.c_ulonglong)])


def _factor_fn():
    from . import _build

    fn = _build.load_library('ldl_factor').ldl_factor_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_FactorArgs), ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def _solve_fn():
    from . import _build

    fn = _build.load_library('ldl_solve').ldl_solve_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_SolveArgs), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class LDLFactor:
    """LDL' of a quasi-definite symmetric matrix given by its upper triangle
    (scipy CSC), on ``device``.

    ``n_positive`` is the inertia (the non-convexity detector: the ADMM KKT
    matrix must have n_x positive pivots).  ``update_values`` and ``solve``
    speak the caller's order, whatever the ordering chosen; ``ordering``
    ('rcm' or 'natural') is the JAX package's ``OSQP_TPU_LDL_ORDERING``.
    On the card the factorization is K5 and the solve K6; on the CPU their
    plain versions, up to ``CPU_MAX_N``."""

    def __init__(self, K_triu, device=None, ordering: str = 'rcm', values=None):
        K = sp.csc_matrix(K_triu)
        with tracing.span('ldl.symbolic'):  # the host analysis and the pattern's copies
            self.sym = symbolic(K, ordering)
            self.n = self.sym.n
            self.device = resolve_device(device)
            self._cuda = self.device.type == 'cuda'
            if not self._cuda and self.n > CPU_MAX_N:
                raise ValueError(f'the plain LDL factorization densifies: n = {self.n} is '
                                 f'past the CPU limit {CPU_MAX_N}')
            s = self.sym
            dev = self.device

            def i32(a):
                return torch.as_tensor(_i32(a), device=dev)

            self._Ap, self._Ai, self._Lp, self._Li = i32(s.Ap), i32(s.Ai), i32(s.Lp), i32(s.Li)
            self._perm = None if s.perm is None else torch.as_tensor(s.perm, device=dev)
            self._data_map = (None if s.data_map is None
                              else torch.as_tensor(s.data_map, device=dev))
            nnz = max(s.nnz_L, 1)
            f64 = dict(dtype=torch.float64, device=dev)
            self.Lx = torch.zeros(nnz, **f64)
            self.D = torch.zeros(self.n, **f64)
            self.Dinv = torch.zeros(self.n, **f64)
            self._L_dense = None
            if self._cuda:
                self.Ax = torch.zeros(len(s.Ai), **f64)
                self._init_cuda()
            self.n_positive = None
        with tracing.span('ldl.factor'):
            self.update_values(K.data if values is None else values)

    def _init_cuda(self):
        """The pattern, the supernodes and the schedules on the card, K5's and
        K6's workspaces, and their argument blocks (the pointers stay fixed:
        ``update_values`` copies new values into ``Ax``)."""
        s, dev = self.sym, self.device

        def t(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        f64 = dict(dtype=torch.float64, device=dev)
        nnz = max(s.nnz_L, 1)
        self.Lr = torch.zeros(nnz, **f64)  # L's values in CSR order
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        self._gmax = n_sm * BLOCKS_PER_SM
        nrows = s.sn[:, 2].astype(np.int64)
        ng = np.diff(s.gsrc_ptr).astype(np.int64)
        # the host's copies the launcher reads, kept alive with the factor
        self._host = dict(plan=_i32(s.plan), sn_host=_i32(s.sn), pair_ptr=_i32(s.pair_ptr),
                          gsrc_ptr=_i32(s.gsrc_ptr))
        self._dev = dict(
            sn=t(s.sn), items=t(s.items), Lp=self._Lp, Li=self._Li, Rp=t(s.Rp), Rj=t(s.Rj),
            kmap=t(s.kmap), diagpos=t(s.diagpos), csc2csr=t(s.csc2csr), Ax=self.Ax,
            Lx=self.Lx, Lr=self.Lr, D=self.D, Dinv=self.Dinv,
            # the thin columns' workspaces, all zero between factorizations
            work=torch.zeros(self._gmax * max(self.n, 1), **f64),
            stats=torch.zeros(2, dtype=torch.int32, device=dev),
            Tp=t(s.Tp), Tk=t(s.Tk), Tc=t(s.Tc), Tone=t(s.Tone, torch.uint8), pairs=t(s.pairs),
            gsrc=t(s.gsrc), relmap=t(s.relmap),
            G=torch.zeros(max(int((nrows * ng).max()) if len(ng) else 0, 1), **f64),
            Dg=torch.zeros(max(int(ng.max()) if len(ng) else 0, 1), **f64),
            tasks=t(s.k6_tasks), src=t(s.k6_src), sn_rows=t(s.sn_rows),
            # K6's scratch: the two passes' vectors (y, then x) and its ticket
            y=torch.zeros(2 * max(self.n, 1), **f64),
            ticket=torch.zeros(1, dtype=torch.int64, device=dev))
        self._fargs = _FactorArgs(self.n, self._gmax, len(s.plan), s.nsup, *(
            self._host[k].ctypes.data if k in self._host else self._dev[k].data_ptr()
            for k in _FACTOR_ARGS))
        # K6: supernode tiles take dynamic shared memory (ldl_solve.cu: a tile's
        # triangle and the forward pass's sums)
        self._solve_smem = (TILE * TILE + 6 * TILE) * 8 if s.nsup else 0
        self._solves = 0

    @property
    def perm(self):
        return self.sym.perm

    @property
    def Lp(self):
        return self.sym.Lp

    def values(self, new_data) -> torch.Tensor:
        """The caller-order values permuted into the factor's Ax order."""
        data = torch.as_tensor(new_data, dtype=torch.float64, device=self.device)
        return data[self._data_map] if self._data_map is not None else data.clone()

    def update_values(self, new_data):
        """Numeric-only refactorization with new values on the same pattern,
        given in the caller's triu-CSC data order (tensor or array).  Raises
        ``ZeroDivisionError`` on a zero pivot."""
        Ax = self.values(new_data)
        if self._cuda:  # K5's argument block holds this buffer
            self.Ax.copy_(Ax)
        else:
            self.Ax = Ax
        self.factor()

    def factor(self):
        """The numeric factorization of the current values ``Ax``."""
        if self._cuda:
            npos, zero = self._factor_cuda()
        else:
            Lx, D, Dinv, L = ldl_factor_plain(self._Ap, self._Ai, self.Ax, self._Lp, self._Li,
                                              self.n)
            self.Lx[:Lx.numel()] = Lx
            self.D, self.Dinv, self._L_dense = D, Dinv, L
            zeros = torch.nonzero(D == 0)
            zero = int(zeros[0, 0]) if zeros.numel() else -1
            npos = int((D > 0).sum())
        if zero >= 0:
            raise ZeroDivisionError(f'zero pivot at column {zero}')
        self.n_positive = npos

    def _factor_cuda(self):
        """K5; then one host sync reads the positive pivots and the first
        zero pivot (-1 if none)."""
        self.launch_factor()
        stats = self._dev['stats']
        with tracing.span('sync', d2h=stats.nbytes):
            npos, zero_rev = (int(v) for v in stats.cpu())
        return npos, (self.n - zero_rev if zero_rev > 0 else -1)

    def launch_factor(self):
        """Enqueue K5 on the current stream, with no sync (``factor`` reads
        its pivots after it)."""
        global factor_launches, factor_calls
        stream = torch.cuda.current_stream(self.device).cuda_stream
        launched = ctypes.c_int(0)
        rc = _factor_fn()(ctypes.byref(self._fargs), stream, ctypes.byref(launched))
        factor_launches += launched.value
        if rc != 0:
            raise RuntimeError(f'ldl_factor launch failed: CUDA error {rc}')
        factor_calls += 1

    def solve(self, b) -> torch.Tensor:
        """``K^-1 b`` for a vector ``b`` on the factor's device, in the
        caller's order: K6 on the card, the plain solve on the CPU."""
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        if b.shape != (self.n,):
            raise ValueError(f'b must have shape ({self.n},), got {tuple(b.shape)}')
        if not self._cuda:
            return ldl_solve_plain(self._L_dense, self.Dinv, self._perm, b)
        return self._solve_cuda(b.contiguous())

    def _solve_cuda(self, b):
        global solve_launches
        out = torch.empty_like(b)
        if self.n == 0:
            return out
        self._solves += 1
        d = self._dev
        ptrs = dict(d, perm=self._perm, b=b, out=out)
        args = _SolveArgs(self.n, len(self.sym.k6_tasks),
                          *(0 if ptrs[k] is None else ptrs[k].data_ptr() for k in _SOLVE_ARGS),
                          (self._solves - 1) * len(self.sym.k6_tasks))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _solve_fn()(ctypes.byref(args), self._solve_smem, stream)
        if rc != 0:
            raise RuntimeError(f'ldl_solve launch failed: CUDA error {rc}')
        solve_launches += 1
        return out

    def dense_L(self) -> torch.Tensor:
        """The dense unit lower triangular L of the current factorization."""
        return dense_l(self._Lp, self._Li, self.Lx[:self.sym.nnz_L], self.n)
