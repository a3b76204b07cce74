"""Sparse LDL' of a quasi-definite symmetric matrix: the host's symbolic
analysis, the card's numeric factorization (K5) and triangular solves (K6),
and their plain PyTorch versions.

Counterpart of ``osqp_tpu/native/ldl.py::LDLFactor`` (the QDLDL-class
direct solver of the ``numpy`` algebra) and of ``native/ldl.cpp``.  The JAX
package runs that factorization on the host; it has no Pallas kernel, so K5
and K6 replace no TPU kernel: they move the numpy algebra's linear-system
core onto the card.

- Symbolic (host, ``csrc/ldl_host.cpp``, built by g++): the elimination
  tree and column counts, the pattern of L in CSC and in CSR, and the
  choice between reverse Cuthill-McKee and the natural ordering by symbolic
  fill, keeping RCM only where it strictly reduces nnz(L) (the JAX
  package's rule).  The caller's data order is kept through a map, for
  unsorted indices and for the permutation.
- K5 (``csrc/ldl_factor.cu``): the numeric factorization in float64 into
  that pattern, one launch per height of the elimination tree.  It writes L
  in both layouts, D, 1/D and the count of positive pivots, which one host
  sync reads (a zero pivot raises ``ZeroDivisionError``).
- K6 (``csrc/ldl_solve.cu``): ``x = P' L'^-1 D^-1 L^-1 P b`` in float64, one
  launch whatever the tree's depth.

``LDLFactor`` launches K5 and K6 for CUDA tensors (and raises if it cannot)
and runs the plain versions for CPU tensors, up to ``CPU_MAX_N``: the plain
factorization is a blocked left-looking loop over the columns of a dense
copy, the plain solve two dense triangular solves.  On the card
``factor_launches`` counts K5's launches (the launcher adds one for each,
one per height of the tree), ``factor_calls`` the numeric factorizations
and ``solve_launches`` K6's launches, one a solve.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

# Counts on the card since the last reset, read by chip_smoke.py: K5's
# launches, its calls (numeric factorizations) and K6's launches.
factor_launches = 0
factor_calls = 0
solve_launches = 0

# The plain versions densify: past this order the CPU path raises.
CPU_MAX_N = 16_384
ROWS_PER_ITEM = 32  # rows of one column a K5 block takes (kRows in ldl_factor.cu)
BLOCKS_PER_SM = 4  # K5's resident blocks per SM, one workspace of n doubles each
SOLVE_WARPS = 8  # K6's warps per block (kWarps in ldl_solve.cu)
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
    """The host's analysis of one pattern; index arrays are int32 numpy."""

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
    level_ptr: np.ndarray  # K5's items of height h: items[level_ptr[h]:level_ptr[h + 1]]
    items: np.ndarray  # (n_items, 2): column, first row of the column's chunk

    @property
    def nnz_L(self) -> int:
        return int(self.Lp[-1])

    @property
    def depth(self) -> int:
        """The elimination tree's depth in nodes: K5's launches."""
        return len(self.level_ptr) - 1


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
    height = np.zeros(n, np.int32)
    n_levels = lib.ldl_heights(n, _p(parent), _p(height))

    # K5's work items: each column cut into chunks of ROWS_PER_ITEM rows (at
    # least one, which also writes the pivot), grouped by height
    order = np.argsort(height, kind='stable')
    chunks = np.maximum(1, -(-Lnz // ROWS_PER_ITEM)).astype(np.int64)
    per_col = chunks[order]
    cols = np.repeat(order, per_col)
    starts = np.repeat(np.cumsum(per_col) - per_col, per_col)
    rows = (np.arange(len(cols)) - starts) * ROWS_PER_ITEM
    items = _i32(np.stack([cols, rows], axis=1)) if n else np.zeros((0, 2), np.int32)
    level_ptr = np.zeros(n_levels + 1, np.int64)
    np.cumsum(np.bincount(height, weights=chunks, minlength=n_levels), out=level_ptr[1:])
    return Symbolic(n=n, perm=perm, data_map=data_map, Ap=Ap, Ai=Ai, parent=parent, Lp=Lp,
                    Li=Li[:total], kmap=kmap[:total], diagpos=diagpos, Rp=Rp, Rj=Rj[:total],
                    csc2csr=csc2csr[:total], level_ptr=_i32(level_ptr), items=items)


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


def _vp(t):
    return ctypes.c_void_p(t.data_ptr())


def _factor_fn():
    from . import _build

    fn = _build.load_library('ldl_factor').ldl_factor_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       vp, vp, vp, vp, ctypes.c_int, vp, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def _solve_fn():
    from . import _build

    fn = _build.load_library('ldl_solve').ldl_solve_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       ctypes.c_ulonglong, ctypes.c_int, vp]
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
        t0 = time.perf_counter()
        K = sp.csc_matrix(K_triu)
        self.sym = symbolic(K, ordering)
        self.n = self.sym.n
        self.device = resolve_device(device)
        self._cuda = self.device.type == 'cuda'
        if not self._cuda and self.n > CPU_MAX_N:
            raise ValueError(f'the plain LDL factorization densifies: n = {self.n} is past '
                             f'the CPU limit {CPU_MAX_N}')
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
            self._Rp, self._Rj = i32(s.Rp), i32(s.Rj)
            self._kmap, self._diagpos, self._csc2csr = i32(s.kmap), i32(s.diagpos), i32(s.csc2csr)
            self._items = i32(s.items)
            self._level_ptr = _i32(s.level_ptr)  # read by the host launcher
            self.Lr = torch.zeros(nnz, **f64)  # L's values in CSR order
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            self._gmax = n_sm * BLOCKS_PER_SM
            # K5's workspaces, all zero between factorizations
            self._work = torch.zeros(self._gmax * max(self.n, 1), **f64)
            self._stats = torch.zeros(2, dtype=torch.int32, device=dev)
            # K6's scratch: the two passes' vectors (y, then x) and its ticket
            self._yx = torch.zeros(2 * max(self.n, 1), **f64)
            self._ticket = torch.zeros(1, dtype=torch.int64, device=dev)
            self._solve_grid = max(-(-2 * self.n // SOLVE_WARPS), 1)
            self._solves = 0
        self.n_positive = None
        self.symbolic_s = time.perf_counter() - t0  # host analysis and the pattern's copies
        self.update_values(K.data if values is None else values)

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
        ``ZeroDivisionError`` on a zero pivot.  ``factor_s`` is its time on
        the host clock (on the card up to the sync that reads the pivots)."""
        self.Ax = self.values(new_data)
        self.factor()

    def factor(self):
        """The numeric factorization of the current values ``Ax``."""
        t0 = time.perf_counter()
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
        self.factor_s = time.perf_counter() - t0
        if zero >= 0:
            raise ZeroDivisionError(f'zero pivot at column {zero}')
        self.n_positive = npos

    def _factor_cuda(self):
        """K5; then one host sync reads the positive pivots and the first
        zero pivot (-1 if none)."""
        self.launch_factor()
        npos, zero_rev = (int(v) for v in self._stats.cpu())
        return npos, (self.n - zero_rev if zero_rev > 0 else -1)

    def launch_factor(self):
        """Enqueue K5 on the current stream, with no sync (``factor`` reads
        its pivots after it)."""
        global factor_launches, factor_calls
        s = self.sym
        stream = torch.cuda.current_stream(self.device).cuda_stream
        launched = ctypes.c_int(0)
        rc = _factor_fn()(
            s.depth, self._level_ptr.ctypes.data, self._gmax, _vp(self._items), _vp(self._Lp),
            _vp(self._Li), _vp(self._Rp), _vp(self._Rj), _vp(self._kmap), _vp(self._diagpos),
            _vp(self._csc2csr), _vp(self.Ax), _vp(self.Lx), _vp(self.Lr), _vp(self.D),
            _vp(self.Dinv), _vp(self._work), _vp(self._stats), self.n, stream,
            ctypes.byref(launched))
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
        base = (self._solves - 1) * self._solve_grid * SOLVE_WARPS
        stream = torch.cuda.current_stream(self.device).cuda_stream
        perm = _vp(self._perm) if self._perm is not None else ctypes.c_void_p(0)
        rc = _solve_fn()(
            self.n, _vp(self._Rp), _vp(self._Rj), _vp(self.Lr), _vp(self._Lp), _vp(self._Li),
            _vp(self.Lx), _vp(self.Dinv), perm, _vp(b), _vp(out), _vp(self._yx),
            _vp(self._ticket), base, self._solve_grid, stream)
        if rc != 0:
            raise RuntimeError(f'ldl_solve launch failed: CUDA error {rc}')
        solve_launches += 1
        return out

    def dense_L(self) -> torch.Tensor:
        """The dense unit lower triangular L of the current factorization."""
        return dense_l(self._Lp, self._Li, self.Lx[:self.sym.nnz_L], self.n)
