"""Sparse matrix operators for the indirect (PCG) path: ``osqp_tpu/ops/spmv.py``
on torch tensors.

Four operator classes with one surface (``@`` on a vector, ``.T``,
``astype``, ``diag()``, ``gram_diag(rho)``, ``shape``, ``dtype``,
``device``), each holding its transpose too, so ``S.T @ y`` costs what
``S @ v`` costs:

- ``DiaMatrix``: the distinct non-zero diagonals (bands), for banded
  patterns; products go through ``ops.dia_matvec`` (K2);
- ``EllMatrix``: padded rows (ELLPACK), for even row occupancy; products go
  through ``ops.ell_matvec`` (K3);
- ``BsrMatrix``: block-ELL with dense (8, 128) blocks, for clustered
  patterns; products go through ``ops.bsr_matvec`` (K4);
- ``CooMatrix``: the fallback for ragged patterns (the JAX package's BCOO),
  held as ``torch.sparse_csr_tensor``s whose products are ``torch.sparse``'s
  (cuSPARSE on the card).

Each kernel wrapper launches its hand-written CUDA kernel on the card and
runs its plain version on the CPU.  A ``'dense'`` operator is a plain tensor
(``@`` is ``torch.matmul``).

``choose_format`` is a copy of the JAX package's format ladder, thresholds
and cost helpers unchanged (including the 4-byte dense size and the TPU's
(8, 128) blocks), so both packages pick the same format for the same
pattern; its environment knobs are arguments here.  ``from_scipy`` builds
every format.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..settings import np_dtype
from .bsr_matvec import C as _BSR_C, R as _BSR_R, block_counts, bsr_matvec
from .dia_matvec import dia_matvec
from .ell_matvec import ell_matvec, lanes_log2, row_lens
from .library import LibraryOperator

DENSE_BUDGET_BYTES = 2_000_000_000
FORMATS = ('auto', 'dia', 'bsr', 'dense', 'ell', 'bcoo')


class DiaMatrix:
    """Diagonal-storage sparse matrix of shape (m, n).

    ``bands[d, i] = S[i, i + offsets[d]]`` (zero where out of range).  The
    offsets are kept as a tuple for the host and as an int32 tensor on the
    bands' device for the kernel.
    """

    def __init__(self, bands, offsets, bands_t, offsets_t, shape):
        self.bands = bands                  # (D, m)
        self.offsets = tuple(int(o) for o in offsets)
        self.bands_t = bands_t              # (Dt, n)
        self.offsets_t = tuple(int(o) for o in offsets_t)
        self.shape = tuple(shape)
        dev = bands.device
        self._off = torch.tensor(self.offsets, dtype=torch.int32, device=dev)
        self._off_t = torch.tensor(self.offsets_t, dtype=torch.int32, device=dev)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self):
        return self.bands.device

    @property
    def T(self):
        return DiaMatrix(self.bands_t, self.offsets_t, self.bands, self.offsets,
                         (self.shape[1], self.shape[0]))

    def astype(self, dtype):
        return DiaMatrix(self.bands.to(dtype), self.offsets, self.bands_t.to(dtype),
                         self.offsets_t, self.shape)

    def __matmul__(self, v):
        if v.dim() != 1:
            raise TypeError('DiaMatrix only supports matrix-vector products')
        return dia_matvec(self.bands, self._off, v)

    def diag(self):
        """Main diagonal (square matrices)."""
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros((self.shape[0],), dtype=self.dtype, device=self.device)

    def gram_diag(self, rho):
        """diag(S' diag(rho) S): the same shifted multiply-add on the squared
        transpose bands."""
        return dia_matvec(self.bands_t * self.bands_t, self._off_t, rho)


def _dia_arrays(S, dtype):
    C = S.tocoo()
    m, n = C.shape
    off = C.col.astype(np.int64) - C.row.astype(np.int64)
    offs = np.unique(off) if C.nnz else np.zeros((0,), np.int64)
    bands = np.zeros((len(offs), m), dtype=dtype)
    if C.nnz:
        np.add.at(bands, (np.searchsorted(offs, off), C.row), C.data)
    return bands, tuple(int(o) for o in offs)


def dia_from_scipy(S, dtype=torch.float32, device='cpu'):
    """A DiaMatrix (with its transpose bands) from any scipy sparse matrix;
    the bands are packed on the host at ``dtype`` and moved to ``device``."""
    f = np_dtype(dtype)
    bands, offs = _dia_arrays(S, f)
    bands_t, offs_t = _dia_arrays(S.T, f)
    return DiaMatrix(torch.as_tensor(bands, device=device), offs,
                     torch.as_tensor(bands_t, device=device), offs_t, S.shape)


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


class EllMatrix:
    """Padded-row (ELLPACK) sparse matrix of shape (m, n).

    ``data[i, k]`` and ``cols[i, k]`` hold up to K entries of row i, padded
    with zero data at column 0; ``data_t`` and ``cols_t`` hold the
    transpose's, so both orientations are a row gather.  ``lens`` (``(m,)``
    int32) counts the slots of each row before its trailing pads and
    ``log2g`` is the kernel's lanes per row, both computed here unless given
    (``.T`` swaps them with the transpose's, ``astype`` keeps them)."""

    def __init__(self, data, cols, data_t, cols_t, shape, lens=None, lens_t=None, log2g=None,
                 log2g_t=None):
        self.data = data          # (m, K)
        self.cols = cols          # (m, K) int32
        self.data_t = data_t      # (n, Kt)
        self.cols_t = cols_t      # (n, Kt) int32
        self.shape = tuple(shape)
        self.lens = row_lens(data, cols) if lens is None else lens            # (m,) int32
        self.lens_t = row_lens(data_t, cols_t) if lens_t is None else lens_t  # (n,) int32
        self.log2g = lanes_log2(self.lens) if log2g is None else log2g
        self.log2g_t = lanes_log2(self.lens_t) if log2g_t is None else log2g_t

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def T(self):
        return EllMatrix(self.data_t, self.cols_t, self.data, self.cols,
                         (self.shape[1], self.shape[0]), self.lens_t, self.lens, self.log2g_t,
                         self.log2g)

    def astype(self, dtype):
        return EllMatrix(self.data.to(dtype), self.cols, self.data_t.to(dtype), self.cols_t,
                         self.shape, self.lens, self.lens_t, self.log2g, self.log2g_t)

    def __matmul__(self, v):
        if v.dim() != 1:
            raise TypeError('EllMatrix only supports matrix-vector products')
        return ell_matvec(self.data, self.cols, v, self.lens, self.log2g)

    def diag(self):
        """Main diagonal (square matrices)."""
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype, device=self.device)[:, None]
        return torch.where(self.cols == rows, self.data, 0.0).sum(1)

    def gram_diag(self, rho):
        """diag(S' diag(rho) S): the transpose's squared data times rho (a
        squared pad is a pad, so the transpose's counts hold)."""
        return ell_matvec(self.data_t * self.data_t, self.cols_t, rho, self.lens_t,
                          self.log2g_t)

    def todense(self):
        m, n = self.shape
        rows = torch.arange(m, device=self.device)[:, None].expand(self.cols.shape)
        out = torch.zeros((m, n), dtype=self.dtype, device=self.device)
        return out.index_put_((rows, self.cols.long()), self.data, accumulate=True)


def _ell_arrays(S, dtype):
    R = S.tocsr()
    R.sum_duplicates()
    m = R.shape[0]
    counts = np.diff(R.indptr)
    K = max(int(counts.max()) if m and counts.size else 0, 1)
    data = np.zeros((m, K), dtype=dtype)
    cols = np.zeros((m, K), dtype=np.int32)
    if R.nnz:
        rows = np.repeat(np.arange(m), counts)
        pos = np.arange(R.nnz) - np.repeat(R.indptr[:-1], counts)
        data[rows, pos] = R.data
        cols[rows, pos] = R.indices
    return data, cols


def ell_from_scipy(S, dtype=torch.float32, device='cpu'):
    """An EllMatrix (with its transpose) from any scipy sparse matrix; packed
    on the host at ``dtype`` and moved to ``device``."""
    f = np_dtype(dtype)
    data, cols = _ell_arrays(S, f)
    data_t, cols_t = _ell_arrays(S.T, f)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return EllMatrix(t(data), t(cols), t(data_t), t(cols_t), S.shape)


# ---------------------------------------------------------------------------
# BSR (block-ELL)
# ---------------------------------------------------------------------------

# The block (_BSR_R, _BSR_C) = (8, 128) is the JAX package's, one float32 TPU
# tile.  It is kept because the ladder's costs (_bsr_cost) are counted in it
# and both packages must pick alike.


class BsrMatrix:
    """Block-ELL sparse matrix of shape (m, n) with dense (8, 128) blocks.

    ``blocks[i, k]`` is the k-th stored block of block-row i and
    ``bcols[i, k]`` its block-column; block-rows with fewer blocks are padded
    with zero blocks at block-column 0.  The transpose's blocks are stored
    too.  The main diagonal ``dvec`` is built on the host.  ``nblk``
    (``(nbr,)`` int32) counts the slots of each block-row before its
    trailing padding blocks, computed here unless given (``.T`` swaps it
    with the transpose's ``nblk_t``, ``astype`` keeps both)."""

    def __init__(self, blocks, bcols, blocks_t, bcols_t, dvec, shape, nblk=None,
                 nblk_t=None):
        self.blocks = blocks      # (nbr, Kb, 8, 128)
        self.bcols = bcols        # (nbr, Kb) int32
        self.blocks_t = blocks_t  # (nbc, Kt, 8, 128) for S.T
        self.bcols_t = bcols_t
        self.dvec = dvec          # (min(m, n),)
        self.shape = tuple(shape)
        self.nblk = block_counts(blocks, bcols) if nblk is None else nblk                # (nbr,)
        self.nblk_t = block_counts(blocks_t, bcols_t) if nblk_t is None else nblk_t    # (nbc,)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def T(self):
        return BsrMatrix(self.blocks_t, self.bcols_t, self.blocks, self.bcols, self.dvec,
                         (self.shape[1], self.shape[0]), self.nblk_t, self.nblk)

    def astype(self, dtype):
        return BsrMatrix(self.blocks.to(dtype), self.bcols, self.blocks_t.to(dtype),
                         self.bcols_t, self.dvec.to(dtype), self.shape, self.nblk, self.nblk_t)

    def __matmul__(self, v):
        if v.dim() != 1:
            raise TypeError('BsrMatrix only supports matrix-vector products')
        return bsr_matvec(self.blocks, self.bcols, v, self.shape[0], self.nblk)

    def diag(self):
        """Main diagonal, zero past min(m, n) (as the JAX package pads it)."""
        return _pad_diag(self.dvec, self.shape[0])

    def gram_diag(self, rho):
        """diag(S' diag(rho) S): the squared transpose blocks times rho (a
        squared padding block is one, so the transpose's counts hold)."""
        return bsr_matvec(self.blocks_t * self.blocks_t, self.bcols_t, rho, self.shape[1],
                          self.nblk_t)

    def todense(self):
        nbr, Kb, R, C = self.blocks.shape
        m, n = self.shape
        nbc = -(-n // C)
        out = torch.zeros((nbr, nbc, R, C), dtype=self.dtype, device=self.device)
        rows = torch.arange(nbr, device=self.device)[:, None].expand(self.bcols.shape)
        out.index_put_((rows, self.bcols.long()), self.blocks, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(nbr * R, nbc * C)[:m, :n]


def _pad_diag(d, m):
    if d.shape[0] < m:
        d = torch.cat([d, d.new_zeros((m - d.shape[0],))])
    return d


def _bsr_arrays(S, dtype, R=_BSR_R, C=_BSR_C):
    """Host-side block-ELL packing of a scipy sparse matrix: the JAX
    package's arrays (a block for every (R, C) tile holding a stored entry,
    explicit zeros included, in ascending block-column order within its
    block-row; duplicates summed), built through scipy's CSR-to-BSR
    conversion instead of a sort of every entry's block id."""
    Csr = sp.csr_matrix(S, copy=True)
    Csr.sum_duplicates()
    m, n = Csr.shape
    nbr, nbc = -(-m // R), -(-n // C)
    if Csr.nnz == 0:
        return np.zeros((nbr, 1, R, C), dtype), np.zeros((nbr, 1), np.int32)
    # the same entries in a shape of whole blocks, as scipy's tobsr requires
    indptr = np.concatenate([Csr.indptr, np.full(nbr * R - m, Csr.indptr[-1], Csr.indptr.dtype)])
    B = sp.csr_matrix((Csr.data, Csr.indices, indptr), shape=(nbr * R, nbc * C)).tobsr(
        blocksize=(R, C))
    B.sort_indices()
    counts = np.diff(B.indptr)
    Kb = max(int(counts.max()), 1)
    # slot of each stored block within its block-row
    brow = np.repeat(np.arange(nbr), counts)
    slot = np.arange(B.indices.size) - B.indptr[brow]
    blocks = np.zeros((nbr, Kb, R, C), dtype)
    bcols = np.zeros((nbr, Kb), np.int32)
    bcols[brow, slot] = B.indices
    blocks[brow, slot] = B.data
    return blocks, bcols


def bsr_from_scipy(S, dtype=torch.float32, device='cpu'):
    """A BsrMatrix (with its transpose blocks) from any scipy sparse matrix;
    packed on the host at ``dtype`` and moved to ``device``."""
    f = np_dtype(dtype)
    blocks, bcols = _bsr_arrays(S, f)
    blocks_t, bcols_t = _bsr_arrays(S.T, f)
    dvec = np.asarray(S.tocsr().diagonal()[:min(S.shape)], f)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return BsrMatrix(t(blocks), t(bcols), t(blocks_t), t(bcols_t), t(dvec), S.shape)


# ---------------------------------------------------------------------------
# The BCOO fallback: torch.sparse CSR
# ---------------------------------------------------------------------------


def _csr_tensor(indptr, indices, values, shape):
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter('ignore', UserWarning)
        return torch.sparse_csr_tensor(indptr, indices, values, size=shape,
                                       check_invariants=False)


def _with_values(csr, values):
    """A CSR tensor with ``csr``'s pattern and new values."""
    return _csr_tensor(csr.crow_indices(), csr.col_indices(), values, csr.shape)


class CooMatrix:
    """The ladder's last resort for ragged patterns (the JAX package leaves
    them to ``jax.experimental.sparse.BCOO``), of shape (m, n).

    The matrix and its transpose are ``torch.sparse_csr_tensor``s built on
    the host; products are ``torch.sparse``'s (cuSPARSE on the card), so no
    kernel of the port runs here.  The main diagonal ``dvec`` is built on the
    host.  A bare sparse tensor is also a ``torch.Tensor`` and would take the
    core's dense branches; this class keeps it out of them."""

    def __init__(self, csr, csr_t, dvec, shape):
        self.csr = csr        # (m, n)
        self.csr_t = csr_t    # (n, m)
        self.dvec = dvec      # (min(m, n),)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.csr.dtype

    @property
    def device(self):
        return self.csr.device

    @property
    def T(self):
        return CooMatrix(self.csr_t, self.csr, self.dvec, (self.shape[1], self.shape[0]))

    def astype(self, dtype):
        return CooMatrix(_with_values(self.csr, self.csr.values().to(dtype)),
                         _with_values(self.csr_t, self.csr_t.values().to(dtype)),
                         self.dvec.to(dtype), self.shape)

    def __matmul__(self, v):
        if v.dim() != 1:
            raise TypeError('CooMatrix only supports matrix-vector products')
        return self.csr @ v

    def diag(self):
        """Main diagonal, zero past min(m, n)."""
        return _pad_diag(self.dvec, self.shape[0])

    def gram_diag(self, rho):
        """diag(S' diag(rho) S): the squared transpose times rho."""
        vals = self.csr_t.values()
        return _with_values(self.csr_t, vals * vals) @ rho

    def todense(self):
        return self.csr.to_dense()


def coo_from_scipy(S, dtype=torch.float32, device='cpu'):
    """A CooMatrix from any scipy sparse matrix: both orientations as CSR
    (int64 indices, duplicates summed), built on the host at ``dtype``."""
    f = np_dtype(dtype)

    def csr(M):
        M = sp.csr_matrix(M)
        M.sum_duplicates()
        return _csr_tensor(torch.as_tensor(M.indptr.astype(np.int64), device=device),
                           torch.as_tensor(M.indices.astype(np.int64), device=device),
                           torch.as_tensor(M.data.astype(f), device=device), M.shape)

    dvec = np.asarray(sp.csr_matrix(S).diagonal()[:min(S.shape)], f)
    return CooMatrix(csr(S), csr(S.T), torch.as_tensor(dvec, device=device), S.shape)


def is_structured(M) -> bool:
    """True for the port's sparse operator classes, traced or eager (not for
    a dense tensor)."""
    return isinstance(M, (DiaMatrix, EllMatrix, BsrMatrix, CooMatrix, LibraryOperator))


# ---------------------------------------------------------------------------
# Format selection (thresholds copied from osqp_tpu/ops/spmv.py unchanged)
# ---------------------------------------------------------------------------

_WASTE_LIMIT = 5.0
_DIA_MAX_BANDS = 1024
_BSR_WASTE_LIMIT = 24.0
_BSR_VS_DENSE = 4.0
_ELL_VS_DENSE = 320.0


def _dia_cost(S):
    C = S.tocoo()
    if C.nnz == 0:
        return np.inf, 0
    n_diags = np.unique(C.col - C.row).size
    return n_diags * S.shape[0] / C.nnz, n_diags


def _ell_cost(S):
    """(padding multiple, stored bytes) of the padded-row packing."""
    R = S.tocsr()
    if R.nnz == 0:
        return np.inf, 0
    counts = np.diff(R.indptr)
    kmax = int(counts.max()) if counts.size else 0
    stored = max(kmax, 1) * S.shape[0]
    return stored / R.nnz, stored * 8


def _bsr_cost(S, R=_BSR_R, C=_BSR_C):
    """(padding multiple, stored bytes) of the block-ELL packing."""
    Coo = S.tocoo()
    if Coo.nnz == 0:
        return np.inf, 0
    nbc = -(-S.shape[1] // C)
    bid = (Coo.row // R).astype(np.int64) * nbc + Coo.col // C
    uniq = np.unique(bid)
    counts = np.bincount(uniq // nbc, minlength=-(-S.shape[0] // R))
    Kb = max(int(counts.max()), 1)
    stored = counts.size * Kb * R * C
    return stored / Coo.nnz, stored * 4


def choose_format(S, sparse_format='auto', dense_budget_bytes=DENSE_BUDGET_BYTES) -> str:
    """Pick 'dia' | 'bsr' | 'dense' | 'ell' | 'bcoo' for a scipy matrix, by
    the JAX package's ladder; ``sparse_format`` other than 'auto' forces it."""
    forced = str(sparse_format).lower()
    if forced not in FORMATS:
        raise ValueError(f'sparse_format must be one of {FORMATS}, got {sparse_format!r}')
    if forced != 'auto':
        return forced
    if S.nnz == 0:
        return 'dia'
    dia_waste, n_diags = _dia_cost(S)
    if dia_waste <= _WASTE_LIMIT and n_diags <= _DIA_MAX_BANDS:
        return 'dia'
    dense_bytes = 4 * S.shape[0] * S.shape[1]
    dense_ok = dense_bytes <= int(dense_budget_bytes)
    bsr_waste, bsr_bytes = _bsr_cost(S)
    if bsr_waste <= _BSR_WASTE_LIMIT and (bsr_bytes * _BSR_VS_DENSE < dense_bytes or not dense_ok):
        return 'bsr'
    ell_waste, ell_bytes = _ell_cost(S)
    ell_ok = ell_waste <= _WASTE_LIMIT
    if ell_ok and ell_bytes * _ELL_VS_DENSE < dense_bytes:
        return 'ell'
    if dense_ok:
        return 'dense'
    if ell_ok:
        return 'ell'
    return 'bcoo'


_BUILDERS = {'dia': dia_from_scipy, 'ell': ell_from_scipy, 'bsr': bsr_from_scipy,
             'bcoo': coo_from_scipy}


def from_scipy(S, dtype=torch.float32, fmt='dia', device='cpu'):
    """scipy sparse -> the operator of format ``fmt``: a DiaMatrix, EllMatrix,
    BsrMatrix or CooMatrix (``'bcoo'``), or a dense tensor (``'dense'``,
    whose ``@`` is ``torch.matmul``)."""
    if fmt == 'dense':
        return torch.as_tensor(S.toarray(), dtype=dtype, device=device)
    if fmt not in _BUILDERS:
        raise ValueError(f'unknown sparse format {fmt!r}')
    return _BUILDERS[fmt](S, dtype, device)
