"""Sparse matrix operators for the indirect (PCG) path: the DIA part of
``osqp_tpu/ops/spmv.py`` on torch tensors.

``DiaMatrix`` keeps a matrix as its distinct non-zero diagonals (bands),
with the transpose's bands built on the host, so ``S @ v`` and ``S.T @ y``
are both shifted multiply-adds with no gather.  Every product goes through
``ops.dia_matvec.dia_matvec``: the hand-written CUDA kernel on the card, its
plain version on the CPU.

``choose_format`` is a copy of the JAX package's format ladder, thresholds
and cost helpers unchanged (including the 4-byte dense size), so both
packages pick the same format for the same pattern; its environment knobs are
arguments here.  ``from_scipy`` builds ``'dia'`` and ``'dense'`` operators;
the ELL, BSR and BCOO formats are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..settings import np_dtype
from .dia_matvec import dia_matvec

DENSE_BUDGET_BYTES = 2_000_000_000
FORMATS = ('auto', 'dia', 'bsr', 'dense', 'ell', 'bcoo')
_LATER_FORMATS = ("the {} sparse format is not ported yet (ROADMAP.md Queue 1: the ELL, BSR "
                  "and BCOO formats); banded patterns run as 'dia', others fit as 'dense'")


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
# Format selection (thresholds copied from osqp_tpu/ops/spmv.py unchanged)
# ---------------------------------------------------------------------------

_WASTE_LIMIT = 5.0
_DIA_MAX_BANDS = 1024
_BSR_R, _BSR_C = 8, 128
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


def from_scipy(S, dtype=torch.float32, fmt='dia', device='cpu'):
    """scipy sparse -> a DiaMatrix (``'dia'``) or a dense tensor
    (``'dense'``, whose ``@`` is ``torch.matmul``)."""
    if fmt == 'dia':
        return dia_from_scipy(S, dtype, device)
    if fmt == 'dense':
        return torch.as_tensor(S.toarray(), dtype=dtype, device=device)
    if fmt in ('ell', 'bsr', 'bcoo'):
        raise NotImplementedError(_LATER_FORMATS.format(repr(fmt)))
    raise ValueError(f'unknown sparse format {fmt!r}')
