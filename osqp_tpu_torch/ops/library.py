"""The sparse products as ``torch.library`` operators, for traced programs.

A ``torch.export`` program cannot see through the kernel wrappers: their
launches go through ``ctypes`` and their plain versions read offsets on the
host.  Each product the traced solve loop (``solver.core_graph``) needs is
therefore one custom operator with a fake (shape-only) implementation:

- ``osqp_tpu_torch::dia_matvec(bands, offsets, v)``: K2 on the card;
- ``osqp_tpu_torch::ell_matvec(data, cols, v, lens, log2g)``: K3;
- ``osqp_tpu_torch::bsr_matvec(blocks, bcols, v, out_rows, nblk)``: K4;
- ``osqp_tpu_torch::csr_matvec(crow, col, values, v, n_cols)``: the CSR
  fallback (``spmv.CooMatrix``), ``torch.sparse``'s product (cuSPARSE on
  the card), as the eager path computes it.

The CPU implementation of K2, K3 and K4 is the plain version; the CUDA
implementation is the kernel wrapper, which launches the hand-written kernel
(and counts the launch) or raises.  The eager operators of ``ops.spmv`` call
the wrappers directly; only traced code calls these operators, through
``LibraryOperator``.
"""

from __future__ import annotations

import torch

from . import bsr_matvec as _bm
from . import dia_matvec as _dm
from . import ell_matvec as _em

_NS = 'osqp_tpu_torch'


@torch.library.custom_op(f'{_NS}::dia_matvec', mutates_args=(), device_types='cpu')
def dia_matvec(bands: torch.Tensor, offsets: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _dm.dia_matvec_plain(bands, offsets, v)


@dia_matvec.register_kernel('cuda')
def _dia_cuda(bands, offsets, v):
    return _dm.dia_matvec(bands, offsets, v)


@dia_matvec.register_fake
def _dia_fake(bands, offsets, v):
    return v.new_empty((bands.shape[1],))


@torch.library.custom_op(f'{_NS}::ell_matvec', mutates_args=(), device_types='cpu')
def ell_matvec(data: torch.Tensor, cols: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
               log2g: int) -> torch.Tensor:
    return _em.ell_matvec_plain(data, cols, v)


@ell_matvec.register_kernel('cuda')
def _ell_cuda(data, cols, v, lens, log2g):
    return _em.ell_matvec(data, cols, v, lens, log2g)


@ell_matvec.register_fake
def _ell_fake(data, cols, v, lens, log2g):
    return v.new_empty((data.shape[0],))


@torch.library.custom_op(f'{_NS}::bsr_matvec', mutates_args=(), device_types='cpu')
def bsr_matvec(blocks: torch.Tensor, bcols: torch.Tensor, v: torch.Tensor, out_rows: int,
               nblk: torch.Tensor) -> torch.Tensor:
    # a fresh tensor: the plain version returns a slice of its product
    return _bm.bsr_matvec_plain(blocks, bcols, v, out_rows).clone()


@bsr_matvec.register_kernel('cuda')
def _bsr_cuda(blocks, bcols, v, out_rows, nblk):
    return _bm.bsr_matvec(blocks, bcols, v, out_rows, nblk)


@bsr_matvec.register_fake
def _bsr_fake(blocks, bcols, v, out_rows, nblk):
    return v.new_empty((out_rows,))


@torch.library.custom_op(f'{_NS}::csr_matvec', mutates_args=())
def csr_matvec(crow: torch.Tensor, col: torch.Tensor, values: torch.Tensor, v: torch.Tensor,
               n_cols: int) -> torch.Tensor:
    from .spmv import _csr_tensor

    return _csr_tensor(crow, col, values, (crow.shape[0] - 1, n_cols)) @ v


@csr_matvec.register_fake
def _csr_fake(crow, col, values, v, n_cols):
    return v.new_empty((crow.shape[0] - 1,))


class LibraryOperator:
    """A sparse operator of ``ops.spmv`` whose products go through the
    operators above: ``@`` on a vector, ``.T``, ``diag()``,
    ``gram_diag(rho)`` and ``shape``, the surface the solver core's loop
    uses.

    ``kind`` is 'dia', 'ell', 'bsr' or 'csr'; ``tensors`` holds the
    operator's tensors by name (the product's operands under 'fwd_*', the
    transpose's under 'tr_*', the transpose's squared values under 'sq_t'
    for ``gram_diag`` and the main diagonal under 'diag'); ``meta`` holds its
    integers (lanes per row, row counts).  ``from_spmv`` builds one from an
    eager operator.  The tensors are what a traced program takes as inputs
    (``with_tensors`` rebuilds the operator around them)."""

    def __init__(self, kind, shape, tensors, meta):
        self.kind = kind
        self.shape = tuple(shape)
        self.tensors = dict(tensors)
        self.meta = dict(meta)

    def with_tensors(self, tensors):
        return LibraryOperator(self.kind, self.shape, tensors, self.meta)

    @property
    def T(self):
        t, swapped = self.tensors, {}
        for key, val in t.items():
            if key.startswith('fwd_'):
                swapped['tr_' + key[4:]] = val
            elif key.startswith('tr_'):
                swapped['fwd_' + key[3:]] = val
        meta = {('tr_' + k[4:] if k.startswith('fwd_') else 'fwd_' + k[3:]): v
                for k, v in self.meta.items()}
        return LibraryOperator(self.kind, (self.shape[1], self.shape[0]), swapped, meta)

    _VALUES = {'dia': 'bands', 'ell': 'data', 'bsr': 'blocks', 'csr': 'values'}

    def _product(self, side, v, vals=None, out_rows=None):
        """``S @ v`` (side 'fwd') or ``S' @ v`` ('tr'), with ``vals`` in
        place of the stored values when given."""
        t, mt = self.tensors, self.meta

        def part(name):
            return t[f'{side}_{name}']

        if vals is None:
            vals = part(self._VALUES[self.kind])
        ops = torch.ops.osqp_tpu_torch
        if self.kind == 'dia':
            return ops.dia_matvec(vals, part('offsets'), v)
        if self.kind == 'ell':
            return ops.ell_matvec(vals, part('cols'), v, part('lens'), mt[f'{side}_log2g'])
        if self.kind == 'bsr':
            return ops.bsr_matvec(vals, part('bcols'), v, out_rows, part('nblk'))
        return ops.csr_matvec(part('crow'), part('col'), vals, v, mt[f'{side}_ncols'])

    def __matmul__(self, v):
        if v.dim() != 1:
            raise TypeError('LibraryOperator only supports matrix-vector products')
        return self._product('fwd', v, out_rows=self.shape[0])

    def diag(self):
        """Main diagonal (square matrices), as the eager operator's."""
        return self.tensors['diag']

    def gram_diag(self, rho):
        """diag(S' diag(rho) S): the transpose's squared values times rho."""
        return self._product('tr', rho, vals=self.tensors['sq_t'], out_rows=self.shape[1])

    @classmethod
    def from_spmv(cls, S):
        """The LibraryOperator of a ``DiaMatrix``, ``EllMatrix``,
        ``BsrMatrix`` or ``CooMatrix``: the same tensors, the transpose's
        squared values computed once, and the main diagonal when the
        operator is square."""
        from . import spmv

        if isinstance(S, spmv.DiaMatrix):
            kind = 'dia'
            t = dict(fwd_bands=S.bands, fwd_offsets=S._off, tr_bands=S.bands_t,
                     tr_offsets=S._off_t, sq_t=S.bands_t * S.bands_t)
            meta = {}
        elif isinstance(S, spmv.EllMatrix):
            kind = 'ell'
            t = dict(fwd_data=S.data, fwd_cols=S.cols, fwd_lens=S.lens, tr_data=S.data_t,
                     tr_cols=S.cols_t, tr_lens=S.lens_t, sq_t=S.data_t * S.data_t)
            meta = dict(fwd_log2g=int(S.log2g), tr_log2g=int(S.log2g_t))
        elif isinstance(S, spmv.BsrMatrix):
            kind = 'bsr'
            t = dict(fwd_blocks=S.blocks, fwd_bcols=S.bcols, fwd_nblk=S.nblk,
                     tr_blocks=S.blocks_t, tr_bcols=S.bcols_t, tr_nblk=S.nblk_t,
                     sq_t=S.blocks_t * S.blocks_t)
            meta = {}
        elif isinstance(S, spmv.CooMatrix):
            kind = 'csr'
            # strided copies: a sparse tensor's parts are views of it
            parts = [M.clone() for C in (S.csr, S.csr_t)
                     for M in (C.crow_indices(), C.col_indices(), C.values())]
            t = dict(zip(('fwd_crow', 'fwd_col', 'fwd_values', 'tr_crow', 'tr_col', 'tr_values'),
                         parts))
            t['sq_t'] = parts[5] * parts[5]
            meta = dict(fwd_ncols=S.shape[1], tr_ncols=S.shape[0])
        else:
            raise TypeError(f'not a sparse operator of ops.spmv: {type(S).__name__}')
        if S.shape[0] == S.shape[1]:
            t['diag'] = S.diag().clone()  # not a view of the bands
        return cls(kind, S.shape, t, meta)
