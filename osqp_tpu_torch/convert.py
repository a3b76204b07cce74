"""Carry the JAX package's setup state into the port.

``from_jax_setup`` (the shared batched engine), ``from_jax_batch`` (the vmap
batched engine), ``from_jax_solver`` (the single-QP ``Solver``) and
``from_jax_bigqp`` / ``from_jax_banded`` (the distributed huge-QP modes) take
numpy arrays, never JAX arrays, so this module
(like the rest of the port) imports nothing of JAX.  With them a test starts
both loops from identical state and holds the loop apart from setup.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .ops.spmv import BsrMatrix, DiaMatrix, EllMatrix, coo_from_scipy
from .settings import np_dtype
from .solver import core_batched as cb
from .solver.core import Factor, Iterates, QPData, RhoState, Scaling


def from_jax_setup(arrays, device, dtype):
    """Port tensors from ``osqp_tpu.batch_shared.shared_setup``'s outputs.

    ``arrays``: ``(P_s, A_s, Q, L, U, scal, rho0, Minv, M, rho_vec, X, Z, Y)``
    as numpy arrays, with ``scal`` the tuple ``(D, Dinv, E, Einv, c, cinv)``.
    Returns the same tuple as tensors on ``device`` at ``dtype``; the
    scaling's ``c``, ``cinv`` and ``rho0`` become host scalars of ``dtype``.
    """
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rho_vec, X, Z, Y = arrays
    f = np_dtype(dtype)
    device = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=f), device=device)

    D, Dinv, E, Einv, c, cinv = scal
    scal_t = Scaling(D=t(D), Dinv=t(Dinv), E=t(E), Einv=t(Einv), c=f(c), cinv=f(cinv))
    return (t(P_s), t(A_s), t(Q), t(L), t(U), scal_t, f(rho0), t(Minv), t(M),
            t(rho_vec), t(X), t(Z), t(Y))


def from_jax_solver(arrays, device, dtype):
    """Port state from ``osqp_tpu.backends.jax_backend.Solver`` after setup.

    ``arrays`` is a dict of numpy arrays:

    - ``P``, ``A``: a 2-D array (dense mode), or a sparse operator's state as
      a dict with its ``shape`` and: ``bands``, ``offsets``, ``bands_t``,
      ``offsets_t`` (DIA); ``data``, ``cols``, ``data_t``, ``cols_t`` (ELL);
      ``blocks``, ``bcols``, ``blocks_t``, ``bcols_t``, ``dvec`` (BSR); or
      ``data`` and ``indices`` (nnz, 2) of the row and column of each entry
      (BCOO, carried as the port's ``CooMatrix``);
    - ``q``, ``l``, ``u``: the scaled vectors;
    - ``scal``: ``(D, Dinv, E, Einv, c, cinv)``;
    - ``rho``: ``(rho, rho_vec, rho_inv_vec, constr_type)``;
    - ``factor``: ``(L, diag)``, with ``L`` empty in indirect mode;
    - ``iterates``: ``(x, z, y)``.

    Returns ``(QPData, Scaling, RhoState, Factor, Iterates)`` on ``device`` at
    ``dtype``; ``c``, ``cinv`` and ``rho`` become host scalars of ``dtype``.
    """
    f = np_dtype(dtype)
    device = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=f), device=device)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

    def op(M):
        if not isinstance(M, dict):
            return t(M)
        if 'bands' in M:
            return DiaMatrix(t(M['bands']), M['offsets'], t(M['bands_t']), M['offsets_t'],
                             M['shape'])
        if 'cols' in M:
            return EllMatrix(t(M['data']), i32(M['cols']), t(M['data_t']), i32(M['cols_t']),
                             M['shape'])
        if 'blocks' in M:
            return BsrMatrix(t(M['blocks']), i32(M['bcols']), t(M['blocks_t']),
                             i32(M['bcols_t']), t(M['dvec']), M['shape'])
        ij = np.asarray(M['indices'])
        return coo_from_scipy(sp.coo_matrix((np.asarray(M['data']), (ij[:, 0], ij[:, 1])),
                                            shape=M['shape']), dtype, device)

    data = QPData(P=op(arrays['P']), q=t(arrays['q']), A=op(arrays['A']),
                  l=t(arrays['l']), u=t(arrays['u']))
    D, Dinv, E, Einv, c, cinv = arrays['scal']
    scal = Scaling(D=t(D), Dinv=t(Dinv), E=t(E), Einv=t(Einv), c=f(c), cinv=f(cinv))
    rho, rho_vec, rho_inv, types = arrays['rho']
    rho_state = RhoState(rho=f(rho), rho_vec=t(rho_vec), rho_inv_vec=t(rho_inv),
                         constr_type=torch.tensor(np.asarray(types, np.int8), device=device))
    L, diag = arrays['factor']
    L = np.asarray(L)
    factor = Factor(L=t(L) if L.size else None, diag=t(diag), Minv=None)
    iterates = Iterates(*(t(v) for v in arrays['iterates']))
    return data, scal, rho_state, factor, iterates


def from_jax_batch(arrays, device, dtype):
    """Port state from ``osqp_tpu.batch.BatchedOSQP``'s vmap engine after
    setup.

    ``arrays`` is ``(data, scal, rho, factor, iterates)``: the engine's
    ``_data``, ``_scal``, ``_rho``, ``_factor`` and ``_iterates`` as tuples of
    numpy arrays in their fields' order, each with a leading batch axis:
    ``(P, q, A, l, u)``, ``(D, Dinv, E, Einv, c, cinv)``, ``(rho, rho_vec,
    rho_inv_vec, constr_type)``, ``(L, diag, Minv)`` (an empty ``L`` or
    ``Minv`` for a factor the method does not keep) and ``(x, z, y)``.
    Returns ``solver.core_batched``'s ``(QPData, Scaling, RhoState, Factor,
    Iterates)`` on ``device`` at ``dtype``.
    """
    f = np_dtype(dtype)
    device = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=f), device=device)

    def opt(a):
        a = np.asarray(a)
        return t(a) if a.size else None

    data, scal, rho, factor, iterates = arrays
    rho, rho_vec, rho_inv, types = rho
    L, diag, Minv = factor
    return (cb.QPData(*(t(v) for v in data)), cb.Scaling(*(t(v) for v in scal)),
            cb.RhoState(rho=t(rho), rho_vec=t(rho_vec), rho_inv_vec=t(rho_inv),
                        constr_type=torch.tensor(np.asarray(types, np.int8), device=device)),
            cb.Factor(L=opt(L), diag=t(diag), Minv=opt(Minv)),
            cb.Iterates(*(t(v) for v in iterates)))


def _from_jax_fields(cls, arrays, device, dtype):
    f = np_dtype(dtype)
    device = torch.device(device)
    ints = {'pidx': np.int32, 'aidx': np.int32, 'types': np.int8}
    out = {}
    for name in cls._fields:
        v = arrays[name]
        if isinstance(v, (int, float, bool, tuple)):
            out[name] = type(v)(v) if not isinstance(v, tuple) else tuple(int(o) for o in v)
        else:
            out[name] = torch.tensor(np.asarray(v, dtype=ints.get(name, f)), device=device)
    return cls(**out)


def from_jax_bigqp(arrays, device, dtype):
    """Port ``parallel.BigQPData`` from ``osqp_tpu.parallel.big_qp_setup``'s
    ``BigQPData``, given as a mapping of its fields to numpy arrays (and its
    ints, floats and flags as they are): ``data._asdict()`` with each array
    through ``np.asarray``.  Tensors land on ``device`` at ``dtype``."""
    from .parallel.bigqp import BigQPData

    return _from_jax_fields(BigQPData, arrays, device, dtype)


def from_jax_banded(arrays, device, dtype):
    """Port ``parallel.BandedQPData`` from ``osqp_tpu.parallel.
    banded_qp_setup``'s ``BandedQPData``, as ``from_jax_bigqp`` takes it (the
    offsets as tuples of ints)."""
    from .parallel.banded import BandedQPData

    return _from_jax_fields(BandedQPData, arrays, device, dtype)
