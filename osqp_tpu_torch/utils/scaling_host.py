"""Host-side (scipy) modified-Ruiz equilibration for large sparse problems.

Own copy of ``osqp_tpu.utils.scaling_host``: the math of
``osqp_tpu_torch.solver.core.ruiz_scale`` on scipy sparse matrices, in
float64, without densifying.  Sparse mode runs it, where the dense n x n and
m x n scaling sweeps would not fit in memory.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..constants import MAX_SCALING, MIN_SCALING


def _limit(v):
    return np.where(v < MIN_SCALING, 1.0, np.minimum(v, MAX_SCALING))


def _entry_cols(S):
    """The column of each stored entry of a CSC matrix."""
    return np.repeat(np.arange(S.shape[1]), np.diff(S.indptr))


def _col_max_abs(S):
    """max_i |S[i, j]| of a CSC matrix, 0 for an empty column: what
    ``abs(S).max(axis=0)`` gives, without the copy."""
    out = np.zeros(S.shape[1])
    nonempty = np.diff(S.indptr) > 0
    if S.nnz:
        out[nonempty] = np.maximum.reduceat(np.abs(S.data), S.indptr[:-1][nonempty])
    return out


def _row_max_abs(S):
    """max_j |S[i, j]| of a CSC matrix, 0 for an empty row."""
    out = np.zeros(S.shape[0])
    np.maximum.at(out, S.indices, np.abs(S.data))
    return out


def _scale_entries(S, rowscale, colscale):
    """S[i, j] <- (rowscale[i] * S[i, j]) * colscale[j] in place, then drop
    the entries that became zero.  The same products, rounded the same way,
    and the same pattern as scipy's ``diags(rowscale) @ S @ diags(colscale)``
    (whose products drop zero entries), without building two new matrices."""
    S.data *= rowscale[S.indices]
    S.data *= colscale[_entry_cols(S)]
    S.eliminate_zeros()


def ruiz_scale_scipy(P, A, q, l, u, n_iters: int):
    """Returns (P_s, A_s (csc), q_s, l_s, u_s, D, E, c)."""
    n = P.shape[0]
    m = A.shape[0]
    P = sp.csc_matrix(P).astype(np.float64)
    A = sp.csc_matrix(A).astype(np.float64)
    P.sum_duplicates()
    A.sum_duplicates()
    q = np.asarray(q, np.float64).copy()
    l = np.asarray(l, np.float64).copy()
    u = np.asarray(u, np.float64).copy()
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0

    for _ in range(n_iters):
        norm_P_col = _col_max_abs(P)
        norm_A_col = _col_max_abs(A)
        norm_A_row = _row_max_abs(A)
        d = 1.0 / np.sqrt(_limit(np.maximum(norm_P_col, norm_A_col)))
        e = 1.0 / np.sqrt(_limit(norm_A_row))

        _scale_entries(P, d, d)
        _scale_entries(A, e, d)
        q = d * q
        l = e * l
        u = e * u
        D *= d
        E *= e

        norm_P_cols_mean = float(_col_max_abs(P).mean()) if P.nnz else 0.0
        inf_norm_q = float(_limit(np.abs(q).max(initial=0.0)))
        scale_cost = 1.0 / float(_limit(max(inf_norm_q, norm_P_cols_mean)))
        P.data *= scale_cost
        q = q * scale_cost
        c *= scale_cost

    return P, A, q, l, u, D, E, c
