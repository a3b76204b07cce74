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


def ruiz_scale_scipy(P, A, q, l, u, n_iters: int):
    """Returns (P_s, A_s (csc), q_s, l_s, u_s, D, E, c)."""
    n = P.shape[0]
    m = A.shape[0]
    P = sp.csc_matrix(P).astype(np.float64)
    A = sp.csc_matrix(A).astype(np.float64)
    q = np.asarray(q, np.float64).copy()
    l = np.asarray(l, np.float64).copy()
    u = np.asarray(u, np.float64).copy()
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0

    for _ in range(n_iters):
        absP = abs(P)
        absA = abs(A)
        norm_P_col = np.asarray(absP.max(axis=0).todense()).ravel() if P.nnz else np.zeros(n)
        norm_A_col = np.asarray(absA.max(axis=0).todense()).ravel() if A.nnz else np.zeros(n)
        norm_A_row = np.asarray(absA.max(axis=1).todense()).ravel() if A.nnz else np.zeros(m)
        d = 1.0 / np.sqrt(_limit(np.maximum(norm_P_col, norm_A_col)))
        e = 1.0 / np.sqrt(_limit(norm_A_row))

        Dd = sp.diags(d)
        Ee = sp.diags(e)
        P = (Dd @ P @ Dd).tocsc()
        A = (Ee @ A @ Dd).tocsc()
        q = d * q
        l = e * l
        u = e * u
        D *= d
        E *= e

        norm_P_cols_mean = (
            float(np.asarray(abs(P).max(axis=0).todense()).ravel().mean()) if P.nnz else 0.0
        )
        inf_norm_q = float(_limit(np.abs(q).max(initial=0.0)))
        scale_cost = 1.0 / float(_limit(max(inf_norm_q, norm_P_cols_mean)))
        P = P * scale_cost
        q = q * scale_cost
        c *= scale_cost

    return P, A, q, l, u, D, E, c
