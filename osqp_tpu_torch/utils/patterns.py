"""Sparsity-pattern-preserving matrix constructions.

The port's own copy of ``osqp_tpu/utils/patterns.py``.  scipy's binary ops
(``T + T.T - diags``) canonicalize and silently prune explicit stored zeros.
Users reserve zero slots in their P/A patterns for later ``update_data_mat``
value updates (the reference C core's CSC data slots are positional, so
explicit zeros are pattern members); any pattern-bearing construction here
must keep them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def triu_to_full(P_triu):
    """Full symmetric CSC matrix from triu storage, keeping every stored
    entry (explicit zeros included) via COO concatenation."""
    C = P_triu.tocoo()
    off = C.row != C.col
    rows = np.concatenate([C.row, C.col[off]])
    cols = np.concatenate([C.col, C.row[off]])
    vals = np.concatenate([C.data, C.data[off]])
    return sp.coo_matrix((vals, (rows, cols)), shape=P_triu.shape).tocsc()
