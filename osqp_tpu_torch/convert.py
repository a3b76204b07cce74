"""Carry the JAX package's setup state into the port.

``from_jax_setup`` takes numpy arrays, never JAX arrays, so this module (like
the rest of the port) imports nothing of JAX.  With it a test starts both epoch
loops from identical state and holds the loop apart from setup.
"""

from __future__ import annotations

import numpy as np
import torch

from .settings import np_dtype
from .solver.core import Scaling


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
