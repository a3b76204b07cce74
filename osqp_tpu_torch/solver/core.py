"""The parts of the ADMM core that the shared-structure engine uses.

Counterpart of ``osqp_tpu/solver/core.py``: Ruiz equilibration, constraint
typing and vector rho, and the normal-equations operator
``M(rho) = P + sigma I + A' diag(rho) A`` with its explicit inverse.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..settings import np_dtype
from ..constants import (
    MAX_SCALING,
    MIN_SCALING,
    OSQP_INFTY,
    RHO_EQ_OVER_RHO_INEQ,
    RHO_MAX,
    RHO_MIN,
    RHO_TOL,
)


class QPData(NamedTuple):
    """Scaled problem data (dense)."""

    P: torch.Tensor  # (n, n) symmetric
    q: torch.Tensor  # (n,)
    A: torch.Tensor  # (m, n)
    l: torch.Tensor  # (m,)
    u: torch.Tensor  # (m,)


class Scaling(NamedTuple):
    D: torch.Tensor  # (n,)
    Dinv: torch.Tensor  # (n,)
    E: torch.Tensor  # (m,)
    Einv: torch.Tensor  # (m,)
    c: np.floating  # cost scale, a host scalar of the working dtype
    cinv: np.floating


class Factor(NamedTuple):
    """KKT factorization state in explicit-inverse ('inv') mode: ``L`` is M
    itself (kept for the refinement term of the affine map) and ``Minv`` its
    inverse."""

    L: torch.Tensor  # (n, n)
    Minv: torch.Tensor  # (n, n)


def _inf_norm(v):
    return v.abs().amax() if v.numel() else v.new_zeros(())


def _limit_scaling(v):
    """Ruiz norm clamp (ref _osqp.py:363-387)."""
    return torch.where(v < MIN_SCALING, torch.ones_like(v), v.clamp(max=MAX_SCALING))


def ruiz_scale(P, q, A, l, u, n_iters: int):
    """Modified-Ruiz equilibration of the stacked KKT columns plus cost
    normalization (ref _osqp.py:389-497).  Returns (QPData, Scaling); the
    scaling's ``c`` and ``cinv`` come back as host scalars of P's dtype."""
    n = P.shape[0]
    m = A.shape[0]
    D = torch.ones(n, dtype=P.dtype, device=P.device)
    E = torch.ones(m, dtype=P.dtype, device=P.device)
    c = torch.ones((), dtype=P.dtype, device=P.device)
    for _ in range(n_iters):
        norm_P_col = P.abs().amax(dim=0) if n else P.new_zeros((0,))
        if m:
            norm_A_col = A.abs().amax(dim=0)
            norm_A_row = A.abs().amax(dim=1)
        else:
            norm_A_col = P.new_zeros((n,))
            norm_A_row = P.new_zeros((0,))
        d = 1.0 / torch.sqrt(_limit_scaling(torch.maximum(norm_P_col, norm_A_col)))
        e = 1.0 / torch.sqrt(_limit_scaling(norm_A_row))

        P = d[:, None] * P * d[None, :]
        A = e[:, None] * A * d[None, :]
        q = d * q
        l = e * l
        u = e * u
        D = D * d
        E = E * e

        # cost normalization (ref _osqp.py:443-468)
        norm_P_cols_mean = P.abs().amax(dim=0).mean() if n else P.new_zeros(())
        inf_norm_q = _limit_scaling(_inf_norm(q))
        scale_cost = 1.0 / _limit_scaling(torch.maximum(inf_norm_q, norm_P_cols_mean))
        P = scale_cost * P
        q = scale_cost * q
        c = scale_cost * c
    c_host = np_dtype(P.dtype)(c.item())
    scal = Scaling(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E if m else E,
                   c=c_host, cinv=1.0 / c_host)
    return QPData(P=P, q=q, A=A, l=l, u=u), scal


def constraint_types(l, u):
    """-1 loose, 0 inequality, 1 equality (int8)."""
    loose = (l < -OSQP_INFTY * MIN_SCALING) & (u > OSQP_INFTY * MIN_SCALING)
    eq = (~loose) & (u - l < RHO_TOL)
    return torch.where(loose, -1, torch.where(eq, 1, 0)).to(torch.int8)


def rho_vec_from_types(types, rho, rho_is_vec: bool, dtype: torch.dtype):
    """Per-constraint rho from the constraint types; ``rho`` is a host scalar,
    taken at ``dtype`` as the JAX package's traced rho is."""
    f = np_dtype(dtype)
    rho = f(min(max(f(rho), f(RHO_MIN)), f(RHO_MAX)))
    vec = torch.full(types.shape, rho, dtype=dtype, device=types.device)
    if not rho_is_vec:
        return vec
    return torch.where(
        types == -1, f(RHO_MIN),
        torch.where(types == 1, f(RHO_EQ_OVER_RHO_INEQ) * rho, vec),
    )


def build_M(P, A, sigma, rho_vec):
    """Normal-equations operator M = P + sigma I + A' diag(rho) A."""
    n = P.shape[0]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[0]:
        M = M + A.T @ (rho_vec[:, None] * A)
    return M


def factorize_inv(P, A, sigma, rho_vec) -> Factor:
    """``factorize(..., 'inv')``: Cholesky of M, then its inverse by two
    triangular solves against the identity."""
    M = build_M(P, A, sigma, rho_vec)
    L = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    Minv = torch.cholesky_solve(eye, L)
    return Factor(L=M, Minv=Minv)
