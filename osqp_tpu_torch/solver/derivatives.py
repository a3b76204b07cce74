"""Adjoint and forward derivatives of the QP solution map, on torch tensors.

The port's copy of ``osqp_tpu/solver/derivatives.py``: implicit
differentiation of the active-set KKT conditions.  At a solution (x*, y*)
whose active rows satisfy ``A_act x = b`` (``b = l`` on lower-active rows,
``u`` on upper-active ones) the solution locally solves the
equality-constrained QP with KKT matrix

    K = [[P, A_act'], [A_act, 0]].

Both functions solve with ``K`` regularized by ``delta`` (``+delta I`` and
``-delta I`` on the two diagonal blocks) and refine 8 times against the
unregularized ``K``, as the JAX package does.

The JAX package computes on the host with scipy's sparse LU.  Here ``K`` is
formed dense and factored with ``torch.linalg.lu_factor`` on the solver's
device, always in float64, whatever the solve's dtype.  The results ``dP``
(n, n) and ``dA`` (m, n) are dense in both packages, so the dense ``K`` of
order n + |active| costs no more memory than the result already does.
Inputs are numpy and scipy arrays of the unscaled problem; outputs are numpy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

F64 = torch.float64


def _full_p(P):
    """The full symmetric P from its upper triangle (a full P is cut to it)."""
    T = sp.triu(sp.csc_matrix(P), format='csc')
    return (T + T.T - sp.diags(T.diagonal())).tocsc()


def _dense(M, device):
    return torch.as_tensor(np.asarray(M.toarray() if sp.issparse(M) else M, np.float64),
                           dtype=F64, device=device)


def _vec(v, length, device):
    if v is None:
        return torch.zeros((length,), dtype=F64, device=device)
    return torch.as_tensor(np.asarray(v, np.float64).ravel(), dtype=F64, device=device)


def _active_set(A, l, u, x, y):
    """Lower- and upper-active masks by the polish's slack-versus-multiplier
    rule (strict, so weakly active ties are left out) and the active rows."""
    z = A @ x
    low = (z - l) < -y
    upp = (u - z) < y
    return low, upp, torch.nonzero(low | upp).flatten()


def _kkt_solver(P, A_act, delta, refine_iters):
    """A solve of ``K s = rhs``: LU of the delta-regularized K, then
    ``refine_iters`` refinement steps against the unregularized K."""
    n, k = P.shape[0], A_act.shape[0]
    K = torch.zeros((n + k, n + k), dtype=F64, device=P.device)
    K[:n, :n] = P
    K[n:, :n] = A_act
    K[:n, n:] = A_act.T
    K0 = K.clone()
    idx = torch.arange(n + k, device=P.device)
    K[idx, idx] += torch.cat([torch.full((n,), delta, dtype=F64, device=P.device),
                              torch.full((k,), -delta, dtype=F64, device=P.device)])
    LU, piv = torch.linalg.lu_factor(K)

    def solve(rhs):
        def lu(b):
            return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]

        s = lu(rhs)
        for _ in range(refine_iters):
            s = s + lu(rhs - K0 @ s)
        return s

    return solve


def adjoint_derivative(P, q, A, l, u, x, y, dx, dy, delta=1e-8, refine_iters=8,
                       device='cpu'):
    """Adjoint derivatives of a loss with seeds ``dx``, ``dy`` (numpy) at the
    solution ``x``, ``y``; ``P`` may be given as its upper triangle.  Solves
    ``K r = [dx; dy_act]`` and reads off

        dq = -r_x,  dl_i = r_y_i (lower-active), du_i = r_y_i (upper-active),
        dP = -(r_x x' + x r_x') / 2,  dA_i = -(y_i r_x + r_y_i x)' (active rows).

    Returns a dict of numpy arrays: ``dq``, ``dl``, ``du``, ``dP`` (n, n,
    symmetric, dense) and ``dA`` (m, n, dense)."""
    P = _dense(_full_p(P), device)
    A = _dense(A, device)
    n, m = P.shape[0], A.shape[0]
    x = _vec(x, n, device)
    y = _vec(y if m else None, m, device)
    dx = _vec(dx, n, device)
    dy = _vec(dy, m, device)
    low, upp, idx = _active_set(A, _vec(l, m, device), _vec(u, m, device), x, y)
    A_act = A[idx]

    r = _kkt_solver(P, A_act, delta, refine_iters)(torch.cat([dx, dy[idx]]))
    r_x, r_nu = r[:n], r[n:]

    r_y = torch.zeros((m,), dtype=F64, device=device)
    r_y[idx] = r_nu
    dl = torch.where(low, r_y, 0.0)
    du = torch.where(upp, r_y, 0.0)
    dP = -0.5 * (torch.outer(r_x, x) + torch.outer(x, r_x))
    dA = torch.zeros((m, n), dtype=F64, device=device)
    dA[idx] = -(torch.outer(y[idx], r_x) + torch.outer(r_nu, x))
    out = dict(dq=-r_x, dl=dl, du=du, dP=dP, dA=dA)
    return {k: v.cpu().numpy() for k, v in out.items()}


def forward_derivative(P, q, A, l, u, x, y, dP=None, dq=None, dA=None, dl=None, du=None,
                       delta=1e-8, refine_iters=8, device='cpu'):
    """Forward sensitivities of the solution map in the data direction
    ``(dP, dq, dA, dl, du)`` (each optional; ``dP`` symmetrized from its
    upper triangle): solves ``K [dx; dnu] = -[dP x + dq + dA' y;
    (dA x - db)_act]``.  Returns numpy ``(dx, dyl, dyu)``: the derivatives of
    x and of the split multipliers ``yl = max(-y, 0)``, ``yu = max(y, 0)``."""
    P = _dense(_full_p(P), device)
    A = _dense(A, device)
    n, m = P.shape[0], A.shape[0]
    x = _vec(x, n, device)
    y = _vec(y if m else None, m, device)

    dP_m = torch.zeros((n, n), dtype=F64, device=device) if dP is None else _dense(dP, device)
    dP_m = torch.triu(dP_m) + torch.triu(dP_m, 1).T
    dA_m = torch.zeros((m, n), dtype=F64, device=device) if dA is None else _dense(dA, device)
    dl_v, du_v = _vec(dl, m, device), _vec(du, m, device)

    low, upp, idx = _active_set(A, _vec(l, m, device), _vec(u, m, device), x, y)
    db = torch.where(low, dl_v, torch.where(upp, du_v, 0.0))[idx]
    r1 = dP_m @ x + _vec(dq, n, device) + dA_m.T @ y
    r2 = dA_m[idx] @ x - db

    sol = _kkt_solver(P, A[idx], delta, refine_iters)(-torch.cat([r1, r2]))
    dnu = torch.zeros((m,), dtype=F64, device=device)
    dnu[idx] = sol[n:]
    dyu = torch.where(upp, dnu, 0.0)
    dyl = torch.where(low, -dnu, 0.0)
    return sol[:n].cpu().numpy(), dyl.cpu().numpy(), dyu.cpu().numpy()
