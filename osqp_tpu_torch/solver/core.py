"""The ADMM solver core on torch tensors.

Counterpart of ``osqp_tpu/solver/core.py``: Ruiz equilibration, constraint
typing and vector rho, the normal-equations operator
``M(rho) = P + sigma I + A' diag(rho) A`` with its Cholesky factor (direct
mode), its explicit inverse (the shared batched engine) or its diagonal (the
preconditioner of the indirect PCG mode), the ADMM iteration, the
termination check with both infeasibility certificates, adaptive rho and the
single-QP solve loop.

The JAX package runs the loop as one jitted ``lax.while_loop`` over epochs.
Here it is a host loop over epochs (``solve_scaled``) that reads on the host
the values that decide branches: the termination check's outcome once per
check epoch, the rho estimate once per adaptation epoch and, in indirect
mode, the CG residual norm once per CG step.  Each read is one host sync and
is counted.  P and A are dense tensors or sparse operators of ``ops.spmv``
(``DiaMatrix``, ``EllMatrix``, ``BsrMatrix``, ``CooMatrix``); the loop only
uses ``@``, ``.T`` and ``.shape`` on them, the preconditioner ``diag()`` and
``gram_diag()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops import spmv
from ..settings import CoreSettings, np_dtype
from ..utils.printing import print_loop_row
from ..constants import (
    MAX_SCALING,
    MIN_SCALING,
    OSQP_INFTY,
    PRINT_INTERVAL,
    RHO_EQ_OVER_RHO_INEQ,
    RHO_MAX,
    RHO_MIN,
    RHO_TOL,
    SolverStatus,
)

_UNSOLVED = int(SolverStatus.OSQP_UNSOLVED)
_SOLVED = int(SolverStatus.OSQP_SOLVED)
_SOLVED_INACC = int(SolverStatus.OSQP_SOLVED_INACCURATE)
_PRIM_INF = int(SolverStatus.OSQP_PRIMAL_INFEASIBLE)
_PRIM_INF_INACC = int(SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
_DUAL_INF = int(SolverStatus.OSQP_DUAL_INFEASIBLE)
_DUAL_INF_INACC = int(SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE)
_MAX_ITER = int(SolverStatus.OSQP_MAX_ITER_REACHED)
_NON_CVX = int(SolverStatus.OSQP_NON_CVX)

class QPData(NamedTuple):
    """Scaled problem data: P and A dense tensors or sparse operators."""

    P: object  # (n, n) symmetric
    q: torch.Tensor  # (n,)
    A: object  # (m, n)
    l: torch.Tensor  # (m,)
    u: torch.Tensor  # (m,)


class Scaling(NamedTuple):
    D: torch.Tensor  # (n,)
    Dinv: torch.Tensor  # (n,)
    E: torch.Tensor  # (m,)
    Einv: torch.Tensor  # (m,)
    c: np.floating  # cost scale, a host scalar of the working dtype
    cinv: np.floating


class RhoState(NamedTuple):
    rho: np.floating  # clamped setting value, a host scalar of the working dtype
    rho_vec: torch.Tensor  # (m,)
    rho_inv_vec: torch.Tensor  # (m,)
    constr_type: torch.Tensor  # (m,) int8: -1 loose, 0 ineq, 1 eq


class Factor(NamedTuple):
    """KKT factorization state.

    kkt_method='chol': ``L`` the Cholesky factor of M, ``Minv`` None.
    kkt_method='inv' (the shared engine): ``L`` is M itself (kept for the
    refinement term of the affine map) and ``Minv`` its inverse.
    Indirect mode: ``L`` and ``Minv`` None; ``diag`` = diag(M), the CG
    preconditioner.  Sparse direct mode (the 'ldl' algebra): ``ldl`` the
    LDL' factor of the full KKT matrix (``ldl_backend.KKTSystem``: ``solve``
    and ``refactor(rho_inv_vec)``), the other fields None."""

    L: Optional[torch.Tensor]  # (n, n)
    diag: Optional[torch.Tensor]  # (n,)
    Minv: Optional[torch.Tensor]  # (n, n)
    ldl: Optional[object] = None


class Iterates(NamedTuple):
    x: torch.Tensor  # (n,)
    z: torch.Tensor  # (m,)
    y: torch.Tensor  # (m,)


class SolveResult(NamedTuple):
    x: torch.Tensor  # unscaled primal (NaN if infeasible)
    y: torch.Tensor  # unscaled dual (NaN if infeasible)
    prim_inf_cert: torch.Tensor
    dual_inf_cert: torch.Tensor
    status: int
    iters: int
    pri_res: np.floating
    dua_res: np.floating
    obj_val: np.floating
    dual_obj_val: np.floating
    duality_gap: np.floating
    rho_estimate: np.floating
    rho_updates: int
    cg_iters: int
    host_syncs: int
    rel_kkt_error: np.floating
    primdual_acc: np.floating
    iterates: Iterates  # final scaled iterates (for warm restarts)
    rho: RhoState
    factor: Factor


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def _inf_norm(v):
    return v.abs().amax() if v.numel() else v.new_zeros(())


def _limit_scaling(v):
    """Ruiz norm clamp (ref _osqp.py:363-387)."""
    return torch.where(v < MIN_SCALING, torch.ones_like(v), v.clamp(max=MAX_SCALING))


# ---------------------------------------------------------------------------
# Ruiz equilibration (ref _osqp.py:389-497)
# ---------------------------------------------------------------------------


def ruiz_scale(P, q, A, l, u, n_iters: int):
    """Modified-Ruiz equilibration of the stacked KKT columns plus cost
    normalization (ref _osqp.py:389-497), on dense tensors.  Returns
    (QPData, Scaling); the scaling's ``c`` and ``cinv`` come back as host
    scalars of P's dtype."""
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


def identity_scaling(n, m, dtype, device):
    f = np_dtype(dtype)
    one_n = torch.ones((n,), dtype=dtype, device=device)
    one_m = torch.ones((m,), dtype=dtype, device=device)
    return Scaling(D=one_n, Dinv=one_n, E=one_m, Einv=one_m, c=f(1), cinv=f(1))


# ---------------------------------------------------------------------------
# rho management (ref _osqp.py:499-562)
# ---------------------------------------------------------------------------


def constraint_types(l, u):
    """-1 loose, 0 inequality, 1 equality (int8)."""
    loose = (l < -OSQP_INFTY * MIN_SCALING) & (u > OSQP_INFTY * MIN_SCALING)
    eq = (~loose) & (u - l < RHO_TOL)
    return torch.where(loose, -1, torch.where(eq, 1, 0)).to(torch.int8)


def clip_rho(rho, dtype):
    """rho clamped to [RHO_MIN, RHO_MAX], a host scalar of ``dtype``."""
    f = np_dtype(dtype)
    return f(min(max(f(rho), f(RHO_MIN)), f(RHO_MAX)))


def rho_vec_from_types(types, rho, rho_is_vec: bool, dtype: torch.dtype):
    """Per-constraint rho from the constraint types; ``rho`` is a host scalar,
    taken at ``dtype`` as the JAX package's traced rho is, or a 0-d tensor of
    ``dtype`` (the traced loop's)."""
    f = np_dtype(dtype)
    if isinstance(rho, torch.Tensor):
        rho = torch.clamp(rho, f(RHO_MIN), f(RHO_MAX))
        vec = rho.expand(types.shape).clone()
    else:
        rho = clip_rho(rho, dtype)
        vec = torch.full(types.shape, rho, dtype=dtype, device=types.device)
    if not rho_is_vec:
        return vec
    return torch.where(
        types == -1, f(RHO_MIN),
        torch.where(types == 1, f(RHO_EQ_OVER_RHO_INEQ) * rho, vec),
    )


def make_rho_state(l, u, rho, rho_is_vec: bool) -> RhoState:
    rho = clip_rho(rho, l.dtype)
    types = constraint_types(l, u)
    vec = rho_vec_from_types(types, rho, rho_is_vec, l.dtype)
    inv = torch.where(vec > 0, 1.0 / vec, 0.0)
    return RhoState(rho=rho, rho_vec=vec, rho_inv_vec=inv, constr_type=types)


# ---------------------------------------------------------------------------
# KKT operator
# ---------------------------------------------------------------------------


def build_M(P, A, sigma, rho_vec):
    """Normal-equations operator M = P + sigma I + A' diag(rho) A (dense)."""
    n = P.shape[0]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[0]:
        M = M + A.T @ (rho_vec[:, None] * A)
    return M


def mat_diag(P):
    """Diagonal of a dense or sparse-operator square matrix."""
    if spmv.is_structured(P):
        return P.diag()
    return torch.diagonal(P)


def gram_diag(A, rho_vec):
    """diag(A' diag(rho) A) for a dense or sparse-operator A."""
    if spmv.is_structured(A):
        return A.gram_diag(rho_vec)
    return torch.sum(rho_vec[:, None] * A * A, dim=0)


def build_M_diag(P, A, sigma, rho_vec):
    """diag(M) without forming M (the CG preconditioner)."""
    d = mat_diag(P) + sigma
    if A.shape[0]:
        d = d + gram_diag(A, rho_vec)
    return d


def factorize(P, A, sigma, rho_vec, kkt_method: str = 'chol') -> Factor:
    """Cholesky factor of M ('chol') or M and its inverse ('inv').  A matrix
    that is not positive definite gives a NaN factor, as JAX's Cholesky does."""
    M = build_M(P, A, sigma, rho_vec)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.nan)
    if kkt_method == 'inv':
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        return Factor(L=M, diag=torch.diagonal(M), Minv=torch.cholesky_solve(eye, L))
    if kkt_method != 'chol':
        raise ValueError(f"kkt_method must be 'chol' or 'inv', got {kkt_method!r}")
    return Factor(L=L, diag=torch.diagonal(M), Minv=None)


def _cho_solve(L, b):
    vec = b.dim() == 1
    B = b[:, None] if vec else b
    t = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.T, t, upper=True)
    return x[:, 0] if vec else x


def pcg_solve(P, A, sigma, rho_vec, diag, b, x0, rel_tol, max_iter: int):
    """Diagonally-preconditioned conjugate gradient on M(rho).

    Runs until ``||r||_2 <= max(rel_tol * ||b||_2, tiny)`` or ``max_iter``
    steps, testing that condition before every step as the JAX package's
    ``lax.while_loop`` does; each test reads one value from the device.
    Returns ``(x, iters, host_syncs)``."""

    matvec = kkt_matvec(P, A, sigma, rho_vec)
    dinv, tol, x, r, p, rz = pcg_start(matvec, diag, b, x0, rel_tol)
    k = 0
    syncs = 0
    while k < max_iter:
        syncs += 1
        if not bool(torch.sqrt(r @ r) > tol):
            break
        x, r, p, rz = pcg_step(matvec, dinv, x, r, p, rz)
        k += 1
    return x, k, syncs


def kkt_matvec(P, A, sigma, rho_vec):
    """``v -> M(rho) v = P v + sigma v + A' (rho * (A v))``, matvecs only."""

    def matvec(v):
        Mv = P @ v + sigma * v
        if A.shape[0]:
            Mv = Mv + A.T @ (rho_vec * (A @ v))
        return Mv

    return matvec


def pcg_start(matvec, diag, b, x0, rel_tol):
    """PCG's start from ``x0``: ``(dinv, tol, x, r, p, rz)``, with the stop
    tolerance ``max(rel_tol * ||b||_2, tiny)``."""
    dinv = 1.0 / diag
    b_norm = torch.sqrt(b @ b)
    tol = torch.clamp(rel_tol * b_norm, min=torch.finfo(b.dtype).tiny)
    r = b - matvec(x0)
    z = dinv * r
    return dinv, tol, x0, r, z, r @ z


def pcg_step(matvec, dinv, x, r, p, rz):
    """One PCG step: ``(x, r, p, rz)`` after it."""
    Mp = matvec(p)
    denom = p @ Mp
    alpha = rz / torch.where(denom != 0, denom, 1.0)
    x = x + alpha * p
    r = r - alpha * Mp
    z = dinv * r
    rz_new = r @ z
    beta = rz_new / torch.where(rz != 0, rz, 1.0)
    p = z + beta * p
    return x, r, p, rz_new


# ---------------------------------------------------------------------------
# Residuals / termination (ref _osqp.py:705-878, 998-1077)
# ---------------------------------------------------------------------------


def compute_info(data: QPData, scal: Scaling, x, z, y, settings: CoreSettings,
                 eps_abs=None, eps_rel=None):
    """Residual norms, objective values and tolerances, scaled or unscaled
    per settings, as 0-d tensors: ``(pri_res, dua_res, obj_val,
    dual_obj_val, eps_pri, eps_dua, gap_noise)``.  ``eps_abs``/``eps_rel``
    override the settings' (the 10x check)."""
    m = data.A.shape[0]
    dtype = x.dtype
    f = np_dtype(dtype)
    eps_abs = settings.eps_abs if eps_abs is None else eps_abs
    eps_rel = settings.eps_rel if eps_rel is None else eps_rel
    unscaled = not settings.scaled_termination
    Px = data.P @ x
    Ax = data.A @ x if m else x.new_zeros((0,))
    Aty = data.A.T @ y if m else torch.zeros_like(x)

    # primal residual (ref _osqp.py:714-726)
    if m:
        pri_vec = Ax - z
        pri_res = _inf_norm(scal.Einv * pri_vec) if unscaled else _inf_norm(pri_vec)
    else:
        pri_res = x.new_zeros(())

    # dual residual (ref _osqp.py:753-764)
    dua_vec = Px + data.q + Aty
    dua_res = scal.cinv * _inf_norm(scal.Dinv * dua_vec) if unscaled else _inf_norm(dua_vec)

    # objective (ref _osqp.py:705-712)
    quad = 0.5 * (x @ Px)
    qx = data.q @ x
    obj_val = (quad + qx) * scal.cinv

    # unscaled dual objective (loose-bound terms dropped); computational
    # zeros of y (below eps_mach * |y|_inf) are cut before the sup
    if m:
        y_u = scal.cinv * (scal.E * y)
        y_tol = torch.finfo(dtype).eps * _inf_norm(y_u)
        y_u = torch.where(y_u.abs() > y_tol, y_u, 0.0)
        l_u = scal.Einv * data.l
        u_u = scal.Einv * data.u
        loose = f(OSQP_INFTY * MIN_SCALING)
        sup_pos = torch.where(u_u < loose, u_u * torch.clamp(y_u, min=0), 0.0)
        sup_neg = torch.where(l_u > -loose, l_u * torch.clamp(y_u, max=0), 0.0)
        sup = torch.sum(sup_pos) + torch.sum(sup_neg)
        sup_mag = torch.sum(sup_pos.abs()) + torch.sum(sup_neg.abs())
    else:
        sup = x.new_zeros(())
        sup_mag = x.new_zeros(())
    dual_obj_val = -quad * scal.cinv - sup
    # rounding-noise floor of the computed duality gap
    gap_noise = torch.finfo(dtype).eps * (
        sup_mag + (quad * scal.cinv).abs() + qx.abs() * scal.cinv)

    # negative curvature -> non-convex flag via exploding residual
    noncvx = quad * scal.cinv < -1e-12 * torch.clamp(x @ x, min=1.0)
    pri_res = torch.where(noncvx, f(2 * OSQP_INFTY), pri_res)

    # tolerances (ref _osqp.py:728-751, 766-794)
    if m:
        Ax_t = _inf_norm(scal.Einv * Ax) if unscaled else _inf_norm(Ax)
        z_t = _inf_norm(scal.Einv * z) if unscaled else _inf_norm(z)
        max_rel_pri = torch.maximum(Ax_t, z_t)
    else:
        max_rel_pri = x.new_zeros(())
    eps_pri = eps_abs + eps_rel * max_rel_pri

    def _d(v):
        return _inf_norm(scal.Dinv * v) if unscaled else _inf_norm(v)

    scale_d = scal.cinv if unscaled else f(1)
    max_rel_dua = scale_d * torch.maximum(torch.maximum(_d(Aty), _d(Px)), _d(data.q))
    eps_dua = eps_abs + eps_rel * max_rel_dua

    return pri_res, dua_res, obj_val, dual_obj_val, eps_pri, eps_dua, gap_noise


def primal_infeasibility(data: QPData, scal: Scaling, delta_y, eps_prim_inf, unscaled: bool):
    """(ref _osqp.py:796-820)"""
    if data.A.shape[0] == 0:
        return torch.zeros((), dtype=torch.bool, device=delta_y.device)
    norm_dy = _inf_norm(scal.E * delta_y) if unscaled else _inf_norm(delta_y)
    lhs = data.u @ torch.clamp(delta_y, min=0) + data.l @ torch.clamp(delta_y, max=0)
    At_dy = data.A.T @ delta_y
    At_dy_n = _inf_norm(scal.Dinv * At_dy) if unscaled else _inf_norm(At_dy)
    return ((norm_dy > eps_prim_inf) & (lhs < -eps_prim_inf * norm_dy)
            & (At_dy_n < eps_prim_inf * norm_dy))


def dual_infeasibility(data: QPData, scal: Scaling, delta_x, eps_dual_inf, unscaled: bool):
    """(ref _osqp.py:822-878)"""
    m = data.A.shape[0]
    f = np_dtype(delta_x.dtype)
    norm_dx = _inf_norm(scal.D * delta_x) if unscaled else _inf_norm(delta_x)
    cost_scale = scal.c if unscaled else f(1)
    ok = norm_dx > eps_dual_inf
    ok &= (data.q @ delta_x) < -cost_scale * eps_dual_inf * norm_dx
    P_dx = data.P @ delta_x
    P_dx_n = _inf_norm(scal.Dinv * P_dx) if unscaled else _inf_norm(P_dx)
    ok &= P_dx_n < cost_scale * eps_dual_inf * norm_dx
    if m:
        A_dx = data.A @ delta_x
        if unscaled:
            A_dx = scal.Einv * A_dx
        loose = f(OSQP_INFTY * MIN_SCALING)
        bad = ((data.u < loose) & (A_dx > eps_dual_inf * norm_dx)) | (
            (data.l > -loose) & (A_dx < -eps_dual_inf * norm_dx))
        ok &= ~torch.any(bad)
    return ok


def termination_status(data: QPData, scal: Scaling, x, z, y, delta_x, delta_y,
                       settings: CoreSettings, approximate: bool):
    """The full termination decision at the given iterates, as 0-d tensors
    ``(status, pri_res, dua_res, obj_val, dual_obj_val, rel_kkt)``; status
    is UNSOLVED if not terminal."""
    f = np_dtype(x.dtype)
    factor = f(10.0 if approximate else 1.0)
    eps_abs = settings.eps_abs * factor
    eps_rel = settings.eps_rel * factor
    eps_pinf = settings.eps_prim_inf * factor
    eps_dinf = settings.eps_dual_inf * factor
    unscaled = not settings.scaled_termination
    m = data.A.shape[0]

    pri_res, dua_res, obj_val, dual_obj, eps_pri, eps_dua, gap_noise = compute_info(
        data, scal, x, z, y, settings, eps_abs, eps_rel)

    noncvx = (pri_res > OSQP_INFTY) | (dua_res > OSQP_INFTY)
    pri_check = pri_res < eps_pri if m else torch.ones((), dtype=torch.bool, device=x.device)
    dua_check = dua_res < eps_dua
    gap = obj_val - dual_obj
    eps_gap = eps_abs + eps_rel * torch.maximum(obj_val.abs(), dual_obj.abs()) + 10.0 * gap_noise
    if settings.check_dualgap:
        gap_ok = torch.isfinite(gap) & (gap.abs() < eps_gap)
    else:
        gap_ok = torch.ones((), dtype=torch.bool, device=x.device)
    pinf = ~pri_check & primal_infeasibility(data, scal, delta_y, eps_pinf, unscaled)
    dinf = ~dua_check & dual_infeasibility(data, scal, delta_x, eps_dinf, unscaled)

    solved_code = _SOLVED_INACC if approximate else _SOLVED
    pinf_code = _PRIM_INF_INACC if approximate else _PRIM_INF
    dinf_code = _DUAL_INF_INACC if approximate else _DUAL_INF
    un = torch.full((), _UNSOLVED, dtype=torch.int32, device=x.device)
    status = torch.where(
        noncvx, _NON_CVX,
        torch.where(pri_check & dua_check & gap_ok, solved_code,
                    torch.where(pinf, pinf_code, torch.where(dinf, dinf_code, un))),
    ).to(torch.int32)

    obj_val = torch.where(
        status == _NON_CVX, torch.nan,
        torch.where(status == pinf_code, f(OSQP_INFTY),
                    torch.where(status == dinf_code, f(-OSQP_INFTY), obj_val)))

    # relative KKT error; the scales come back from eps = eps_abs + eps_rel * scale
    one = pri_res.new_ones(())
    if eps_rel > 0:
        den = max(eps_rel, f(1e-30))
        scale_pri = (eps_pri - eps_abs) / den
        scale_dua = (eps_dua - eps_abs) / den
    else:
        scale_pri = scale_dua = one
    gap_rel = torch.where(
        torch.isfinite(gap),
        gap.abs() / torch.maximum(one, torch.maximum(obj_val.abs(), dual_obj.abs())),
        0.0)
    pri_fin = torch.where(torch.isfinite(pri_res), pri_res, 0.0)
    rel_kkt = torch.maximum(
        torch.maximum(pri_fin / torch.maximum(one, scale_pri),
                      dua_res / torch.maximum(one, scale_dua)),
        gap_rel)
    return status, pri_res, dua_res, obj_val, dual_obj, rel_kkt


# ---------------------------------------------------------------------------
# The solve loop
# ---------------------------------------------------------------------------


@dataclass
class LoopState:
    """The host loop's state: iterate tensors and host scalars."""

    it: int
    status: int
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    xtld: torch.Tensor  # last x_tilde (CG warm start)
    delta_x: torch.Tensor
    delta_y: torch.Tensor
    rho: RhoState
    factor: Factor
    pri_res: np.floating
    dua_res: np.floating
    obj_val: np.floating
    dual_obj_val: np.floating
    rho_estimate: np.floating
    rho_updates: int
    cg_tol: np.floating  # adaptive CG relative tolerance
    cg_iters: int
    rel_kkt: np.floating
    primdual_acc: np.floating
    host_syncs: int


def admm_iteration(data: QPData, settings: CoreSettings, st: LoopState, indirect: bool):
    """One ADMM step (ref _osqp.py:644-703).

    It reassigns ``st``'s fields to new tensors and never writes into a
    tensor in place.  The chunked solve relies on this: a KeyboardInterrupt
    that lands mid-chunk leaves the previous chunk's iterates, which this
    chunk started from, intact."""
    rho_vec, rho_inv = st.rho.rho_vec, st.rho.rho_inv_vec
    if st.factor.ldl is not None:
        x, z, y, delta_y, x_tilde = ldl_admm_step(data, settings, st.factor.ldl, st.x, st.z,
                                                  st.y, st.delta_y, rho_vec, rho_inv)
    else:
        rhs, b2 = kkt_rhs(data, settings, st.x, st.z, st.y, rho_vec, rho_inv)
        if indirect:
            x_tilde, k, syncs = pcg_solve(data.P, data.A, settings.sigma, rho_vec,
                                          st.factor.diag, rhs, st.xtld, st.cg_tol,
                                          settings.cg_max_iter)
            st.cg_iters += k
            st.host_syncs += syncs
        else:
            x_tilde = _cho_solve(st.factor.L, rhs)
        x, z, y, delta_y = admm_update(data, settings, st.x, st.z, st.y, st.delta_y, x_tilde,
                                       b2, rho_vec, rho_inv)
    st.delta_x = x - st.x
    st.x, st.z, st.y, st.xtld, st.delta_y = x, z, y, x_tilde, delta_y


def kkt_rhs(data: QPData, settings: CoreSettings, x, z, y, rho_vec, rho_inv):
    """The KKT right-hand side reduced to the normal equations:
    ``b1 = sigma x - q``, ``b2 = z - y / rho``, ``rhs = b1 + A' diag(rho) b2``.
    Returns ``(rhs, b2)`` (``b2`` None when m = 0)."""
    b1 = settings.sigma * x - data.q
    if not data.A.shape[0]:
        return b1, None
    b2 = z - rho_inv * y
    return b1 + data.A.T @ (rho_vec * b2), b2


def admm_update(data: QPData, settings: CoreSettings, x_prev, z_prev, y, delta_y, x_tilde, b2,
                rho_vec, rho_inv):
    """The ADMM step after the KKT solve: relaxation, the projection onto
    [l, u] and the dual update.  Returns ``(x, z, y, delta_y)``; with m = 0,
    z and ``delta_y`` come back as given."""
    alpha = settings.alpha
    one_m_alpha = type(alpha)(1) - alpha
    x = alpha * x_tilde + one_m_alpha * x_prev
    if not data.A.shape[0]:
        return x, z_prev, y, delta_y
    nu = rho_vec * (data.A @ x_tilde - b2)
    z_tilde = z_prev + rho_inv * (nu - y)
    z_relax = alpha * z_tilde + one_m_alpha * z_prev
    z = torch.clamp(z_relax + rho_inv * y, data.l, data.u)
    delta_y = rho_vec * (z_relax - z)
    return x, z, y + delta_y, delta_y


def ldl_admm_step(data: QPData, settings: CoreSettings, kkt, x_prev, z_prev, y, delta_y,
                  rho_vec, rho_inv):
    """One ADMM step on the full KKT system, as the JAX package's numpy
    algebra takes it (``_oracle/solver.py::_admm_step``): ``x_tilde, nu``
    from one solve of ``[[P + sigma I, A'], [A, -diag(1/rho)]]`` with the
    right-hand side ``[sigma x - q; z - y / rho]``, then ``z_tilde = z +
    (nu - y) / rho``, the relaxation, the projection onto [l, u] and the
    dual update.  Returns ``(x, z, y, delta_y, x_tilde)``."""
    n = x_prev.shape[0]
    alpha = settings.alpha
    one_m_alpha = type(alpha)(1) - alpha
    m = data.A.shape[0]
    b1 = settings.sigma * x_prev - data.q
    rhs = torch.cat([b1, z_prev - rho_inv * y]) if m else b1
    sol = kkt.solve(rhs)
    x_tilde = sol[:n]
    x = alpha * x_tilde + one_m_alpha * x_prev
    if not m:
        return x, z_prev, y, delta_y, x_tilde
    z_tilde = z_prev + rho_inv * (sol[n:] - y)
    z_relax = alpha * z_tilde + one_m_alpha * z_prev
    z = torch.clamp(z_relax + rho_inv * y, data.l, data.u)
    delta_y = rho_vec * (z_relax - z)
    return x, z, y + delta_y, delta_y, x_tilde


def rho_estimate_fn(data: QPData, x, z, y, rho):
    """New rho from the relative residuals (ref _osqp.py:880-930), a 0-d
    tensor clipped to [RHO_MIN, RHO_MAX]."""
    m = data.A.shape[0]
    Ax = data.A @ x if m else x.new_zeros((0,))
    Px = data.P @ x
    Aty = data.A.T @ y if m else torch.zeros_like(x)
    pri = _inf_norm(Ax - z) if m else x.new_zeros(())
    if m:
        pri = pri / (torch.maximum(_inf_norm(Ax), _inf_norm(z)) + 1e-10)
    dua = _inf_norm(Px + data.q + Aty)
    dua = dua / (torch.maximum(torch.maximum(_inf_norm(Aty), _inf_norm(Px)),
                               _inf_norm(data.q)) + 1e-10)
    new_rho = rho * torch.sqrt(pri / (dua + 1e-10))
    return torch.clamp(new_rho, RHO_MIN, RHO_MAX)


def _host(st: LoopState, *tensors):
    """Copy 0-d tensors to the host in one transfer: one host sync."""
    st.host_syncs += 1
    vals = torch.stack([t.to(tensors[0].dtype) for t in tensors])
    with tracing.span('sync', d2h=vals.nbytes):
        return vals.cpu().numpy()


def adapt_rho(data: QPData, settings: CoreSettings, st: LoopState, indirect: bool):
    """Adaptive rho: estimate, and on a trigger rebuild the rho vector and
    refactor (direct; sparse direct numerically on the same symbolic, one
    host sync for the inertia) or rebuild the preconditioner diagonal
    (indirect)."""
    f = np_dtype(st.x.dtype)
    rho_new = f(_host(st, rho_estimate_fn(data, st.x, st.z, st.y, st.rho.rho))[0])
    tol = settings.adaptive_rho_tolerance
    if rho_new > tol * st.rho.rho or rho_new < st.rho.rho / tol:
        with tracing.span('rho.update'):
            dtype = st.x.dtype
            vec = rho_vec_from_types(st.rho.constr_type, rho_new, settings.rho_is_vec, dtype)
            inv = torch.where(vec > 0, 1.0 / vec, 0.0)
            st.rho = RhoState(rho=clip_rho(rho_new, dtype), rho_vec=vec, rho_inv_vec=inv,
                              constr_type=st.rho.constr_type)
            if st.factor.ldl is not None:
                st.factor = st.factor._replace(ldl=st.factor.ldl.refactor(inv))
                st.host_syncs += 1
            elif indirect:
                st.factor = st.factor._replace(diag=build_M_diag(data.P, data.A, settings.sigma,
                                                                 vec))
            else:
                st.factor = factorize(data.P, data.A, settings.sigma, vec)
        st.rho_updates += 1
    st.rho_estimate = rho_new


def _run_check(data, scal, settings, st: LoopState, approximate=False):
    """Termination check at the current iterates, read to the host in one
    transfer.  Returns ``(status, pri, dua, obj, dobj, rel_kkt)``."""
    f = np_dtype(st.x.dtype)
    out = termination_status(data, scal, st.x, st.z, st.y, st.delta_x, st.delta_y,
                             settings, approximate)
    vals = _host(st, *out[1:], out[0])
    return (int(vals[5]), *(f(v) for v in vals[:5]))


def solve_scaled(data: QPData, scal: Scaling, settings: CoreSettings, rho: RhoState,
                 factor: Factor, iterates: Iterates, indirect: bool = False,
                 verbose: bool = False, it0: int = 0, adapt_after=None) -> SolveResult:
    """Run the ADMM loop on already-scaled data: epochs of
    ``check_termination`` iterations, each followed by the termination check,
    the CG-tolerance update (indirect mode) and, every adaptation interval,
    adaptive rho; then the post-loop 10x check and unscaling
    (``osqp_tpu/solver/core.py::solve_scaled_impl``).

    ``it0`` is the iteration count a chunk starts from: the loop runs until
    ``settings.iter_cap``, and only a run that reaches ``settings.max_iter``
    unsolved takes the post-loop check.  ``verbose`` prints a row at every
    check epoch whose iteration count is a multiple of ``PRINT_INTERVAL``.

    ``adapt_after`` ``(t0, seconds)`` takes the time-based first adaptation
    of the numpy algebra (``adaptive_rho_fraction > 0``,
    ``_oracle/solver.py:711-766``): the first adaptation comes at the first
    check epoch past ``seconds`` after the host clock's ``t0``, and the
    interval is then frozen at that iteration count."""
    n = data.P.shape[0]
    m = data.A.shape[0]
    x0 = iterates.x
    dtype = x0.dtype
    f = np_dtype(dtype)

    st = LoopState(
        it=int(it0), status=_UNSOLVED,
        x=iterates.x, z=iterates.z, y=iterates.y, xtld=iterates.x,
        delta_x=x0.new_zeros((n,)), delta_y=x0.new_zeros((m,)),
        rho=rho, factor=factor,
        pri_res=f(np.inf), dua_res=f(np.inf), obj_val=f(np.nan), dual_obj_val=f(np.nan),
        rho_estimate=rho.rho, rho_updates=0, cg_tol=f(1e-3), cg_iters=0,
        rel_kkt=f(1), primdual_acc=f(0), host_syncs=0,
    )

    ct = settings.check_termination
    iter_cap = settings.iter_cap
    epoch_len = ct if ct > 0 else iter_cap
    interval = settings.adaptive_rho_interval
    epochs_per_adapt = max((interval + epoch_len - 1) // max(epoch_len, 1), 1)

    with tracing.span('solve.loop'):
        while st.it < iter_cap and st.status == _UNSOLVED:
            this_epoch = min(epoch_len, iter_cap - st.it)
            for _ in range(this_epoch):
                admm_iteration(data, settings, st, indirect)
            st.it += this_epoch

            pri_before, dua_before = st.pri_res, st.dua_res
            do_check = ct > 0 and st.it % max(ct, 1) == 0
            if do_check:
                (st.status, st.pri_res, st.dua_res, st.obj_val, st.dual_obj_val,
                 st.rel_kkt) = _run_check(data, scal, settings, st)
            # primal-dual integral: iteration integral of the capped relative
            # KKT error (last-known value; converted to time by the backend)
            st.primdual_acc = st.primdual_acc + f(this_epoch) * np.minimum(f(1), st.rel_kkt)
            if verbose and do_check and st.it % PRINT_INTERVAL == 0:
                print_loop_row(st.it, st.obj_val, st.pri_res, st.dua_res, st.rho.rho)

            # Adaptive CG tolerance (indirect mode): monotone tightening toward
            # the ADMM residual scale, with a forced 1/cg_tol_reduction cut
            # whenever both residuals stall; only at check epochs.
            if do_check:
                candidate = settings.cg_tol_fraction * np.sqrt(st.pri_res * st.dua_res)
                new_cg_tol = np.clip(np.minimum(st.cg_tol, candidate), settings.cg_eps_min, f(0.15))
                stalled = (st.pri_res > f(0.5) * pri_before) and (st.dua_res > f(0.5) * dua_before)
                if stalled:
                    reduction = np.maximum(settings.cg_tol_reduction, f(1))
                    new_cg_tol = np.maximum(new_cg_tol / reduction, settings.cg_eps_min)
                st.cg_tol = f(new_cg_tol)

            epoch_idx = (st.it + epoch_len - 1) // max(epoch_len, 1)
            if not settings.adaptive_rho or st.status != _UNSOLVED:
                pass
            elif adapt_after is not None:
                if do_check and time.perf_counter() - adapt_after[0] > adapt_after[1]:
                    adapt_rho(data, settings, st, indirect)
                    epochs_per_adapt = max(-(-max(st.it, ct) // max(epoch_len, 1)), 1)
                    adapt_after = None
            elif interval > 0 and epoch_idx % epochs_per_adapt == 0:
                adapt_rho(data, settings, st, indirect)

        # Post-loop bookkeeping (ref _osqp.py:1248-1275): if no terminal status,
        # re-check exactly, then approximately (10x eps), else MAX_ITER_REACHED.
        if st.status == _UNSOLVED and st.it >= settings.max_iter:
            (st.status, st.pri_res, st.dua_res, st.obj_val, st.dual_obj_val,
             st.rel_kkt) = _run_check(data, scal, settings, st)
            if st.status == _UNSOLVED:
                status, _, _, obj, _, _ = _run_check(data, scal, settings, st, approximate=True)
                st.status = _MAX_ITER if status == _UNSOLVED else status
                # keep the accurate residuals for reporting
                if st.status in (_PRIM_INF_INACC, _DUAL_INF_INACC, _NON_CVX):
                    st.obj_val = obj

        rho_est = f(_host(st, rho_estimate_fn(data, st.x, st.z, st.y, st.rho.rho))[0])

    # Unscale the solution (ref _osqp.py:1098-1115)
    infeasible = st.status in (_PRIM_INF, _PRIM_INF_INACC, _DUAL_INF, _DUAL_INF_INACC)
    if infeasible:
        x_out = torch.full_like(st.x, torch.nan)
        y_out = torch.full_like(st.y, torch.nan) if m else st.y
    else:
        x_out = scal.D * st.x
        y_out = scal.cinv * (scal.E * st.y) if m else st.y
    unscaled = not settings.scaled_termination
    prim_cert = scal.E * st.delta_y if (unscaled and m) else st.delta_y
    dual_cert = scal.D * st.delta_x if unscaled else st.delta_x

    return SolveResult(
        x=x_out, y=y_out, prim_inf_cert=prim_cert, dual_inf_cert=dual_cert,
        status=st.status, iters=st.it, pri_res=st.pri_res, dua_res=st.dua_res,
        obj_val=st.obj_val, dual_obj_val=st.dual_obj_val,
        duality_gap=f(st.obj_val - st.dual_obj_val), rho_estimate=rho_est,
        rho_updates=st.rho_updates, cg_iters=st.cg_iters, host_syncs=st.host_syncs,
        rel_kkt_error=st.rel_kkt, primdual_acc=st.primdual_acc,
        iterates=Iterates(x=st.x, z=st.z, y=st.y), rho=st.rho, factor=st.factor,
    )


# ---------------------------------------------------------------------------
# Polish (ref _osqp.py:1693-1828): active-set masking, shape-stable
# ---------------------------------------------------------------------------


class PolishResult(NamedTuple):
    success: bool
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    obj_val: np.floating
    pri_res: np.floating
    dua_res: np.floating
    cg_iters: int  # PCG steps of the Schur solves (sparse mode)
    host_syncs: int


def polish(data: QPData, scal: Scaling, settings: CoreSettings, delta, refine_iters: int,
           x, z, y, pri_res, dua_res) -> PolishResult:
    """Active-set polish (``osqp_tpu/solver/core.py::polish``).  Inactive rows
    of A are masked to zero, which makes the (2,2) block enforce ``y_i = 0``
    exactly for inactive constraints.

    Dense data: Cholesky of the Schur form.  Sparse operators (sparse mode):
    diagonally-preconditioned CG on the same operator, matvec-only, so the
    reduced system is never materialized; each CG step reads its residual
    norm on the host.  ``delta``, ``pri_res`` and ``dua_res`` are host
    scalars; the acceptance test reads the polished residuals in one more
    host sync."""
    n = data.P.shape[0]
    m = data.A.shape[0]
    dtype = x.dtype
    f = np_dtype(dtype)
    delta = f(delta)
    sparse_mode = spmv.is_structured(data.P) or spmv.is_structured(data.A)

    if m:
        low = (z - data.l) < -y  # lower-active guess (ref _osqp.py:1719)
        upp = (data.u - z) < y  # upper-active guess (ref _osqp.py:1720)
        active = low | upp
        mask = active.to(dtype)
        b2 = torch.where(low, data.l, torch.where(upp, data.u, 0.0))
    else:
        b2 = None

    # masked-row products: Ared = diag(mask) A, never materialized
    def ared_mv(v):
        return mask * (data.A @ v)

    def aredt_mv(w):
        return data.A.T @ (mask * w)

    # Reduced KKT [[P + dI, Ared'], [Ared, -dI]] solved through its Schur
    # form M = P + dI + Ared' (1/d) Ared; inactive rows give y_i = 0.
    counts = dict(cg_iters=0, host_syncs=0)
    if sparse_mode:
        w = mask / delta if m else None
        diag_M = mat_diag(data.P) + delta
        if m:
            diag_M = diag_M + gram_diag(data.A, w)
        cg_tol = f(1e-12 if dtype == torch.float64 else 1e-7)

        def schur_solve(rhs):
            xs, k, syncs = pcg_solve(data.P, data.A, delta, w, diag_M, rhs,
                                     torch.zeros_like(rhs), cg_tol, 4 * n)
            counts['cg_iters'] += k
            counts['host_syncs'] += syncs
            return xs
    else:
        M = data.P + delta * torch.eye(n, dtype=dtype, device=x.device)
        if m:
            Ared = mask[:, None] * data.A
            M = M + Ared.T @ (Ared / delta)
        L, info = torch.linalg.cholesky_ex(M)
        L = torch.where(info == 0, L, torch.nan)  # NaN, as JAX's Cholesky gives

        def schur_solve(rhs):
            return _cho_solve(L, rhs)

    b1 = -data.q

    def kkt_solve(r1, r2):
        if not m:
            return schur_solve(r1), x.new_zeros((0,))
        xs = schur_solve(r1 + aredt_mv(r2 / delta))
        return xs, (ared_mv(xs) - r2) / delta

    x_pol, y_red = kkt_solve(b1, b2)

    # iterative refinement against the *unregularized* reduced KKT operator
    # (ref _osqp.py:1693-1708)
    for _ in range(int(refine_iters)):
        r1 = b1 - (data.P @ x_pol + aredt_mv(y_red) if m else data.P @ x_pol)
        r2 = b2 - ared_mv(x_pol) if m else None
        dx, dy = kkt_solve(r1, r2)
        x_pol, y_red = x_pol + dx, y_red + dy

    if m:
        z_pol = data.A @ x_pol
        y_pol = torch.where(active, y_red, 0.0)
        # normal-cone projection (ref _osqp.py:676-680)
        tmp = z_pol + y_pol
        z_pol = torch.clamp(tmp, data.l, data.u)
        y_pol = tmp - z_pol
    else:
        z_pol = y_pol = x.new_zeros((0,))

    pri_pol, dua_pol, obj_pol, *_ = compute_info(data, scal, x_pol, z_pol, y_pol, settings)
    pri_pol, dua_pol, obj_pol = (f(v) for v in
                                 torch.stack([pri_pol, dua_pol, obj_pol]).cpu().numpy())
    counts['host_syncs'] += 1

    # acceptance test (ref _osqp.py:1786-1793)
    pri_res, dua_res = f(pri_res), f(dua_res)
    success = bool(((pri_pol < pri_res) and (dua_pol < dua_res))
                   or ((pri_pol < pri_res) and (dua_res < 1e-10))
                   or ((dua_pol < dua_res) and (pri_res < 1e-10)))
    return PolishResult(success=success, x=x_pol, z=z_pol, y=y_pol, obj_val=obj_pol,
                        pri_res=pri_pol, dua_res=dua_pol, **counts)


class LineSearchFamily(NamedTuple):
    t: torch.Tensor  # (N,)
    X: torch.Tensor  # (N, n) unscaled primal samples
    Z: torch.Tensor  # (N, m)
    Y: torch.Tensor  # (N, m)


def line_search_family(data: QPData, scal: Scaling, x1, z1, y1, x2, z2, y2,
                       n_points: int = 1000, t_max=0.002) -> LineSearchFamily:
    """Polish line-search fallback (ref _osqp.py:1817-1826, 1830-1855): when
    the polished point does not dominate, sample ``t = linspace(0, t_max,
    N)`` on the segment from the ADMM iterates (``x1, z1, y1``) to the
    polished ones (``x2, z2, y2``), project each sample onto the normal cone
    in one batched clamp, and return the unscaled family for diagnostics (no
    better point is adopted).

    As in ``osqp_tpu/solver/core.py::line_search_family``, Y is unscaled by
    ``cinv * E``, consistently with ``solution.y`` (the reference unscales it
    by E only)."""
    m = data.A.shape[0]
    t = torch.linspace(0.0, t_max, n_points, dtype=x1.dtype, device=x1.device)
    X = x1[None, :] + t[:, None] * (x2 - x1)[None, :]
    Z = z1[None, :] + t[:, None] * (z2 - z1)[None, :]
    Y = y1[None, :] + t[:, None] * (y2 - y1)[None, :]
    tmp = Z + Y
    Z = torch.clamp(tmp, data.l[None, :], data.u[None, :])
    Y = tmp - Z
    X = X * scal.D[None, :]
    if m:
        Z = Z * scal.Einv[None, :]
        Y = scal.cinv * (Y * scal.E[None, :])
    return LineSearchFamily(t=t, X=X, Z=Z, Y=Y)
