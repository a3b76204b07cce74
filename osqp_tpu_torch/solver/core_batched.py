"""The ADMM solver core over a batch of QPs, each with its own P and A.

Counterpart of ``osqp_tpu/solver/core.py`` as ``jax.vmap`` sees it (the
vmap engine of ``osqp_tpu/batch.py``): every tensor carries a leading batch
axis B, and the per-instance scalars (rho, the cost scale c, status,
iteration count, CG tolerance, ...) are (B,) tensors.  The functions keep the
names of their single-QP counterparts in ``core.py``.

The JAX package runs the loop as one vmapped ``lax.while_loop``.  Here it is
a host loop over epochs that reproduces the vmapped semantics explicitly:

* the batched ``while_loop`` runs its body for every instance and keeps the
  old state of each instance whose predicate was false, so an instance that
  has stopped is frozen: its iteration count, status, iterates, rho and
  factor never change again (``_select`` after every epoch);
* a batched ``lax.cond`` computes both branches and selects, so adaptive rho
  refactorizes every instance and only those whose trigger fired (and that
  are still unsolved) take the new rho and factor;
* every live instance starts at iteration 0 under one ``iter_cap``, so the
  epoch length and the check and adaptation epochs are the same for all of
  them and are decided on the host.

The loop reads one value per epoch on the host (how many instances are still
running); in indirect mode the batched PCG reads one more per CG step (is any
instance's CG still running).  Each read is one host sync and is counted.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import torch

from ..constants import (
    MIN_SCALING,
    OSQP_INFTY,
    RHO_EQ_OVER_RHO_INEQ,
    RHO_MAX,
    RHO_MIN,
    SolverStatus,
)
from ..settings import CoreSettings, np_dtype
from .core import _limit_scaling, constraint_types  # noqa: F401  (elementwise, shared)

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
    """Scaled problem data of the batch (dense)."""

    P: torch.Tensor  # (B, n, n) symmetric
    q: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)


class Scaling(NamedTuple):
    D: torch.Tensor  # (B, n)
    Dinv: torch.Tensor  # (B, n)
    E: torch.Tensor  # (B, m)
    Einv: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B,) cost scale
    cinv: torch.Tensor  # (B,)


class RhoState(NamedTuple):
    rho: torch.Tensor  # (B,) clamped
    rho_vec: torch.Tensor  # (B, m)
    rho_inv_vec: torch.Tensor  # (B, m)
    constr_type: torch.Tensor  # (B, m) int8: -1 loose, 0 ineq, 1 eq


class Factor(NamedTuple):
    """KKT factorization state of each instance.

    kkt_method='chol': ``L`` the Cholesky factor of M, ``Minv`` None.
    kkt_method='inv': ``L`` is M itself (for the refinement residual) and
    ``Minv`` its inverse; each iteration is a matvec and one refinement step.
    Indirect mode: ``L`` and ``Minv`` None; ``diag`` = diag(M), the CG
    preconditioner."""

    L: Optional[torch.Tensor]  # (B, n, n)
    diag: torch.Tensor  # (B, n)
    Minv: Optional[torch.Tensor]  # (B, n, n)


class Iterates(NamedTuple):
    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)


class SolveResult(NamedTuple):
    x: torch.Tensor  # (B, n) unscaled primal (NaN if infeasible)
    y: torch.Tensor  # (B, m) unscaled dual (NaN if infeasible)
    prim_inf_cert: torch.Tensor
    dual_inf_cert: torch.Tensor
    status: torch.Tensor  # (B,) int32
    iters: torch.Tensor  # (B,) int32
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor
    obj_val: torch.Tensor
    dual_obj_val: torch.Tensor
    duality_gap: torch.Tensor
    rho_estimate: torch.Tensor
    rho_updates: torch.Tensor  # (B,) int32
    cg_iters: torch.Tensor  # (B,) int32
    host_syncs: int  # the port's own count, for the whole batch
    rel_kkt_error: torch.Tensor
    primdual_acc: torch.Tensor
    iterates: Iterates  # final scaled iterates (for warm restarts)
    rho: RhoState
    factor: Factor


# ---------------------------------------------------------------------------
# Small helpers: per-instance products and norms over the last axis
# ---------------------------------------------------------------------------


def _mv(M, v):
    """M @ v per instance: (B, r, c) x (B, c) -> (B, r)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    """M' @ v per instance: (B, r, c) x (B, r) -> (B, c)."""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def _dot(a, b):
    return torch.linalg.vecdot(a, b)


def _inf_norm(v):
    return v.abs().amax(dim=-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])


def _col(v):
    """A (B,) tensor as a (B, 1) column, to scale each instance's vector."""
    return v.unsqueeze(-1)


def _where(mask, new, old):
    """Per instance: ``new`` where ``mask`` (B,), else ``old``."""
    if new is None:
        return None
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def _select(mask, new, old):
    """The batched while_loop's select over a tuple of tensors."""
    return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))


# ---------------------------------------------------------------------------
# Ruiz equilibration (ref _osqp.py:389-497)
# ---------------------------------------------------------------------------


def ruiz_scale(P, q, A, l, u, n_iters: int):
    """Modified-Ruiz equilibration of each instance's stacked KKT columns
    plus cost normalization, the batched ``core.ruiz_scale``.  Returns
    (QPData, Scaling) with a (B,) cost scale."""
    B, n = q.shape
    m = A.shape[-2]
    D = torch.ones((B, n), dtype=P.dtype, device=P.device)
    E = torch.ones((B, m), dtype=P.dtype, device=P.device)
    c = torch.ones((B,), dtype=P.dtype, device=P.device)
    for _ in range(n_iters):
        norm_P_col = P.abs().amax(dim=-2) if n else P.new_zeros((B, 0))
        if m:
            norm_A_col = A.abs().amax(dim=-2)
            norm_A_row = A.abs().amax(dim=-1)
        else:
            norm_A_col = P.new_zeros((B, n))
            norm_A_row = P.new_zeros((B, 0))
        d = 1.0 / torch.sqrt(_limit_scaling(torch.maximum(norm_P_col, norm_A_col)))
        e = 1.0 / torch.sqrt(_limit_scaling(norm_A_row))

        P = d.unsqueeze(-1) * P * d.unsqueeze(-2)
        A = e.unsqueeze(-1) * A * d.unsqueeze(-2)
        q = d * q
        l = e * l
        u = e * u
        D = D * d
        E = E * e

        # cost normalization (ref _osqp.py:443-468)
        norm_P_cols_mean = P.abs().amax(dim=-2).mean(dim=-1) if n else P.new_zeros((B,))
        inf_norm_q = _limit_scaling(_inf_norm(q))
        scale_cost = 1.0 / _limit_scaling(torch.maximum(inf_norm_q, norm_P_cols_mean))
        P = scale_cost[:, None, None] * P
        q = _col(scale_cost) * q
        c = scale_cost * c
    scal = Scaling(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E if m else E, c=c, cinv=1.0 / c)
    return QPData(P=P, q=q, A=A, l=l, u=u), scal


def identity_scaling(B, n, m, dtype, device):
    one_n = torch.ones((B, n), dtype=dtype, device=device)
    one_m = torch.ones((B, m), dtype=dtype, device=device)
    one = torch.ones((B,), dtype=dtype, device=device)
    return Scaling(D=one_n, Dinv=one_n, E=one_m, Einv=one_m, c=one, cinv=one)


# ---------------------------------------------------------------------------
# rho management (ref _osqp.py:499-562)
# ---------------------------------------------------------------------------


def rho_vec_from_types(types, rho, rho_is_vec: bool):
    """Per-constraint rho of each instance from its constraint types and its
    own (B,) rho."""
    rho = _col(rho.clamp(RHO_MIN, RHO_MAX))
    if not rho_is_vec:
        return rho.expand(types.shape).clone()
    return torch.where(types == -1, RHO_MIN,
                       torch.where(types == 1, RHO_EQ_OVER_RHO_INEQ * rho, rho))


def make_rho_state(l, u, rho, rho_is_vec: bool) -> RhoState:
    rho = rho.to(l.dtype).clamp(RHO_MIN, RHO_MAX)
    types = constraint_types(l, u)
    vec = rho_vec_from_types(types, rho, rho_is_vec)
    inv = torch.where(vec > 0, 1.0 / vec, 0.0)
    return RhoState(rho=rho, rho_vec=vec, rho_inv_vec=inv, constr_type=types)


# ---------------------------------------------------------------------------
# KKT operator
# ---------------------------------------------------------------------------


def build_M(P, A, sigma, rho_vec):
    """Normal-equations operator M = P + sigma I + A' diag(rho) A per instance."""
    n = P.shape[-1]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
    if A.shape[-2]:
        M = M + A.mT @ (rho_vec.unsqueeze(-1) * A)
    return M


def build_M_diag(P, A, sigma, rho_vec):
    """diag(M) without forming M (the CG preconditioner)."""
    d = torch.diagonal(P, dim1=-2, dim2=-1) + sigma
    if A.shape[-2]:
        d = d + torch.sum(rho_vec.unsqueeze(-1) * A * A, dim=-2)
    return d


def _cho_solve(L, b):
    """Solve L L' x = b per instance; ``b`` is (B, n) or (B, n, k)."""
    vec = b.dim() == L.dim() - 1
    rhs = b.unsqueeze(-1) if vec else b
    t = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, t, upper=True)
    return x.squeeze(-1) if vec else x


def cholesky(M):
    """Batched Cholesky factor.  An instance whose matrix is not positive
    definite gets a NaN factor of its own, as JAX's Cholesky gives, and
    leaves every other instance's factor as it is."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0).view(-1, *([1] * (M.dim() - 1))), L, torch.nan)


def factorize(P, A, sigma, rho_vec, kkt_method: str = 'chol') -> Factor:
    """Cholesky factor of each instance's M ('chol') or M and its inverse
    ('inv')."""
    M = build_M(P, A, sigma, rho_vec)
    L = cholesky(M)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    if kkt_method == 'inv':
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
        return Factor(L=M, diag=diag, Minv=_cho_solve(L, eye))
    if kkt_method != 'chol':
        raise ValueError(f"kkt_method must be 'chol' or 'inv', got {kkt_method!r}")
    return Factor(L=L, diag=diag, Minv=None)


class _Counter:
    """Host syncs of one solve."""

    def __init__(self):
        self.syncs = 0

    def host(self, *tensors):
        """Copy scalar tensors to the host in one transfer: one host sync."""
        self.syncs += 1
        return torch.stack([t.to(torch.float64) for t in tensors]).cpu().tolist()


def pcg_solve(P, A, sigma, rho_vec, diag, b, x0, rel_tol, max_iter: int, live, counter):
    """Diagonally-preconditioned conjugate gradient on each instance's M(rho).

    Each instance runs until its own ``||r||_2 <= max(rel_tol * ||b||_2,
    tiny)`` or ``max_iter`` steps, and stops there (its values are kept, as
    the vmapped ``lax.while_loop`` keeps them); instances outside ``live``
    take no step.  Before each step the host reads whether any instance is
    still running: one sync a step.  Returns ``(x, iters)`` with (B,) step
    counts."""
    m = A.shape[-2]

    def matvec(v):
        Mv = _mv(P, v) + sigma * v
        if m:
            Mv = Mv + _mtv(A, rho_vec * _mv(A, v))
        return Mv

    dinv = 1.0 / diag
    b_norm = torch.sqrt(_dot(b, b))
    tol = torch.clamp(rel_tol * b_norm, min=torch.finfo(b.dtype).tiny)

    x = x0
    r = b - matvec(x0)
    z = dinv * r
    p = z
    rz = _dot(r, z)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        running = (torch.sqrt(_dot(r, r)) > tol) & live
        if not counter.host(running.any())[0]:
            break
        Mp = matvec(p)
        denom = _dot(p, Mp)
        alpha = _col(rz / torch.where(denom != 0, denom, 1.0))
        x_n = x + alpha * p
        r_n = r - alpha * Mp
        z_n = dinv * r_n
        rz_new = _dot(r_n, z_n)
        beta = _col(rz_new / torch.where(rz != 0, rz, 1.0))
        p_n = z_n + beta * p
        run = _col(running)
        x, r, z, p = (torch.where(run, a, b_) for a, b_ in ((x_n, x), (r_n, r), (z_n, z),
                                                            (p_n, p)))
        rz = torch.where(running, rz_new, rz)
        k = k + running.to(torch.int32)
    return x, k


# ---------------------------------------------------------------------------
# Residuals / termination (ref _osqp.py:705-878, 998-1077)
# ---------------------------------------------------------------------------


def compute_info(data: QPData, scal: Scaling, x, z, y, settings: CoreSettings,
                 eps_abs=None, eps_rel=None):
    """Residual norms, objective values and tolerances of each instance,
    scaled or unscaled per settings, as (B,) tensors: ``(pri_res, dua_res,
    obj_val, dual_obj_val, eps_pri, eps_dua, gap_noise)``.
    ``eps_abs``/``eps_rel`` override the settings' (the 10x check)."""
    m = data.A.shape[-2]
    dtype = x.dtype
    f = np_dtype(dtype)
    eps_abs = settings.eps_abs if eps_abs is None else eps_abs
    eps_rel = settings.eps_rel if eps_rel is None else eps_rel
    unscaled = not settings.scaled_termination
    zero = x.new_zeros(x.shape[:-1])
    Px = _mv(data.P, x)
    Ax = _mv(data.A, x) if m else z
    Aty = _mtv(data.A, y) if m else torch.zeros_like(x)
    cinv = scal.cinv

    # primal residual (ref _osqp.py:714-726)
    if m:
        pri_vec = Ax - z
        pri_res = _inf_norm(scal.Einv * pri_vec) if unscaled else _inf_norm(pri_vec)
    else:
        pri_res = zero

    # dual residual (ref _osqp.py:753-764)
    dua_vec = Px + data.q + Aty
    dua_res = cinv * _inf_norm(scal.Dinv * dua_vec) if unscaled else _inf_norm(dua_vec)

    # objective (ref _osqp.py:705-712)
    quad = 0.5 * _dot(x, Px)
    qx = _dot(data.q, x)
    obj_val = (quad + qx) * cinv

    # unscaled dual objective (loose-bound terms dropped); computational
    # zeros of y (below eps_mach * |y|_inf) are cut before the sup
    if m:
        y_u = _col(cinv) * (scal.E * y)
        y_tol = torch.finfo(dtype).eps * _inf_norm(y_u)
        y_u = torch.where(y_u.abs() > _col(y_tol), y_u, 0.0)
        l_u = scal.Einv * data.l
        u_u = scal.Einv * data.u
        loose = f(OSQP_INFTY * MIN_SCALING)
        sup_pos = torch.where(u_u < loose, u_u * torch.clamp(y_u, min=0), 0.0)
        sup_neg = torch.where(l_u > -loose, l_u * torch.clamp(y_u, max=0), 0.0)
        sup = sup_pos.sum(-1) + sup_neg.sum(-1)
        sup_mag = sup_pos.abs().sum(-1) + sup_neg.abs().sum(-1)
    else:
        sup = sup_mag = zero
    dual_obj_val = -quad * cinv - sup
    # rounding-noise floor of the computed duality gap
    gap_noise = torch.finfo(dtype).eps * (sup_mag + (quad * cinv).abs() + qx.abs() * cinv)

    # negative curvature -> non-convex flag via exploding residual
    noncvx = quad * cinv < -1e-12 * torch.clamp(_dot(x, x), min=1.0)
    pri_res = torch.where(noncvx, f(2 * OSQP_INFTY), pri_res)

    # tolerances (ref _osqp.py:728-751, 766-794)
    if m:
        Ax_t = _inf_norm(scal.Einv * Ax) if unscaled else _inf_norm(Ax)
        z_t = _inf_norm(scal.Einv * z) if unscaled else _inf_norm(z)
        max_rel_pri = torch.maximum(Ax_t, z_t)
    else:
        max_rel_pri = zero
    eps_pri = eps_abs + eps_rel * max_rel_pri

    def _d(v):
        return _inf_norm(scal.Dinv * v) if unscaled else _inf_norm(v)

    max_rel_dua = torch.maximum(torch.maximum(_d(Aty), _d(Px)), _d(data.q))
    if unscaled:
        max_rel_dua = cinv * max_rel_dua
    eps_dua = eps_abs + eps_rel * max_rel_dua

    return pri_res, dua_res, obj_val, dual_obj_val, eps_pri, eps_dua, gap_noise


def primal_infeasibility(data: QPData, scal: Scaling, delta_y, eps_prim_inf, unscaled: bool):
    """(ref _osqp.py:796-820)"""
    if data.A.shape[-2] == 0:
        return torch.zeros(delta_y.shape[:-1], dtype=torch.bool, device=delta_y.device)
    norm_dy = _inf_norm(scal.E * delta_y) if unscaled else _inf_norm(delta_y)
    lhs = (_dot(data.u, torch.clamp(delta_y, min=0))
           + _dot(data.l, torch.clamp(delta_y, max=0)))
    At_dy = _mtv(data.A, delta_y)
    At_dy_n = _inf_norm(scal.Dinv * At_dy) if unscaled else _inf_norm(At_dy)
    return ((norm_dy > eps_prim_inf) & (lhs < -eps_prim_inf * norm_dy)
            & (At_dy_n < eps_prim_inf * norm_dy))


def dual_infeasibility(data: QPData, scal: Scaling, delta_x, eps_dual_inf, unscaled: bool):
    """(ref _osqp.py:822-878)"""
    m = data.A.shape[-2]
    f = np_dtype(delta_x.dtype)
    norm_dx = _inf_norm(scal.D * delta_x) if unscaled else _inf_norm(delta_x)
    cost_scale = scal.c if unscaled else f(1)
    ok = norm_dx > eps_dual_inf
    ok &= _dot(data.q, delta_x) < -cost_scale * eps_dual_inf * norm_dx
    P_dx = _mv(data.P, delta_x)
    P_dx_n = _inf_norm(scal.Dinv * P_dx) if unscaled else _inf_norm(P_dx)
    ok &= P_dx_n < cost_scale * eps_dual_inf * norm_dx
    if m:
        A_dx = _mv(data.A, delta_x)
        if unscaled:
            A_dx = scal.Einv * A_dx
        loose = f(OSQP_INFTY * MIN_SCALING)
        bound = _col(eps_dual_inf * norm_dx)
        bad = ((data.u < loose) & (A_dx > bound)) | ((data.l > -loose) & (A_dx < -bound))
        ok &= ~torch.any(bad, dim=-1)
    return ok


def termination_status(data: QPData, scal: Scaling, x, z, y, delta_x, delta_y,
                       settings: CoreSettings, approximate: bool):
    """The full termination decision of each instance at the given iterates,
    as (B,) tensors ``(status, pri_res, dua_res, obj_val, dual_obj_val,
    rel_kkt)``; status is UNSOLVED where not terminal."""
    f = np_dtype(x.dtype)
    factor = f(10.0 if approximate else 1.0)
    eps_abs = settings.eps_abs * factor
    eps_rel = settings.eps_rel * factor
    eps_pinf = settings.eps_prim_inf * factor
    eps_dinf = settings.eps_dual_inf * factor
    unscaled = not settings.scaled_termination
    m = data.A.shape[-2]

    pri_res, dua_res, obj_val, dual_obj, eps_pri, eps_dua, gap_noise = compute_info(
        data, scal, x, z, y, settings, eps_abs, eps_rel)

    noncvx = (pri_res > OSQP_INFTY) | (dua_res > OSQP_INFTY)
    pri_check = pri_res < eps_pri if m else torch.ones_like(noncvx)
    dua_check = dua_res < eps_dua
    gap = obj_val - dual_obj
    eps_gap = (eps_abs + eps_rel * torch.maximum(obj_val.abs(), dual_obj.abs())
               + 10.0 * gap_noise)
    if settings.check_dualgap:
        gap_ok = torch.isfinite(gap) & (gap.abs() < eps_gap)
    else:
        gap_ok = torch.ones_like(noncvx)
    pinf = ~pri_check & primal_infeasibility(data, scal, delta_y, eps_pinf, unscaled)
    dinf = ~dua_check & dual_infeasibility(data, scal, delta_x, eps_dinf, unscaled)

    solved_code = _SOLVED_INACC if approximate else _SOLVED
    pinf_code = _PRIM_INF_INACC if approximate else _PRIM_INF
    dinf_code = _DUAL_INF_INACC if approximate else _DUAL_INF
    un = torch.full(noncvx.shape, _UNSOLVED, dtype=torch.int32, device=x.device)
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
    one = torch.ones_like(pri_res)
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
    """The loop's per-instance state, every field a tensor with a leading
    batch axis (the fields of ``core.LoopState`` under vmap)."""

    it: torch.Tensor  # (B,) int32, iterations completed
    status: torch.Tensor  # (B,) int32
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    xtld: torch.Tensor  # last x_tilde (CG warm start)
    delta_x: torch.Tensor
    delta_y: torch.Tensor
    rho: RhoState
    factor: Factor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    obj_val: torch.Tensor
    dual_obj_val: torch.Tensor
    rho_estimate: torch.Tensor
    rho_updates: torch.Tensor  # (B,) int32
    cg_tol: torch.Tensor  # adaptive CG relative tolerance
    cg_iters: torch.Tensor  # (B,) int32
    rel_kkt: torch.Tensor
    primdual_acc: torch.Tensor

    def copy(self):
        return LoopState(**{f.name: getattr(self, f.name) for f in fields(self)})

    def select(self, mask, old: 'LoopState') -> 'LoopState':
        """This state where ``mask``, ``old`` elsewhere."""
        out = {}
        for fl in fields(self):
            new, prev = getattr(self, fl.name), getattr(old, fl.name)
            out[fl.name] = (_select(mask, new, prev) if isinstance(new, tuple)
                            else _where(mask, new, prev))
        return LoopState(**out)


def admm_iteration(data: QPData, settings: CoreSettings, st: LoopState, indirect: bool,
                   kkt_method: str, live, counter):
    """One ADMM step of every instance (ref _osqp.py:644-703).  It
    reassigns ``st``'s fields to new tensors and writes into none in place."""
    m = data.A.shape[-2]
    x_prev, z_prev, y = st.x, st.z, st.y
    rho_vec, rho_inv = st.rho.rho_vec, st.rho.rho_inv_vec

    # KKT rhs, reduced to the normal-equations rhs:
    #   b1 = sigma x - q ; b2 = z - y/rho ;  rhs = b1 + A' diag(rho) b2
    b1 = settings.sigma * x_prev - data.q
    if m:
        b2 = z_prev - rho_inv * y
        rhs = b1 + _mtv(data.A, rho_vec * b2)
    else:
        rhs = b1

    if indirect:
        x_tilde, k = pcg_solve(data.P, data.A, settings.sigma, rho_vec, st.factor.diag, rhs,
                               st.xtld, st.cg_tol, settings.cg_max_iter, live, counter)
        st.cg_iters = st.cg_iters + k
    elif kkt_method == 'inv':
        # matvec solve + one iterative-refinement step (factor.L holds M)
        x_tilde = _mv(st.factor.Minv, rhs)
        resid = rhs - _mv(st.factor.L, x_tilde)
        x_tilde = x_tilde + _mv(st.factor.Minv, resid)
    else:
        x_tilde = _cho_solve(st.factor.L, rhs)

    alpha = settings.alpha
    one_m_alpha = type(alpha)(1) - alpha
    x = alpha * x_tilde + one_m_alpha * x_prev
    if m:
        nu = rho_vec * (_mv(data.A, x_tilde) - b2)
        z_tilde = z_prev + rho_inv * (nu - y)
        z_relax = alpha * z_tilde + one_m_alpha * z_prev
        z = torch.clamp(z_relax + rho_inv * y, data.l, data.u)
        delta_y = rho_vec * (z_relax - z)
        y = y + delta_y
    else:
        z = z_prev
        delta_y = st.delta_y
    st.x, st.z, st.y, st.xtld = x, z, y, x_tilde
    st.delta_x = x - x_prev
    st.delta_y = delta_y


def rho_estimate_fn(data: QPData, x, z, y, rho):
    """Each instance's new rho from its relative residuals (ref
    _osqp.py:880-930), a (B,) tensor clipped to [RHO_MIN, RHO_MAX]."""
    m = data.A.shape[-2]
    Px = _mv(data.P, x)
    Aty = _mtv(data.A, y) if m else torch.zeros_like(x)
    if m:
        Ax = _mv(data.A, x)
        pri = _inf_norm(Ax - z)
        pri = pri / (torch.maximum(_inf_norm(Ax), _inf_norm(z)) + 1e-10)
    else:
        pri = x.new_zeros(x.shape[:-1])
    dua = _inf_norm(Px + data.q + Aty)
    dua = dua / (torch.maximum(torch.maximum(_inf_norm(Aty), _inf_norm(Px)),
                               _inf_norm(data.q)) + 1e-10)
    new_rho = rho * torch.sqrt(pri / (dua + 1e-10))
    return torch.clamp(new_rho, RHO_MIN, RHO_MAX)


def adapt_rho(data: QPData, settings: CoreSettings, st: LoopState, indirect: bool,
              kkt_method: str):
    """Adaptive rho on an adaptation epoch: every instance's estimate; the
    instances still unsolved whose trigger fires take the new rho vector and
    a new factor (direct) or preconditioner diagonal (indirect).  All are
    rebuilt and selected, as the vmapped ``lax.cond`` does."""
    unsolved = st.status == _UNSOLVED
    rho_new = rho_estimate_fn(data, st.x, st.z, st.y, st.rho.rho)
    tol = settings.adaptive_rho_tolerance
    trigger = unsolved & ((rho_new > tol * st.rho.rho) | (rho_new < st.rho.rho / tol))
    vec = rho_vec_from_types(st.rho.constr_type, rho_new, settings.rho_is_vec)
    inv = torch.where(vec > 0, 1.0 / vec, 0.0)
    rho = RhoState(rho=torch.clamp(rho_new, RHO_MIN, RHO_MAX), rho_vec=vec, rho_inv_vec=inv,
                   constr_type=st.rho.constr_type)
    if indirect:
        factor = st.factor._replace(diag=build_M_diag(data.P, data.A, settings.sigma, vec))
    else:
        factor = factorize(data.P, data.A, settings.sigma, vec, kkt_method)
    st.rho = _select(trigger, rho, st.rho)
    st.factor = _select(trigger, factor, st.factor)
    st.rho_updates = st.rho_updates + trigger.to(torch.int32)
    st.rho_estimate = torch.where(unsolved, rho_new, st.rho_estimate)


def _run_check(data, scal, settings, st: LoopState):
    (st.status, st.pri_res, st.dua_res, st.obj_val, st.dual_obj_val,
     st.rel_kkt) = termination_status(data, scal, st.x, st.z, st.y, st.delta_x, st.delta_y,
                                      settings, False)


def finish_unsolved(data, scal, settings, st: LoopState):
    """Post-loop bookkeeping (ref _osqp.py:1248-1275) for the instances that
    reached ``max_iter`` unsolved: re-check exactly, then approximately (10x
    eps), else MAX_ITER_REACHED.  Computed for all, taken where needed."""
    need = (st.status == _UNSOLVED) & (st.it >= settings.max_iter)
    old = st.copy()
    _run_check(data, scal, settings, st)
    status, _, _, obj, _, _ = termination_status(data, scal, st.x, st.z, st.y, st.delta_x,
                                                 st.delta_y, settings, True)
    approx = st.status == _UNSOLVED
    status = torch.where(status == _UNSOLVED, _MAX_ITER, status).to(torch.int32)
    # keep the accurate residuals for reporting
    keep_obj = torch.isin(status, torch.tensor([_PRIM_INF_INACC, _DUAL_INF_INACC, _NON_CVX],
                                               device=status.device))
    st.obj_val = torch.where(approx & keep_obj, obj, st.obj_val)
    st.status = torch.where(approx, status, st.status)
    return st.select(need, old)


def solve_scaled_impl(data: QPData, scal: Scaling, settings: CoreSettings, rho: RhoState,
                      factor: Factor, iterates: Iterates, indirect: bool = False,
                      kkt_method: str = 'chol') -> SolveResult:
    """Run every instance's ADMM loop on already-scaled data: epochs of
    ``check_termination`` iterations, each followed by the termination check,
    the CG-tolerance update (indirect mode) and, every adaptation interval,
    adaptive rho; then the post-loop 10x check and unscaling
    (``osqp_tpu/solver/core.py::solve_scaled_impl`` under ``jax.vmap``)."""
    B, n = iterates.x.shape
    m = iterates.z.shape[-1]
    x0 = iterates.x
    dtype = x0.dtype
    f = np_dtype(dtype)
    counter = _Counter()

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=x0.device)

    st = LoopState(
        it=full(0, torch.int32), status=full(_UNSOLVED, torch.int32),
        x=iterates.x, z=iterates.z, y=iterates.y, xtld=iterates.x,
        delta_x=x0.new_zeros((B, n)), delta_y=x0.new_zeros((B, m)),
        rho=rho, factor=factor,
        pri_res=full(float('inf')), dua_res=full(float('inf')), obj_val=full(float('nan')),
        dual_obj_val=full(float('nan')), rho_estimate=rho.rho,
        rho_updates=full(0, torch.int32), cg_tol=full(1e-3), cg_iters=full(0, torch.int32),
        rel_kkt=full(1.0), primdual_acc=full(0.0),
    )

    # Epoch structure as in the JAX package: ``check_termination`` pure ADMM
    # iterations, then the check, the CG tolerance and adaptive rho.  The
    # live instances share one iteration count, kept on the host.
    ct = settings.check_termination
    iter_cap = settings.iter_cap
    epoch_len = ct if ct > 0 else iter_cap
    interval = settings.adaptive_rho_interval
    epochs_per_adapt = max((interval + epoch_len - 1) // max(epoch_len, 1), 1)

    it = 0
    active = full(True, torch.bool)
    n_active = B if iter_cap > 0 else 0
    while n_active:
        this_epoch = min(epoch_len, iter_cap - it)
        new = st.copy()
        for _ in range(this_epoch):
            admm_iteration(data, settings, new, indirect, kkt_method, active, counter)
        it += this_epoch
        new.it = full(it, torch.int32)

        pri_before, dua_before = new.pri_res, new.dua_res
        do_check = ct > 0 and it % max(ct, 1) == 0
        if do_check:
            _run_check(data, scal, settings, new)
        # primal-dual integral: iteration integral of the capped relative
        # KKT error (last-known value)
        new.primdual_acc = new.primdual_acc + f(this_epoch) * torch.clamp(new.rel_kkt, max=1.0)

        # Adaptive CG tolerance (indirect mode), at check epochs: monotone
        # tightening toward the ADMM residual scale, with a forced
        # 1/cg_tol_reduction cut whenever both residuals stall.
        if do_check and indirect:
            candidate = settings.cg_tol_fraction * torch.sqrt(new.pri_res * new.dua_res)
            cg_tol = torch.clamp(torch.minimum(new.cg_tol, candidate), settings.cg_eps_min, 0.15)
            stalled = (new.pri_res > 0.5 * pri_before) & (new.dua_res > 0.5 * dua_before)
            reduction = max(settings.cg_tol_reduction, f(1))
            new.cg_tol = torch.where(
                stalled, torch.clamp(cg_tol / reduction, min=settings.cg_eps_min), cg_tol)

        epoch_idx = (it + epoch_len - 1) // max(epoch_len, 1)
        if settings.adaptive_rho and interval > 0 and epoch_idx % epochs_per_adapt == 0:
            adapt_rho(data, settings, new, indirect, kkt_method)

        st = new.select(active, st)
        if it >= iter_cap:
            break
        active = (st.it < iter_cap) & (st.status == _UNSOLVED)
        n_active = int(counter.host(active.sum())[0])

    if it >= settings.max_iter:
        st = finish_unsolved(data, scal, settings, st)

    rho_est = rho_estimate_fn(data, st.x, st.z, st.y, st.rho.rho)

    # Unscale the solution (ref _osqp.py:1098-1115)
    infeasible = torch.isin(st.status, torch.tensor(
        [_PRIM_INF, _PRIM_INF_INACC, _DUAL_INF, _DUAL_INF_INACC], device=x0.device))
    x_out = torch.where(_col(infeasible), torch.nan, scal.D * st.x)
    y_out = torch.where(_col(infeasible), torch.nan, _col(scal.cinv) * (scal.E * st.y)) \
        if m else st.y
    unscaled = not settings.scaled_termination
    prim_cert = scal.E * st.delta_y if (unscaled and m) else st.delta_y
    dual_cert = scal.D * st.delta_x if unscaled else st.delta_x

    return SolveResult(
        x=x_out, y=y_out, prim_inf_cert=prim_cert, dual_inf_cert=dual_cert,
        status=st.status, iters=st.it, pri_res=st.pri_res, dua_res=st.dua_res,
        obj_val=st.obj_val, dual_obj_val=st.dual_obj_val,
        duality_gap=st.obj_val - st.dual_obj_val, rho_estimate=rho_est,
        rho_updates=st.rho_updates, cg_iters=st.cg_iters, host_syncs=counter.syncs,
        rel_kkt_error=st.rel_kkt, primdual_acc=st.primdual_acc,
        iterates=Iterates(x=st.x, z=st.z, y=st.y), rho=st.rho, factor=st.factor,
    )
