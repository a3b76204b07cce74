"""A batch of QPs over a (dp x mp) mesh.

Counterpart of ``osqp_tpu/parallel/sharded.py``:

* **dp axis**: independent QP instances, in blocks, one block a dp shard;
* **mp axis**: each instance's constraint rows, in blocks, one block an mp
  shard (row-consensus ADMM).  A shard holds its row block of A and the
  matching slices of l, u, z, y and rho; x, P and q are replicated over mp.
  Per ADMM iteration the normal-equations right-hand side needs one ``psum``
  (of ``A_loc' rho b2_loc``); the Schur operator ``P + sigma I + sum_s
  A_s' rho_s A_s`` is assembled with one ``psum`` at each (re)factorization;
  residual norms reduce with ``pmax``.

The math is the whole single-device algorithm (in-loop Ruiz with column
norms ``pmax``-reduced over the row shards, vector and adaptive rho with the
distributed refactorization, termination with the duality gap, both
certificates, the 10x approximate retry, polish, warm start), so iteration
counts match the float64 oracle.

The JAX package runs ``_row_consensus_solve`` per instance under ``vmap``
inside a ``shard_map``.  Here every shard holds its block of instances as a
leading batch axis, and the ``vmap``'s semantics are explicit, as in
``solver/core_batched``: the batched ``while_loop`` keeps the state of an
instance whose predicate was false (a finished instance is frozen), and a
batched ``cond`` computes both branches and selects.  All live instances
share one iteration count, so the loop is a host loop over epochs that reads
one value per epoch (are any instances still running, over every dp block)
in one host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import ADAPTIVE_RHO_FIXED, MIN_SCALING, OSQP_INFTY, RHO_MAX, RHO_MIN
from ..settings import np_dtype
from ..solver.core_batched import (
    RhoState,
    _DUAL_INF,
    _DUAL_INF_INACC,
    _MAX_ITER,
    _NON_CVX,
    _PRIM_INF,
    _PRIM_INF_INACC,
    _SOLVED,
    _SOLVED_INACC,
    _UNSOLVED,
    _cho_solve,
    _where as _where_b,
    _col,
    _dot,
    _inf_norm,
    _limit_scaling,
    _mtv,
    _mv,
    cholesky,
    make_rho_state,
    rho_vec_from_types,
)
from .mesh import Parts, each


class ShardedResult(NamedTuple):
    """Batch-leading global tensors (unscaled problem space) on the mesh's
    first device, then the loop's host syncs."""

    x: torch.Tensor  # (B, n) primal (NaN rows when infeasible)
    y: torch.Tensor  # (B, m) dual (NaN rows when infeasible)
    z: torch.Tensor  # (B, m) primal slack iterate
    status: torch.Tensor  # (B,) int32 SolverStatus values
    iters: torch.Tensor  # (B,)
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)
    obj_val: torch.Tensor  # (B,)
    dual_obj_val: torch.Tensor  # (B,)
    rho: torch.Tensor  # (B,) final rho setting value
    rho_updates: torch.Tensor  # (B,)
    prim_inf_cert: torch.Tensor  # (B, m) unscaled delta_y certificate
    dual_inf_cert: torch.Tensor  # (B, n) unscaled delta_x certificate
    status_polish: torch.Tensor  # (B,) 1 accepted / -1 rejected / 0 not attempted
    host_syncs: int = 0


class ShardedSettings(NamedTuple):
    """The solve's settings: floats as host scalars of the working dtype,
    integers and flags as host values."""

    sigma: np.floating
    alpha: np.floating
    eps_abs: np.floating
    eps_rel: np.floating
    eps_prim_inf: np.floating
    eps_dual_inf: np.floating
    max_iter: int
    check_termination: int  # 0 = only at max_iter
    scaled_termination: bool
    check_dualgap: bool
    adaptive_rho: bool
    adaptive_rho_interval: int  # effective, host-resolved
    adaptive_rho_tolerance: np.floating
    rho_is_vec: bool
    rho: np.floating  # initial rho
    n_scaling: int  # Ruiz iterations (0 = off)
    delta: np.floating  # polish regularization
    polish_refine_iter: int


class _Scal(NamedTuple):
    """Row-sharded scaling state: D/Dinv replicated, E/Einv local slices,
    c/cinv (B,) per instance."""

    D: Parts
    Dinv: Parts
    E: Parts
    Einv: Parts
    c: Parts
    cinv: Parts


class _Ctx(NamedTuple):
    """The scaled problem on the shards and the mesh's mp axis."""

    mesh: object
    axis: str
    P: Parts  # (Bl, n, n) replicated over mp
    q: Parts  # (Bl, n)
    A: Parts  # (Bl, m_loc, n)
    l: Parts  # (Bl, m_loc)
    u: Parts
    scal: _Scal

    def psum(self, v):
        return self.mesh.psum(v, self.axis)

    def pmax(self, v):
        return self.mesh.pmax(v, self.axis)

    def pmax_inf(self, v):
        return self.pmax(v.map(_inf_norm))


def _where(mask, a, b):
    """Per instance: ``a`` where ``mask`` (Bl,), else ``b`` (Parts)."""
    return each(_where_b, mask, a, b)


# ---------------------------------------------------------------------------
# Ruiz equilibration, distributed (mirror of core.ruiz_scale / ref
# _osqp.py:389-497): column norms of the row-sharded A pmax-reduce over the
# mp axis; row norms and E stay local.
# ---------------------------------------------------------------------------


def _ruiz_scale_sh(mesh, axis, P_mat, q, A_loc, l_loc, u_loc, n_iters):
    D = q.map(torch.ones_like)
    E = l_loc.map(torch.ones_like)
    c = q.map(lambda t: torch.ones(t.shape[0], dtype=t.dtype, device=t.device))
    for _ in range(n_iters):
        norm_P_col = P_mat.map(lambda t: t.abs().amax(dim=-2))
        norm_A_col = mesh.pmax(A_loc.map(lambda t: t.abs().amax(dim=-2)), axis)
        norm_A_row = A_loc.map(lambda t: t.abs().amax(dim=-1))
        d = each(lambda a, b: 1.0 / torch.sqrt(_limit_scaling(torch.maximum(a, b))),
                 norm_P_col, norm_A_col)
        e = norm_A_row.map(lambda t: 1.0 / torch.sqrt(_limit_scaling(t)))

        P_mat = each(lambda dd, t: dd.unsqueeze(-1) * t * dd.unsqueeze(-2), d, P_mat)
        A_loc = each(lambda ee, t, dd: ee.unsqueeze(-1) * t * dd.unsqueeze(-2), e, A_loc, d)
        q, l_loc, u_loc = d * q, e * l_loc, e * u_loc
        D, E = D * d, E * e

        # cost normalization (ref _osqp.py:443-468); P is replicated, so its
        # column mean needs no collective
        mean = P_mat.map(lambda t: t.abs().amax(dim=-2).mean(dim=-1))
        scale_cost = each(lambda qq, mn: 1.0 / _limit_scaling(
            torch.maximum(_limit_scaling(_inf_norm(qq)), mn)), q, mean)
        P_mat = each(lambda s, t: s[:, None, None] * t, scale_cost, P_mat)
        q = scale_cost.map(_col) * q
        c = scale_cost * c
    scal = _Scal(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E, c=c, cinv=1.0 / c)
    return P_mat, q, A_loc, l_loc, u_loc, scal


# ---------------------------------------------------------------------------
# KKT operator (mirror of core.build_M / factorize): one psum of the local
# Gram block at (re)factorization time
# ---------------------------------------------------------------------------


def _factorize_sh(cx: _Ctx, sigma, rho_loc):
    gram = cx.psum(each(lambda a, r: a.mT @ (r.unsqueeze(-1) * a), cx.A, rho_loc))
    return each(lambda p, g: cholesky(
        p + sigma * torch.eye(p.shape[-1], dtype=p.dtype, device=p.device) + g), cx.P, gram)


# ---------------------------------------------------------------------------
# Residuals / termination (mirror of core.compute_info /
# core.termination_status; ref _osqp.py:705-878, 998-1077)
# ---------------------------------------------------------------------------


def _compute_info_sh(cx: _Ctx, x, z, y, eps_abs, eps_rel, scaled_termination):
    s = cx.scal
    dtype = x[0].dtype
    feps = torch.finfo(dtype).eps
    unscaled = not scaled_termination
    Px = each(_mv, cx.P, x)
    Ax = each(_mv, cx.A, x)
    Aty = cx.psum(each(_mtv, cx.A, y))
    col = lambda v: v.map(_col)  # noqa: E731
    inf = lambda v: v.map(_inf_norm)  # noqa: E731

    # primal residual (ref _osqp.py:714-726)
    pri_vec = Ax - z
    pri_res = cx.pmax_inf(s.Einv * pri_vec) if unscaled else cx.pmax_inf(pri_vec)
    # dual residual (ref _osqp.py:753-764); Aty is replicated after the psum
    dua_vec = Px + cx.q + Aty
    dua_res = s.cinv * inf(s.Dinv * dua_vec) if unscaled else inf(dua_vec)
    # objective (ref _osqp.py:705-712)
    quad = 0.5 * each(_dot, x, Px)
    obj_val = (quad + each(_dot, cx.q, x)) * s.cinv

    # unscaled dual objective: the sup terms are per row, local sums psum'd
    y_u = col(s.cinv) * (s.E * y)
    y_tol = feps * cx.pmax_inf(y_u)
    y_u = each(lambda v, tl: torch.where(v.abs() > tl[:, None], v, 0.0), y_u, y_tol)
    l_u, u_u = s.Einv * cx.l, s.Einv * cx.u
    sup_pos = each(lambda uu, v: torch.where(uu < OSQP_INFTY * MIN_SCALING,
                                             uu * torch.clamp(v, min=0), 0.0), u_u, y_u)
    sup_neg = each(lambda ll, v: torch.where(ll > -OSQP_INFTY * MIN_SCALING,
                                             ll * torch.clamp(v, max=0), 0.0), l_u, y_u)
    sup = cx.psum(each(lambda a, b: a.sum(-1) + b.sum(-1), sup_pos, sup_neg))
    sup_mag = cx.psum(each(lambda a, b: a.abs().sum(-1) + b.abs().sum(-1), sup_pos, sup_neg))
    dual_obj_val = -quad * s.cinv - sup
    gap_noise = feps * (sup_mag + (quad * s.cinv).map(torch.abs)
                        + each(_dot, cx.q, x).map(torch.abs) * s.cinv)

    # negative curvature -> non-convex flag through an exploding residual
    noncvx = quad * s.cinv < -1e-12 * each(lambda v: torch.clamp(_dot(v, v), min=1.0), x)
    pri_res = each(lambda nc, pr: torch.where(nc, 2 * OSQP_INFTY, pr), noncvx, pri_res)

    # tolerances (ref _osqp.py:728-751, 766-794)
    Ax_t = cx.pmax_inf(s.Einv * Ax) if unscaled else cx.pmax_inf(Ax)
    z_t = cx.pmax_inf(s.Einv * z) if unscaled else cx.pmax_inf(z)
    eps_pri = eps_abs + eps_rel * each(torch.maximum, Ax_t, z_t)

    def _d(v):
        return inf(s.Dinv * v) if unscaled else inf(v)

    max_rel = each(torch.maximum, each(torch.maximum, _d(Aty), _d(Px)), _d(cx.q))
    max_rel_dua = s.cinv * max_rel if unscaled else max_rel
    eps_dua = eps_abs + eps_rel * max_rel_dua
    return pri_res, dua_res, obj_val, dual_obj_val, eps_pri, eps_dua, gap_noise


def _primal_infeasible_sh(cx: _Ctx, dy, eps_pinf, unscaled):
    """(mirror of core.primal_infeasibility; ref _osqp.py:796-820)"""
    s = cx.scal
    norm_dy = cx.pmax_inf(s.E * dy) if unscaled else cx.pmax_inf(dy)
    lhs = cx.psum(each(lambda uu, ll, d: _dot(uu, torch.clamp(d, min=0))
                       + _dot(ll, torch.clamp(d, max=0)), cx.u, cx.l, dy))
    At_dy = cx.psum(each(_mtv, cx.A, dy))
    At_dy_n = (s.Dinv * At_dy).map(_inf_norm) if unscaled else At_dy.map(_inf_norm)
    return (norm_dy > eps_pinf) & (lhs < -eps_pinf * norm_dy) & (At_dy_n < eps_pinf * norm_dy)


def _dual_infeasible_sh(cx: _Ctx, dx, eps_dinf, unscaled):
    """(mirror of core.dual_infeasibility; ref _osqp.py:822-878)"""
    s = cx.scal
    norm_dx = (s.D * dx).map(_inf_norm) if unscaled else dx.map(_inf_norm)
    cost_scale = s.c if unscaled else 1.0
    ok = norm_dx > eps_dinf
    ok = ok & (each(_dot, cx.q, dx) < -cost_scale * eps_dinf * norm_dx)
    P_dx = each(_mv, cx.P, dx)
    P_dx_n = (s.Dinv * P_dx).map(_inf_norm) if unscaled else P_dx.map(_inf_norm)
    ok = ok & (P_dx_n < cost_scale * eps_dinf * norm_dx)
    A_dx = each(_mv, cx.A, dx)
    if unscaled:
        A_dx = s.Einv * A_dx
    bad = each(lambda ad, uu, ll, nd: (
        ((uu < OSQP_INFTY * MIN_SCALING) & (ad > eps_dinf * nd[:, None]))
        | ((ll > -OSQP_INFTY * MIN_SCALING) & (ad < -eps_dinf * nd[:, None]))).any(-1).to(
            torch.int32), A_dx, cx.u, cx.l, norm_dx)
    return ok & ~(cx.pmax(bad) > 0)


def _termination_status_sh(cx: _Ctx, st, stg: ShardedSettings, approximate):
    """(mirror of core.termination_status)"""
    factor = 10.0 if approximate else 1.0
    eps_abs, eps_rel = stg.eps_abs * factor, stg.eps_rel * factor
    eps_pinf, eps_dinf = stg.eps_prim_inf * factor, stg.eps_dual_inf * factor
    unscaled = not stg.scaled_termination

    pri_res, dua_res, obj_val, dual_obj, eps_pri, eps_dua, gap_noise = _compute_info_sh(
        cx, st.x, st.z, st.y, eps_abs, eps_rel, stg.scaled_termination)

    noncvx = (pri_res > OSQP_INFTY) | (dua_res > OSQP_INFTY)
    pri_check = pri_res < eps_pri
    dua_check = dua_res < eps_dua
    gap = obj_val - dual_obj
    eps_gap = eps_abs + eps_rel * each(lambda a, b: torch.maximum(a.abs(), b.abs()), obj_val,
                                       dual_obj) + 10.0 * gap_noise
    if stg.check_dualgap:
        gap_ok = each(lambda g, eg: torch.isfinite(g) & (g.abs() < eg), gap, eps_gap)
    else:
        gap_ok = gap.map(lambda g: torch.ones_like(g, dtype=torch.bool))
    pinf = ~pri_check & _primal_infeasible_sh(cx, st.delta_y, eps_pinf, unscaled)
    dinf = ~dua_check & _dual_infeasible_sh(cx, st.delta_x, eps_dinf, unscaled)

    solved_code = _SOLVED_INACC if approximate else _SOLVED
    pinf_code = _PRIM_INF_INACC if approximate else _PRIM_INF
    dinf_code = _DUAL_INF_INACC if approximate else _DUAL_INF
    status = each(lambda nc, ok, pi, di: torch.where(nc, _NON_CVX, torch.where(
        ok, solved_code, torch.where(pi, pinf_code, torch.where(di, dinf_code, _UNSOLVED)))).to(
            torch.int32), noncvx, pri_check & dua_check & gap_ok, pinf, dinf)
    obj_val = each(lambda stt, ob: torch.where(stt == _NON_CVX, torch.nan, torch.where(
        stt == pinf_code, OSQP_INFTY, torch.where(stt == dinf_code, -OSQP_INFTY, ob))),
        status, obj_val)
    return status, pri_res, dua_res, obj_val, dual_obj


# ---------------------------------------------------------------------------
# ADMM step + adaptive rho (mirrors of core.admm_iteration / core.adapt_rho)
# ---------------------------------------------------------------------------


class _LoopState(NamedTuple):
    it: Parts
    status: Parts
    x: Parts
    z: Parts
    y: Parts
    delta_x: Parts
    delta_y: Parts
    rho: RhoState  # of Parts
    L: Parts  # Cholesky factor of the psum'd Schur operator, replicated over mp
    pri_res: Parts
    dua_res: Parts
    obj_val: Parts
    dual_obj_val: Parts
    rho_updates: Parts

    def select(self, mask, old):
        """This state where ``mask`` (per instance), ``old`` elsewhere."""
        out = [RhoState(*(_where(mask, a, b) for a, b in zip(new, prev)))
               if isinstance(new, RhoState) else _where(mask, new, prev)
               for new, prev in zip(self, old)]
        return _LoopState(*out)


def _admm_step_sh(cx: _Ctx, stg: ShardedSettings, st: _LoopState):
    """(mirror of core.admm_iteration; ref _osqp.py:644-703)"""
    x_prev, z_prev, y = st.x, st.z, st.y
    rho_vec, rho_inv = st.rho.rho_vec, st.rho.rho_inv_vec
    b1 = stg.sigma * x_prev - cx.q
    b2 = z_prev - rho_inv * y
    rhs = b1 + cx.psum(each(_mtv, cx.A, rho_vec * b2))
    x_tilde = each(_cho_solve, st.L, rhs)
    nu = rho_vec * (each(_mv, cx.A, x_tilde) - b2)
    z_tilde = z_prev + rho_inv * (nu - y)
    alpha = stg.alpha
    x = alpha * x_tilde + (1.0 - alpha) * x_prev
    z_relax = alpha * z_tilde + (1.0 - alpha) * z_prev
    z = each(torch.clamp, z_relax + rho_inv * y, cx.l, cx.u)
    delta_y = rho_vec * (z_relax - z)
    return st._replace(x=x, z=z, y=y + delta_y, delta_x=x - x_prev, delta_y=delta_y)


def _rho_estimate_sh(cx: _Ctx, x, z, y, rho):
    """(mirror of core.rho_estimate_fn; ref _osqp.py:880-908)"""
    Ax = each(_mv, cx.A, x)
    Px = each(_mv, cx.P, x)
    Aty = cx.psum(each(_mtv, cx.A, y))
    inf = lambda v: v.map(_inf_norm)  # noqa: E731
    pri = cx.pmax_inf(Ax - z)
    pri = pri / (each(torch.maximum, cx.pmax_inf(Ax), cx.pmax_inf(z)) + 1e-10)
    dua = inf(Px + cx.q + Aty)
    dua = dua / (each(torch.maximum, each(torch.maximum, inf(Aty), inf(Px)), inf(cx.q)) + 1e-10)
    return each(lambda r, p, d: torch.clamp(r * torch.sqrt(p / (d + 1e-10)), RHO_MIN, RHO_MAX),
                rho, pri, dua)


def _adapt_rho_sh(cx: _Ctx, stg: ShardedSettings, st: _LoopState):
    """(mirror of core.adapt_rho): every instance refactorizes; those whose
    trigger fired and that are still unsolved take the new rho and factor."""
    rho_new = _rho_estimate_sh(cx, st.x, st.z, st.y, st.rho.rho)
    tol = stg.adaptive_rho_tolerance
    trigger = (rho_new > tol * st.rho.rho) | (rho_new < st.rho.rho / tol)
    vec = each(lambda ty, r: rho_vec_from_types(ty, r, stg.rho_is_vec),
               st.rho.constr_type, rho_new)
    rho = RhoState(rho=rho_new.map(lambda r: torch.clamp(r, RHO_MIN, RHO_MAX)), rho_vec=vec,
                   rho_inv_vec=vec.map(lambda v: torch.where(v > 0, 1.0 / v, 0.0)),
                   constr_type=st.rho.constr_type)
    new = st._replace(rho=rho, L=_factorize_sh(cx, stg.sigma, vec),
                      rho_updates=st.rho_updates + 1)
    return new.select(trigger & (st.status == _UNSOLVED), st)


# ---------------------------------------------------------------------------
# Polish (mirror of core.polish; ref _osqp.py:1693-1828).  The masked
# reduced-KKT Schur operator assembles with one psum; the rest is local.
# ---------------------------------------------------------------------------


def _polish_sh(cx: _Ctx, stg: ShardedSettings, st: _LoopState):
    """Polish every instance; returns the state with the accepted polishes
    adopted and the (Bl,) polish statuses (1 accepted, -1 rejected)."""
    low = (st.z - cx.l) < -st.y  # ref _osqp.py:1719
    upp = (cx.u - st.z) < st.y  # ref _osqp.py:1720
    active = low | upp
    mask = each(lambda a, z: a.to(z.dtype), active, st.z)
    b2 = each(lambda lo, up, ll, uu: torch.where(lo, ll, torch.where(up, uu, 0.0)),
              low, upp, cx.l, cx.u)
    delta = stg.delta
    Ared = each(lambda mk, a: mk.unsqueeze(-1) * a, mask, cx.A)
    red = cx.psum(Ared.map(lambda a: a.mT @ (a / delta)))
    L = each(lambda p, r: cholesky(
        p + delta * torch.eye(p.shape[-1], dtype=p.dtype, device=p.device) + r), cx.P, red)

    def ared_mv(v):
        return mask * each(_mv, cx.A, v)

    def aredt_mv(w):
        return cx.psum(each(_mtv, cx.A, mask * w))

    def kkt_solve(r1, r2):
        rhs = r1 + aredt_mv(r2 / delta)
        xs = each(_cho_solve, L, rhs)
        return xs, (ared_mv(xs) - r2) / delta

    b1 = -cx.q
    x_pol, y_red = kkt_solve(b1, b2)
    for _ in range(stg.polish_refine_iter):
        r1 = b1 - (each(_mv, cx.P, x_pol) + aredt_mv(y_red))
        r2 = b2 - ared_mv(x_pol)
        dxs, dys = kkt_solve(r1, r2)
        x_pol, y_red = x_pol + dxs, y_red + dys

    z_pol = each(_mv, cx.A, x_pol)
    y_pol = each(lambda a, v: torch.where(a, v, 0.0), active, y_red)
    tmp = z_pol + y_pol  # normal-cone projection (ref _osqp.py:676-680)
    z_pol = each(torch.clamp, tmp, cx.l, cx.u)
    y_pol = tmp - z_pol

    pri_pol, dua_pol, obj_pol, dobj_pol, _, _, _ = _compute_info_sh(
        cx, x_pol, z_pol, y_pol, stg.eps_abs, stg.eps_rel, stg.scaled_termination)

    # acceptance test (ref _osqp.py:1786-1793)
    success = (((pri_pol < st.pri_res) & (dua_pol < st.dua_res))
               | ((pri_pol < st.pri_res) & (st.dua_res < 1e-10))
               | ((dua_pol < st.dua_res) & (st.pri_res < 1e-10)))
    adopted = st._replace(x=x_pol, z=z_pol, y=y_pol, pri_res=pri_pol, dua_res=dua_pol,
                          obj_val=obj_pol, dual_obj_val=dobj_pol)
    code = success.map(lambda s: torch.where(s, 1, -1).to(torch.int32))
    return adopted.select(success, st), code


# ---------------------------------------------------------------------------
# The row-consensus solve of the shards' instances
# ---------------------------------------------------------------------------


def _row_consensus_solve(mesh, P_mat, q, A_loc, l_loc, u_loc, x0, y0, stg: ShardedSettings,
                         axis, polish: bool):
    """Row-sharded ADMM for every shard's block of instances.

    ``A_loc (Bl, m_loc, n)`` is each shard's row block; x is replicated over
    the mp axis (each shard computes the identical x update after the
    psum).  ``x0 (Bl, n)`` / ``y0 (Bl, m_loc)`` warm-start in UNSCALED
    problem space (zeros = cold start).  Returns ``(state, status_polish,
    scaling, host_syncs)`` of Parts.
    """
    P_mat, q, A_loc, l_loc, u_loc, scal = _ruiz_scale_sh(
        mesh, axis, P_mat, q, A_loc, l_loc, u_loc, stg.n_scaling)
    cx = _Ctx(mesh, axis, P_mat, q, A_loc, l_loc, u_loc, scal)

    # constraint typing + vector rho on the local row slice (ref :499-524)
    rho0 = each(lambda ll, uu: make_rho_state(
        ll, uu, torch.full((ll.shape[0],), stg.rho, dtype=ll.dtype, device=ll.device),
        stg.rho_is_vec), l_loc, u_loc)
    rho0 = RhoState(*(Parts(f) for f in zip(*rho0)))
    L0 = _factorize_sh(cx, stg.sigma, rho0.rho_vec)

    # warm start: the unscaled iterates scaled (ref :1493-1545)
    x_init = scal.Dinv * x0
    zeros = lambda v, dt=None: v.map(  # noqa: E731
        lambda t: torch.zeros(t.shape[0], dtype=dt or t.dtype, device=t.device))
    full = lambda v, val: v.map(lambda t: torch.full_like(t, val))  # noqa: E731
    st = _LoopState(
        it=zeros(q, torch.int32), status=zeros(q, torch.int32).map(lambda t: t + _UNSOLVED),
        x=x_init, z=each(_mv, A_loc, x_init), y=scal.c.map(_col) * (scal.Einv * y0),
        delta_x=q.map(torch.zeros_like), delta_y=l_loc.map(torch.zeros_like), rho=rho0, L=L0,
        pri_res=full(zeros(q), torch.inf), dua_res=full(zeros(q), torch.inf),
        obj_val=full(zeros(q), torch.nan), dual_obj_val=full(zeros(q), torch.nan),
        rho_updates=zeros(q, torch.int32))

    # Epoch structure: exactly core.solve_scaled_impl's (checks and rho
    # adaptation only at epoch boundaries)
    ct, max_iter = stg.check_termination, stg.max_iter
    epoch_len = ct if ct > 0 else max_iter
    interval = stg.adaptive_rho_interval
    epochs_per_adapt = max((interval + epoch_len - 1) // max(epoch_len, 1), 1)
    dp_first = [g[0] for g in mesh.groups(axis)]  # one shard of each dp block
    syncs = 0

    def run_check(s, approximate=False):
        status, pri, dua, obj, dobj = _termination_status_sh(cx, s, stg, approximate)
        return s._replace(status=status, pri_res=pri, dua_res=dua, obj_val=obj,
                          dual_obj_val=dobj)

    it = 0
    live = st.status.map(lambda t: (t == _UNSOLVED) & (max_iter > 0))
    running = max_iter > 0
    while running:
        this_epoch = min(epoch_len, max_iter - it)
        new = st
        for _ in range(this_epoch):
            new = _admm_step_sh(cx, stg, new)
        it += this_epoch
        new = new._replace(it=new.it.map(lambda t: torch.full_like(t, it)))
        if ct > 0 and it % max(ct, 1) == 0:
            new = run_check(new)
        epoch_idx = (it + epoch_len - 1) // max(epoch_len, 1)
        if stg.adaptive_rho and interval > 0 and epoch_idx % epochs_per_adapt == 0:
            new = _adapt_rho_sh(cx, stg, new)
        st = new.select(live, st)
        live = (st.it < max_iter) & (st.status == _UNSOLVED)
        d0 = mesh.device_list[0]
        flag = torch.stack([live[i].any().to(d0) for i in dp_first]).any()
        syncs += 1
        running = bool(flag.cpu())

    # post-loop (ref _osqp.py:1248-1275): exact re-check, then 10x
    # approximate, else MAX_ITER_REACHED, for the unsolved at max_iter
    def approx(s):
        status, pri, dua, obj, dobj = _termination_status_sh(cx, s, stg, True)
        status = status.map(lambda t: torch.where(t == _UNSOLVED, _MAX_ITER, t).to(torch.int32))
        keep = status.map(lambda t: torch.isin(t, torch.tensor(
            [_PRIM_INF_INACC, _DUAL_INF_INACC, _NON_CVX], dtype=t.dtype, device=t.device)))
        return s._replace(status=status, obj_val=_where(keep, obj, s.obj_val))

    unsolved = (st.status == _UNSOLVED) & (st.it >= max_iter)
    checked = run_check(st)
    finished = approx(checked).select(checked.status == _UNSOLVED, checked)
    st = finished.select(unsolved, st)

    status_polish = zeros(q, torch.int32)
    if polish:
        solved = st.status == _SOLVED
        polished, code = _polish_sh(cx, stg, st)
        st = polished.select(solved, st)
        status_polish = _where(solved, code, status_polish)
    return st, status_polish, scal, syncs


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def _working_dtype(P_mat):
    dt = P_mat.dtype if isinstance(P_mat, torch.Tensor) else \
        {np.dtype(np.float32): torch.float32}.get(np.asarray(P_mat).dtype, torch.float64)
    return dt if dt in (torch.float32, torch.float64) else torch.float64


@torch.no_grad()
def dp_mp_solve(mesh, P_mat, q, A, l, u, *,
                sigma=1e-6, rho=0.1, alpha=1.6,
                eps_abs=1e-3, eps_rel=1e-3,
                eps_prim_inf=1e-4, eps_dual_inf=1e-4,
                max_iter=4000, check_termination=25, check_every=None,
                scaled_termination=False, check_dualgap=True,
                scaling=10, rho_is_vec=True,
                adaptive_rho=True, adaptive_rho_interval=0,
                adaptive_rho_tolerance=5.0,
                polish=False, delta=1e-6, polish_refine_iter=3,
                x0=None, y0=None,
                dp_axis='dp', mp_axis='mp') -> ShardedResult:
    """Solve a dp-sharded batch of QPs, each with mp-row-sharded constraints.

    Args: ``P_mat (B, n, n)``, ``q (B, n)``, ``A (B, m, n)``, ``l, u (B, m)``
    (numpy arrays, or tensors on the mesh's type of device).  B must divide
    by ``mesh.shape[dp_axis]``, m by ``mesh.shape[mp_axis]``.  Settings carry
    the reference defaults; ``check_every`` is a deprecated alias of
    ``check_termination``.  ``x0 (B, n)`` / ``y0 (B, m)`` warm-start in
    unscaled problem space.  The working dtype is P's (float32 or float64;
    float64 otherwise).  Returns a ``ShardedResult`` with batch-leading
    global tensors on the mesh's first device."""
    if check_every is not None:
        check_termination = check_every
    dtype = _working_dtype(P_mat)
    f = np_dtype(dtype)
    B, n = P_mat.shape[0], P_mat.shape[1]
    m = A.shape[1]
    ndp, nmp = mesh.shape[dp_axis], mesh.shape[mp_axis]
    if mesh.size != ndp * nmp:
        raise ValueError(f'dp_mp_solve runs on a mesh of the axes {dp_axis!r} and {mp_axis!r} '
                         f'only, got {mesh.shape}')
    if B % ndp or m % nmp:
        raise ValueError(f'B={B} must divide by {ndp} and m={m} by {nmp}')
    if m <= 0:
        raise ValueError('dp_mp_solve requires m >= 1 constraint rows')

    ct = int(check_termination)
    # host-side interval resolution, the JAX backend's: 0 = automatic ->
    # the fixed fallback, never below ct
    interval = int(adaptive_rho_interval) or ADAPTIVE_RHO_FIXED
    if ct:
        interval = max(interval, ct)
    stg = ShardedSettings(
        sigma=f(sigma), alpha=f(alpha), eps_abs=f(eps_abs), eps_rel=f(eps_rel),
        eps_prim_inf=f(eps_prim_inf), eps_dual_inf=f(eps_dual_inf), max_iter=int(max_iter),
        check_termination=ct, scaled_termination=bool(scaled_termination),
        check_dualgap=bool(check_dualgap), adaptive_rho=bool(adaptive_rho),
        adaptive_rho_interval=interval, adaptive_rho_tolerance=f(adaptive_rho_tolerance),
        rho_is_vec=bool(rho_is_vec), rho=f(rho), n_scaling=int(scaling), delta=f(delta),
        polish_refine_iter=int(polish_refine_iter))

    def put(v, spec):
        if isinstance(v, torch.Tensor):
            mesh.check(v)
            v = v.to(mesh.device_list[0], dtype)
        else:
            v = torch.as_tensor(np.asarray(v, f), device=mesh.device_list[0])
        return mesh.split(v, spec)

    x0 = np.zeros((B, n), f) if x0 is None else x0
    y0 = np.zeros((B, m), f) if y0 is None else y0
    rep, rows = (dp_axis, None), (dp_axis, mp_axis)
    st, status_polish, scal, syncs = _row_consensus_solve(
        mesh, put(P_mat, rep), put(q, rep), put(A, rows), put(l, rows), put(u, rows),
        put(x0, rep), put(y0, rows), stg, mp_axis, polish)

    # unscale (ref _osqp.py:1098-1115)
    infeasible = st.status.map(lambda t: torch.isin(t, torch.tensor(
        [_PRIM_INF, _PRIM_INF_INACC, _DUAL_INF, _DUAL_INF_INACC], dtype=t.dtype, device=t.device)))
    nan_where = lambda v: _where(infeasible, v.map(  # noqa: E731
        lambda t: torch.full_like(t, torch.nan)), v)
    unscaled = not stg.scaled_termination
    out = dict(
        x=(nan_where(scal.D * st.x), rep),
        y=(nan_where(scal.cinv.map(_col) * (scal.E * st.y)), rows),
        z=(scal.Einv * st.z, rows), status=(st.status, (dp_axis,)), iters=(st.it, (dp_axis,)),
        pri_res=(st.pri_res, (dp_axis,)), dua_res=(st.dua_res, (dp_axis,)),
        obj_val=(st.obj_val, (dp_axis,)), dual_obj_val=(st.dual_obj_val, (dp_axis,)),
        rho=(st.rho.rho, (dp_axis,)), rho_updates=(st.rho_updates, (dp_axis,)),
        prim_inf_cert=(scal.E * st.delta_y if unscaled else st.delta_y, rows),
        dual_inf_cert=(scal.D * st.delta_x if unscaled else st.delta_x, rep),
        status_polish=(status_polish, (dp_axis,)))
    return ShardedResult(**{k: mesh.join(v, spec) for k, (v, spec) in out.items()},
                         host_syncs=syncs)


class BatchSharding:
    """Splits a batch tensor over the shards along the dp axis (its leading
    dimension; replicated over any other axis) and joins the per-shard
    results back: the port's ``NamedSharding(mesh, P(dp, None, ...))``."""

    def __init__(self, mesh, dp_axis, ndim):
        self.mesh = mesh
        self.spec = (dp_axis,) + (None,) * (ndim - 1)

    def split(self, t) -> Parts:
        """One block of rows per shard, each on its shard's device."""
        return self.mesh.split(t, self.spec)

    def join(self, parts) -> torch.Tensor:
        """The blocks concatenated in shard order on the first device."""
        return self.mesh.join(Parts(parts), self.spec)


def make_batch_shardings(mesh, dp_axis='dp'):
    """Batch shardings for dp-sharding the batched solver
    (``osqp_tpu_torch.batch.batch_qp_solve``) over a mesh: the batch axis
    split, all else follows.  Solve each shard's block (a call a shard) and
    join the results."""
    return {'mat': BatchSharding(mesh, dp_axis, 3), 'vec': BatchSharding(mesh, dp_axis, 2),
            'scalar': BatchSharding(mesh, dp_axis, 1)}
