"""The distributed PCG ADMM loop that ``bigqp`` and ``banded`` share.

``osqp_tpu/parallel/bigqp.py`` and ``banded.py`` each hold a copy of one
solver (their ``run``): the vector-rho ADMM of the single-device indirect
solver, whose x-update is a diagonally preconditioned CG on the Schur
operator ``M v = P v + sigma v + A' rho (A v)``, with the termination check,
both infeasibility certificates, adaptive rho with the preconditioner rebuilt
on the device, the 10x approximate retry and the polish through the same
operator.  The two copies differ only in where a vector lives and in how its
products and reductions cross the mesh; here that difference is an
``Operators`` tuple and the loop is written once.

Every value is a ``mesh.Parts`` (one tensor per shard of this process).
The JAX package's ``while_loop`` and ``cond`` become host control: the host
reads the CG test once a CG step and the check's outcome (with the
adaptive-rho trigger) once a check, each time one replicated value from
this process's first shard, whatever the number of shards.  Each read is
one counted host sync.  On a mesh over processes every process reads its
own replica; the mesh keeps replicas bit-identical, so every process takes
the same branches and counts the same syncs and CG steps.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import OSQP_INFTY, SolverStatus
from ..settings import np_dtype
from .mesh import Parts, each

_MIN_SCALING = 1e-4
_RHO_MIN, _RHO_MAX = 1e-6, 1e6
_RHO_EQ_FACTOR = 1e3
_RHO_TOL = 1e-4

_UNSOLVED = int(SolverStatus.OSQP_UNSOLVED)
_SOLVED = int(SolverStatus.OSQP_SOLVED)
_INFEASIBLE = tuple(int(s) for s in (
    SolverStatus.OSQP_PRIMAL_INFEASIBLE, SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    SolverStatus.OSQP_DUAL_INFEASIBLE, SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE))


def host_typing(l_s, u_s, rho, rho_is_vec):
    """Constraint types (-1 loose, 0 inequality, 1 equality, int8), the
    typed rho vector and the clipped rho, on the host (ref _osqp.py:499-524)."""
    loose = (l_s < -OSQP_INFTY * _MIN_SCALING) & (u_s > OSQP_INFTY * _MIN_SCALING)
    eq = (~loose) & (u_s - l_s < _RHO_TOL)
    types = np.where(loose, -1, np.where(eq, 1, 0)).astype(np.int8)
    rho0 = float(np.clip(rho, _RHO_MIN, _RHO_MAX))
    if rho_is_vec:
        rho_vec = np.where(loose, _RHO_MIN, np.where(eq, _RHO_EQ_FACTOR * rho0, rho0))
    else:
        rho_vec = np.full(len(l_s), rho0)
    return types, rho_vec, rho0


def host_bounds(l_old, u_old, E, l, u, m):
    """Scaled new bounds for an update: the old scaled ones where not
    given, checked for shape and order."""
    def scaled(v, lo, hi):
        return E * np.clip(np.asarray(v, np.float64).ravel(), lo, hi)

    l_new = l_old if l is None else scaled(l, -OSQP_INFTY, None)
    u_new = u_old if u is None else scaled(u, None, OSQP_INFTY)
    if l_new.shape != (m,) or u_new.shape != (m,):
        raise ValueError(f'l/u must have shape ({m},)')
    if np.any(l_new > u_new):
        raise ValueError('l must be <= u elementwise')
    return l_new, u_new


def pad_blocks(v, size, like, fill=0.0):
    """A length-``size`` vector (or one already laid out as ``like``) as
    ``like``'s (J, blk) blocks, padded with ``fill``, at ``like``'s dtype and
    device; ``None`` is all ``fill``."""
    if v is None:
        return torch.full_like(like, fill)
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if v.dim() == 2:
        return v.reshape(like.shape)
    return torch.nn.functional.pad(v, (0, like.numel() - size), value=fill).reshape(like.shape)


class Operators(NamedTuple):
    """How one layout's products and reductions cross the mesh.  x-space
    values are the iterate x's layout (replicated in ``bigqp``, row blocks in
    ``banded``); y-space values are always row blocks."""

    Pmv: Callable      # x -> x
    Amv: Callable      # x -> y
    Atmv: Callable     # y -> x
    gram: Callable     # rho (y) -> diag(A' rho A) (x)
    dots: Callable     # (x, x) pairs -> a replicated 0-d each, in one reduction
    max_x: Callable    # x -> replicated inf-norm
    max_y: Callable    # y -> replicated inf-norm
    sum_y: Callable    # y -> replicated sum


class Problem(NamedTuple):
    """The scaled problem on the shards (Parts); ``c`` and ``cinv`` are
    replicated 0-d tensors."""

    q: Parts
    l: Parts
    u: Parts
    rho_vec: Parts
    types: Parts
    diag_M: Parts
    D: Parts
    Dinv: Parts
    E: Parts
    Einv: Parts
    c: Parts
    cinv: Parts


class RunOut(NamedTuple):
    """What one run leaves on the shards: the scaled iterates, the unscaled
    outputs and certificates (Parts), and the host's counts."""

    x: Parts
    z: Parts
    y: Parts
    x_out: Parts
    y_out: Parts
    prim_cert: Parts
    dual_cert: Parts
    pri: Parts
    dua: Parts
    obj: Parts
    rho: Parts
    status: int
    iters: int
    rho_updates: int
    status_polish: int
    cg_iters: int
    host_syncs: int
    cg_cap_hits: int


def make_run(mesh, ops: Operators, prob: Problem, *, n, dtype, data_sigma, rho0,
             sigma=None, alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, eps_prim_inf=1e-4,
             eps_dual_inf=1e-4, max_iter=4000, check_every=25, adaptive_rho=True,
             adaptive_rho_interval=100, adaptive_rho_tolerance=5.0, cg_tol=None,
             cg_max_iter=None, polish=False, delta=1e-6, polish_refine_iter=3):
    """The solver for this (mesh, layout, settings): ``run(q, x0, z0, y0)``
    takes the scaled cost and the scaled starting iterates (Parts) and
    returns a ``RunOut``.  Settings and their defaults are the JAX
    package's (``bigqp._make_bigqp_run``)."""
    f = np_dtype(dtype)
    if sigma is None:
        sigma = data_sigma
    # diag_M was baked with setup's sigma; an overridden sigma shifts it
    sigma_shift = f(float(sigma) - float(data_sigma))
    sigma_t, alpha_t = f(sigma), f(alpha)
    eps_abs_t, eps_rel_t = f(eps_abs), f(eps_rel)
    eps_pinf_t, eps_dinf_t = f(eps_prim_inf), f(eps_dual_inf)
    delta_t = f(delta)
    if cg_tol is None:
        cg_tol = 1e-12 if dtype == torch.float64 else 1e-7
    cg_tol_t = f(cg_tol)
    cg_cap = int(cg_max_iter if cg_max_iter is not None else max(2 * n, 100))
    tolr = f(adaptive_rho_tolerance)
    epochs_per_adapt = max(adaptive_rho_interval // max(check_every, 1), 1)
    tiny = torch.finfo(dtype).tiny
    one = f(1)

    Pmv, Amv, Atmv = ops.Pmv, ops.Amv, ops.Atmv
    max_x, max_y = ops.max_x, ops.max_y
    p = prob
    l_loc, u_loc, types = p.l, p.u, p.types
    cinv, c = p.cinv, p.c

    def where(cond, a, b):
        return each(torch.where, cond, a, b)

    def maximum(a, b):
        return each(torch.maximum, a, b)

    def dot(a, b):
        return ops.dots((a, b))[0]

    def Mmv(v, rho, shift):
        return Pmv(v) + shift * v + Atmv(rho * Amv(v))

    diag_M = p.diag_M + sigma_shift
    dinv0 = 1.0 / diag_M
    # diag_M without its rho part, so adaptive rho rebuilds the
    # preconditioner on the device
    diagPsig = diag_M - ops.gram(p.rho_vec)

    counts = SimpleNamespace(syncs=0, cg=0, cap_hits=0)

    def read(*values):
        counts.syncs += 1
        return mesh.read(*values)

    def pcg(rhs, xk, rho, dinv, shift):
        b_norm = each(torch.sqrt, dot(rhs, rhs))
        tol = each(lambda t: torch.clamp(cg_tol_t * t, min=tiny), b_norm)
        r = rhs - Mmv(xk, rho, shift)
        zv = dinv * r
        pv = zv
        # r'r (the stop test's) and r'z of the new residual in one reduction
        rr, rz = ops.dots((r, r), (r, zv))
        k = 0
        while k < cg_cap:
            if not read(each(torch.sqrt, rr) > tol)[0]:
                break
            Mp = Mmv(pv, rho, shift)
            denom = dot(pv, Mp)
            a = rz / where(denom != 0, denom, 1.0)
            xk = xk + a * pv
            r = r - a * Mp
            zv = dinv * r
            rr, rzn = ops.dots((r, r), (r, zv))
            beta = rzn / where(rz != 0, rz, 1.0)
            pv = zv + beta * pv
            rz = rzn
            k += 1
        else:
            counts.cap_hits += 1
        counts.cg += k
        return xk

    def admm_step(q, x, z, y, xt_prev, rho, rinv, dinv):
        b2 = z - rinv * y
        rhs = sigma_t * x - q + Atmv(rho * b2)
        x_t = pcg(rhs, xt_prev, rho, dinv, sigma_t)
        Axt = Amv(x_t)
        nu = rho * (Axt - b2)
        z_t = z + rinv * (nu - y)
        x_new = alpha_t * x_t + (one - alpha_t) * x
        z_rel = alpha_t * z_t + (one - alpha_t) * z
        z_new = each(torch.clamp, z_rel + rinv * y, l_loc, u_loc)
        dy_new = rho * (z_rel - z_new)
        return x_new, z_new, y + dy_new, x_t, x_new - x, dy_new

    def primal_infeasible(dy, factor):
        """(ref _osqp.py:796-820)"""
        eps = eps_pinf_t * factor
        norm_dy = max_y(p.E * dy)
        lhs = ops.sum_y(u_loc * each(torch.clamp, dy, 0) + l_loc * each(
            lambda t: torch.clamp(t, max=0), dy))
        At_dy = Atmv(dy)
        return (norm_dy > eps) & (lhs < -eps * norm_dy) & (max_x(p.Dinv * At_dy) < eps * norm_dy)

    def dual_infeasible(q, dx, factor):
        """(ref _osqp.py:822-878)"""
        eps = eps_dinf_t * factor
        norm_dx = max_x(p.D * dx)
        ok = norm_dx > eps
        ok = ok & (dot(q, dx) < -c * eps * norm_dx)
        ok = ok & (max_x(p.Dinv * Pmv(dx)) < c * eps * norm_dx)
        A_dx = p.Einv * Amv(dx)
        u_fin = u_loc < OSQP_INFTY * _MIN_SCALING
        l_fin = l_loc > -OSQP_INFTY * _MIN_SCALING
        bad = (u_fin & (A_dx > eps * norm_dx)) | (l_fin & (A_dx < -eps * norm_dx))
        return ok & ~(max_y(bad.map(lambda t: t.to(dtype))) > 0)

    def check(q, x, z, y, factor=1.0):
        """Unscaled residual norms and tolerances (ref _osqp.py:705-794)."""
        ea = eps_abs_t * factor
        er = eps_rel_t * factor
        Ax, Px, Aty = Amv(x), Pmv(x), Atmv(y)
        pri = max_y(p.Einv * (Ax - z))
        dua = cinv * max_x(p.Dinv * (Px + q + Aty))
        eps_pri = ea + er * maximum(max_y(p.Einv * Ax), max_y(p.Einv * z))
        eps_dua = ea + er * cinv * maximum(
            maximum(max_x(p.Dinv * Aty), max_x(p.Dinv * Px)), max_x(p.Dinv * q))
        obj = (0.5 * dot(x, Px) + dot(q, x)) * cinv
        # normalized residuals for the rho estimate (ref _osqp.py:880-908)
        pri_n = max_y(Ax - z) / (maximum(max_y(Ax), max_y(z)) + 1e-10)
        dua_n = max_x(Px + q + Aty) / (maximum(maximum(max_x(Aty), max_x(Px)), max_x(q)) + 1e-10)
        return pri, dua, eps_pri, eps_dua, obj, pri_n, dua_n

    def full_status(q, x, z, y, dx, dy, factor, codes):
        """Termination decision at one check (ref _osqp.py:998-1077)."""
        solved, pinf_c, dinf_c = codes
        pri, dua, eps_pri, eps_dua, obj, pri_n, dua_n = check(q, x, z, y, factor)
        pri_ok = pri < eps_pri
        dua_ok = dua < eps_dua
        pinf = ~pri_ok & primal_infeasible(dy, factor)
        dinf = ~dua_ok & dual_infeasible(q, dx, factor)
        status = each(lambda ok, pi, di: torch.where(
            ok, solved, torch.where(pi, pinf_c, torch.where(di, dinf_c, _UNSOLVED))),
            pri_ok & dua_ok, pinf, dinf)
        return status, pri, dua, obj, pri_n, dua_n

    exact = tuple(int(s) for s in (SolverStatus.OSQP_SOLVED, SolverStatus.OSQP_PRIMAL_INFEASIBLE,
                                   SolverStatus.OSQP_DUAL_INFEASIBLE))
    approx = tuple(int(s) for s in (SolverStatus.OSQP_SOLVED_INACCURATE,
                                    SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
                                    SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE))

    def run(q, x, z, y):
        counts.syncs = counts.cg = counts.cap_hits = 0
        rho = p.rho_vec
        rinv = where(rho > 0, 1.0 / rho, 0.0)
        dinv = dinv0
        rho_s = each(lambda t: torch.full((), rho0, dtype=dtype, device=t.device), q)
        xt = x
        dx, dy = x.map(torch.zeros_like), y.map(torch.zeros_like)
        nan = each(lambda t: torch.full((), float('nan'), dtype=dtype, device=t.device), q)
        pri = dua = nan.map(lambda t: torch.full_like(t, float('inf')))
        obj = nan
        it, status, rupd = 0, _UNSOLVED, 0
        while it < max_iter and status == _UNSOLVED:
            for _ in range(check_every):
                x, z, y, xt, dx, dy = admm_step(q, x, z, y, xt, rho, rinv, dinv)
            it += check_every
            st, pri, dua, obj, pri_n, dua_n = full_status(q, x, z, y, dx, dy, 1.0, exact)
            if adaptive_rho and (it // max(check_every, 1)) % epochs_per_adapt == 0:
                est = each(lambda r, pn, dn: torch.clamp(r * torch.sqrt(pn / (dn + 1e-10)),
                                                         _RHO_MIN, _RHO_MAX), rho_s, pri_n, dua_n)
                trig = (est > tolr * rho_s) | (est < rho_s / tolr)
                status, fire = (int(v) for v in read(st, trig))
                if status == _UNSOLVED and fire:
                    rho = each(lambda ty, e: torch.where(
                        ty == -1, _RHO_MIN, torch.where(ty == 1, _RHO_EQ_FACTOR * e, e)).to(dtype),
                        types, est)
                    rinv = 1.0 / rho
                    dinv = 1.0 / (diagPsig + ops.gram(rho))
                    rho_s = est
                    rupd += 1
            else:
                status = int(read(st)[0])

        # max-iter fallback: retry at 10x tolerances -> *_INACCURATE
        if status == _UNSOLVED:
            st = full_status(q, x, z, y, dx, dy, 10.0, approx)[0]
            status = int(read(st)[0])
            if status == _UNSOLVED:
                status = int(SolverStatus.OSQP_MAX_ITER_REACHED)

        # polish (ref _osqp.py:1710-1828): the same distributed Schur PCG
        # with rho := 1/delta on the guessed active rows
        status_polish = 0
        if polish and status == _SOLVED:
            low = (z - l_loc) < -y
            upp = (u_loc - z) < y
            act = low | upp
            b = where(low, l_loc, where(upp, u_loc, 0.0))
            rho_pol = act.map(lambda t: t.to(dtype)) * (one / delta_t)
            dinv_pol = 1.0 / (diagPsig - sigma_t + delta_t + ops.gram(rho_pol))
            rhs = -q + Atmv(rho_pol * b)
            x_pol = pcg(rhs, x, rho_pol, dinv_pol, delta_t)
            for _ in range(polish_refine_iter):
                resid = rhs - Mmv(x_pol, rho_pol, delta_t)
                x_pol = x_pol + pcg(resid, x_pol.map(torch.zeros_like), rho_pol, dinv_pol,
                                    delta_t)
            Ax_pol = Amv(x_pol)
            y_pol = rho_pol * (Ax_pol - b)
            z_pol = where(act, b, Ax_pol)
            pri_p, dua_p, _, _, obj_p, _, _ = check(q, x_pol, z_pol, y_pol)
            if read((pri_p < pri) & (dua_p < dua))[0]:
                x, z, y, pri, dua, obj, status_polish = x_pol, z_pol, y_pol, pri_p, dua_p, obj_p, 1
            else:
                obj = (0.5 * dot(x, Pmv(x)) + dot(q, x)) * cinv
                status_polish = -1

        if status in _INFEASIBLE:
            x_out = x.map(lambda t: torch.full_like(t, float('nan')))
            y_out = y.map(lambda t: torch.full_like(t, float('nan')))
        else:
            x_out = p.D * x
            y_out = cinv * (p.E * y)
        return RunOut(x=x, z=z, y=y, x_out=x_out, y_out=y_out, prim_cert=p.E * dy,
                      dual_cert=p.D * dx, pri=pri, dua=dua, obj=obj, rho=rho_s, status=status,
                      iters=it, rho_updates=rupd, status_polish=status_polish,
                      cg_iters=counts.cg, host_syncs=counts.syncs, cg_cap_hits=counts.cap_hits)

    return run


def clean_carry(mesh, x_out, status, *carries):
    """The rollout's cold restart (``banded_mpc_rollout``): after an
    infeasible step or a NaN anywhere in x, every carry restarts at zero;
    otherwise each non-finite or blown-up (> 1e30) element is zeroed.  No
    host sync: the NaN test stays on the device."""
    nan_any = mesh.pmax(x_out.map(lambda t: torch.isnan(t).any().to(t.dtype)))
    cold_host = status in _INFEASIBLE

    def clean(a, nan):
        bad = ~torch.isfinite(a) | (a.abs() > 1e30) | (nan > 0)
        if cold_host:
            bad = torch.ones_like(bad)
        return torch.where(bad, torch.zeros((), dtype=a.dtype, device=a.device), a)

    return tuple(each(clean, v, nan_any) for v in carries)
