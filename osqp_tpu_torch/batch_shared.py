"""Shared-structure batched solver on torch tensors.

Counterpart of ``osqp_tpu/batch_shared.py``.  Thousands of QPs share ``P`` and
``A`` and differ in ``q``, ``l`` and ``u``; with one shared KKT operator every
ADMM iteration of the whole batch is one dense matmul over an instance-last
``(feature, B)`` layout.  Semantics are those of the JAX package:

* rho is one shared scalar; the vector rho types constraints by the FIRST
  instance's scaled bounds; adaptive rho uses the median estimate over the
  still-active instances and refactorizes the shared operator;
* Ruiz scaling is computed from the shared P and A (cost normalization uses
  the batch-mean |q|), so D, E and c are shared;
* termination, certificates and statuses are exact per instance.

The epoch loop runs on the host.  Each epoch is one launch of the fused
kernel (``ops.shared_epoch``) on CUDA, or its plain version on the CPU, and
ends in one host sync: the count of still-unsolved columns, read together
with the median rho estimate on adaptation epochs.  The adaptive-rho
decisions are Python ``if``s on those values.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import scipy.sparse as sp
import torch

from . import tracing
from .constants import RHO_MAX, RHO_MIN, SolverStatus
from .device import resolve_device
from .ops.shared_epoch import affine_iterations, epoch_scalars, iter_halves, shared_epoch
from .settings import CoreSettings, OracleSettings, np_dtype
from .solver import core
from .solver.core import Scaling

_UNSOLVED = int(SolverStatus.OSQP_UNSOLVED)
_MAX_ITER = int(SolverStatus.OSQP_MAX_ITER_REACHED)
_PRIM_INF = int(SolverStatus.OSQP_PRIMAL_INFEASIBLE)
_PRIM_INF_INACC = int(SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
_DUAL_INF = int(SolverStatus.OSQP_DUAL_INFEASIBLE)
_DUAL_INF_INACC = int(SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE)
_NONCVX = int(SolverStatus.OSQP_NON_CVX)


@dataclass
class SharedState:
    it: int
    S: torch.Tensor  # (n+2m, B) stacked iterates [x; z; y]
    dX: torch.Tensor  # (n, B)
    dY: torch.Tensor  # (m, B)
    rho: np.floating  # shared scalar, host value of the working dtype
    rho_vec: torch.Tensor  # (m,)
    rho_inv: torch.Tensor  # (m,)
    Minv: torch.Tensor  # (n, n)
    M: torch.Tensor  # (n, n)
    F: torch.Tensor  # (n+m, n+2m) affine iteration map (see _build_affine)
    c0: torch.Tensor  # (n+m, B) affine constant
    status: torch.Tensor  # (B,) int32
    n_unsolved: int  # host count of status == UNSOLVED
    iters_done: torch.Tensor  # (B,) int32
    rho_updates: int
    fS: torch.Tensor  # (n+2m, B) captured solution iterates
    fdX: torch.Tensor
    fdY: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    obj_val: torch.Tensor
    dual_obj_val: torch.Tensor


def _build_affine(A, At, Minv, M, rho_vec, rho_inv, sigma, alpha, Q):
    """Assemble the affine iteration map.

    One ADMM iteration with the explicit-inverse KKT solve (one refinement
    step folded into ``R2 = 2 Minv - Minv M Minv``) and the identity
    ``z_tilde == A x_tilde`` collapses to::

        [x_tilde; pre_proj_z] = F @ [x; z; y] + c0
        z_new = clip(pre_proj_z, l, u)
        y_new = y + rho (pre_proj_z - y/rho - z_new)
        x_new = alpha x_tilde + (1-alpha) x
    """
    m = A.shape[0]
    R2 = 2.0 * Minv - Minv @ (M @ Minv)
    W1 = R2 @ At  # (n, m) = R2 A'
    AR2 = A @ R2  # (m, n)
    W2 = A @ W1  # (m, m) = A R2 A'
    J = rho_vec * rho_inv  # elementwise in {0, 1}
    Fx_t = sigma * R2
    Fz_t = W1 * rho_vec[None, :]
    Fy_t = -W1 * J[None, :]
    Fx_p = (sigma * alpha) * AR2
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    Fz_p = alpha * (W2 * rho_vec[None, :]) + (1 - alpha) * eye
    Fy_p = -alpha * (W2 * J[None, :]) + torch.diag(rho_inv)
    F = torch.cat([
        torch.cat([Fx_t, Fz_t, Fy_t], dim=1),
        torch.cat([Fx_p, Fz_p, Fy_p], dim=1),
    ], dim=0)
    G1 = R2 @ Q  # (n, B)
    c0 = torch.cat([-G1, -alpha * (A @ G1)], dim=0)
    return F, c0


def _batch_rho_estimate(CH, At, n, Q, X, Z, Y, rho):
    """Per-column rho estimate: two stacked matmuls (``[P; A] @ X`` and
    ``A' @ Y``) plus columnwise inf-norm reductions."""
    f = np_dtype(X.dtype)
    PAX = CH @ X
    PX, AX = PAX[:n], PAX[n:]
    AtY = At @ Y

    def cm(V):
        return V.abs().amax(dim=0)

    eps10 = f(1e-10)
    pri_n = cm(AX - Z) / (torch.maximum(cm(AX), cm(Z)) + eps10)
    dua_n = cm(PX + Q + AtY) / (
        torch.maximum(torch.maximum(cm(AtY), cm(PX)), cm(Q)) + eps10
    )
    return torch.clamp(rho * torch.sqrt(pri_n / (dua_n + eps10)), f(RHO_MIN), f(RHO_MAX))


def _batch_check_shared(P, A, Q, L_b, U_b, scal, settings, X, Z, Y, dX, dY,
                        approximate: bool):
    """Batch termination check: the math of the per-instance termination
    status as dense matmuls plus columnwise reductions, for m >= 1 (the
    shared engine needs a constraint).  Returns ``(status, pri_res, dua_res,
    obj, dual_obj)``."""
    dtype = X.dtype
    f = np_dtype(dtype)
    eps = torch.finfo(dtype).eps
    loose = f(1e30 * 1e-4)
    infty = f(1e30)

    factor = f(10.0) if approximate else f(1.0)
    eps_abs = settings.eps_abs * factor
    eps_rel = settings.eps_rel * factor
    eps_pinf = settings.eps_prim_inf * factor
    eps_dinf = settings.eps_dual_inf * factor
    unscaled = not settings.scaled_termination

    PX = P @ X
    AX = A @ X
    AtY = A.T @ Y

    def colmax(V):
        return V.abs().amax(dim=0)

    Einv = scal.Einv[:, None]
    Dinv = scal.Dinv[:, None]

    pri_vec = AX - Z
    pri_res = colmax(Einv * pri_vec) if unscaled else colmax(pri_vec)
    dua_vec = PX + Q + AtY
    dua_res = scal.cinv * colmax(Dinv * dua_vec) if unscaled else colmax(dua_vec)

    quad = 0.5 * (X * PX).sum(dim=0)
    qx = (Q * X).sum(dim=0)
    obj = (quad + qx) * scal.cinv
    noncvx_neg = (quad * scal.cinv) < (f(-1e-12) * torch.clamp((X * X).sum(dim=0), min=1.0))
    pri_res = torch.where(noncvx_neg, f(2 * 1e30), pri_res)

    # dual objective; computational-noise duals are zeroed before the sup
    Yu = scal.cinv * (scal.E[:, None] * Y)
    y_tol = eps * Yu.abs().amax(dim=0, keepdim=True)
    Yu = torch.where(Yu.abs() > y_tol, Yu, 0.0)
    Lu = Einv * L_b
    Uu = Einv * U_b
    sup_pos = torch.where(Uu < loose, Uu * torch.clamp(Yu, min=0.0), 0.0)
    sup_neg = torch.where(Lu > -loose, Lu * torch.clamp(Yu, max=0.0), 0.0)
    sup = sup_pos.sum(dim=0) + sup_neg.sum(dim=0)
    sup_mag = sup_pos.abs().sum(dim=0) + sup_neg.abs().sum(dim=0)
    dual_obj = -quad * scal.cinv - sup
    gap_noise = eps * (sup_mag + (quad * scal.cinv).abs() + qx.abs() * scal.cinv)

    Ax_t = colmax(Einv * AX) if unscaled else colmax(AX)
    z_t = colmax(Einv * Z) if unscaled else colmax(Z)
    eps_pri = eps_abs + eps_rel * torch.maximum(Ax_t, z_t)

    def dscale(V):
        return colmax(Dinv * V) if unscaled else colmax(V)

    scale_d = scal.cinv if unscaled else f(1)
    eps_dua = eps_abs + eps_rel * scale_d * torch.maximum(
        torch.maximum(dscale(AtY), dscale(PX)), dscale(Q))

    noncvx = (pri_res > infty) | (dua_res > infty)
    pri_check = pri_res < eps_pri
    dua_check = dua_res < eps_dua

    # primal infeasibility certificate
    norm_dY = colmax(scal.E[:, None] * dY) if unscaled else colmax(dY)
    lhs = (U_b * torch.clamp(dY, min=0.0) + L_b * torch.clamp(dY, max=0.0)).sum(dim=0)
    AtdY_n = dscale(A.T @ dY)
    pinf = (norm_dY > eps_pinf) & (lhs < -eps_pinf * norm_dY) & (AtdY_n < eps_pinf * norm_dY)
    pinf = pinf & ~pri_check

    # dual infeasibility certificate
    norm_dX = colmax(scal.D[:, None] * dX) if unscaled else colmax(dX)
    cost_scale = scal.c if unscaled else f(1)
    dinf = norm_dX > eps_dinf
    dinf &= (Q * dX).sum(dim=0) < (-cost_scale * eps_dinf * norm_dX)
    dinf &= dscale(P @ dX) < cost_scale * eps_dinf * norm_dX
    AdX = A @ dX
    if unscaled:
        AdX = Einv * AdX
    bad = ((U_b < loose) & (AdX > eps_dinf * norm_dX[None])) | (
        (L_b > -loose) & (AdX < -eps_dinf * norm_dX[None]))
    dinf &= ~bad.any(dim=0)
    dinf = dinf & ~dua_check

    solved_code = 2 if approximate else 1
    pinf_code = 4 if approximate else 3
    dinf_code = 6 if approximate else 5

    gap = obj - dual_obj
    eps_gap = (eps_abs + eps_rel * torch.maximum(obj.abs(), dual_obj.abs())
               + f(10.0) * gap_noise)
    if settings.check_dualgap:
        gap_ok = torch.isfinite(gap) & (gap.abs() < eps_gap)
    else:
        gap_ok = torch.ones_like(dua_check)

    status = torch.where(
        noncvx, _NONCVX,
        torch.where(pri_check & dua_check & gap_ok, solved_code,
                    torch.where(pinf, pinf_code, torch.where(dinf, dinf_code, _UNSOLVED))),
    ).to(torch.int32)
    obj = torch.where(
        status == _NONCVX, float('nan'),
        torch.where(status == pinf_code, infty,
                    torch.where(status == dinf_code, -infty, obj)),
    )
    return status, pri_res, dua_res, obj, dual_obj


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def shared_solve(P, A, Q, L_b, U_b, scal: Scaling, settings: CoreSettings,
                 rho0, Minv, M, rho_vec, X0, Z0, Y0, *,
                 fused: bool = True, compact: str = 'auto', iter_prec: str = 'highest'):
    """Solve the batch from the iterates ``X0, Z0, Y0`` (all tensors
    feature-first, ``(feature, B)``).

    ``fused``: one fused-epoch call per epoch (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors); ``False`` runs the unfused
    torch epoch.  ``compact``: ``'auto'`` finishes the straggler tail in a
    narrow buffer once it fits, ``'0'`` never does.  ``iter_prec``: the
    iteration product's precision, ``'highest'`` (IEEE, either dtype),
    ``'high'`` (three bfloat16 passes) or ``'default'`` (one), the last two in
    float32 only (``ops.shared_epoch.iter_halves``); fused and unfused epochs
    compute the same product."""
    iter_halves(iter_prec, Q.dtype)
    if compact not in ('auto', '0'):
        raise ValueError(f"compact must be 'auto' or '0', got {compact!r}")
    n, B = Q.shape
    m = A.shape[0]
    if B == 0 or m == 0:
        raise ValueError('the shared engine needs at least one instance and one constraint')
    dtype = Q.dtype
    f = np_dtype(dtype)
    dev = Q.device
    At = A.T.contiguous()
    sigma, alpha = settings.sigma, settings.alpha

    ct = settings.check_termination
    epoch_len = ct if ct > 0 else settings.iter_cap
    epochs_per_adapt = max(
        (settings.adaptive_rho_interval + epoch_len - 1) // max(epoch_len, 1), 1)

    rho0 = f(rho0)
    rho_inv0 = torch.where(rho_vec > 0, 1.0 / rho_vec, 0.0)
    F0, c00 = _build_affine(A, At, Minv, M, rho_vec, rho_inv0, sigma, alpha, Q)
    CH = torch.cat([P, A], dim=0)  # (n+m, n) stacked residual operator
    S0 = torch.cat([X0, Z0, Y0], dim=0)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    st = SharedState(
        it=0, S=S0,
        dX=torch.zeros((n, B), dtype=dtype, device=dev),
        dY=torch.zeros((m, B), dtype=dtype, device=dev),
        rho=rho0, rho_vec=rho_vec, rho_inv=rho_inv0, Minv=Minv, M=M, F=F0, c0=c00,
        status=full(_UNSOLVED, torch.int32), n_unsolved=B,
        iters_done=full(0, torch.int32), rho_updates=0,
        fS=S0.clone(),
        fdX=torch.zeros((n, B), dtype=dtype, device=dev),
        fdY=torch.zeros((m, B), dtype=dtype, device=dev),
        pri_res=full(float('inf')), dua_res=full(float('inf')),
        obj_val=full(float('nan')), dual_obj_val=full(float('nan')),
    )
    # shared constraint typing from the FIRST instance's bound pattern, taken
    # before any compaction so both loop phases type identically
    types0 = core.constraint_types(L_b[:, 0], U_b[:, 0])

    def check(Qc, Lc, Uc, S, dX, dY, approximate):
        return _batch_check_shared(P, A, Qc, Lc, Uc, scal, settings,
                                   S[:n], S[n:n + m], S[n + m:], dX, dY, approximate)

    def epoch(st: SharedState, Qc, Lc, Uc, this_epoch: int):
        it = st.it + this_epoch
        active = st.status == _UNSOLVED
        if fused:
            sc = epoch_scalars(settings, scal.c, scal.cinv, this_epoch, iter_prec)
            (S, dX, dY, fS, fdX, fdY, status_new, pri, dua, obj, dobj) = shared_epoch(
                st.F, CH, At, st.rho_vec, st.rho_inv,
                scal.D, scal.Dinv, scal.E, scal.Einv,
                st.c0, Qc, Lc, Uc, st.S, st.dX, st.dY, st.fS, st.fdX, st.fdY,
                st.status, sc,
            )
            st = replace(st, S=S, dX=dX, dY=dY, fS=fS, fdX=fdX, fdY=fdY, status=status_new)
        else:
            S, dX, dY = affine_iterations(st.F, st.c0, st.rho_vec, st.rho_inv, Lc, Uc,
                                          st.S, st.dX, st.dY, alpha, this_epoch, iter_prec)
            a2 = active[None]
            S = torch.where(a2, S, st.S)
            dX = torch.where(a2, dX, st.dX)
            dY = torch.where(a2, dY, st.dY)
            status_new, pri, dua, obj, dobj = check(Qc, Lc, Uc, S, dX, dY, False)
            newly = active & (status_new != _UNSOLVED)
            n2 = newly[None]
            st = replace(
                st, S=S, dX=dX, dY=dY,
                status=torch.where(newly, status_new, st.status),
                fS=torch.where(n2, S, st.fS),
                fdX=torch.where(n2, dX, st.fdX),
                fdY=torch.where(n2, dY, st.fdY),
            )
        return replace(
            st, it=it,
            iters_done=torch.where(active, it, st.iters_done),
            pri_res=torch.where(active, pri, st.pri_res),
            dua_res=torch.where(active, dua, st.dua_res),
            obj_val=torch.where(active, obj, st.obj_val),
            dual_obj_val=torch.where(active, dobj, st.dual_obj_val),
        )

    def run(st: SharedState, Qc, Lc, Uc, B_real: int, valid, thr: int):
        """Epochs while iterations remain and more than ``thr`` columns are
        unsolved.  Per-column math does not depend on the other columns of
        the buffer, so a compacted buffer gives the same trajectories;
        ``valid`` marks its real columns, which alone inform the median."""
        while st.it < settings.iter_cap and st.n_unsolved > thr:
            st = epoch(st, Qc, Lc, Uc, min(epoch_len, settings.iter_cap - st.it))
            n_uns = (st.status == _UNSOLVED).sum()
            epoch_idx = (st.it + epoch_len - 1) // max(epoch_len, 1)
            adapt = (settings.adaptive_rho and settings.adaptive_rho_interval > 0
                     and epoch_idx % epochs_per_adapt == 0)
            if not adapt:
                with tracing.span('sync', d2h=8):
                    st.n_unsolved = int(n_uns)  # the epoch's one host sync
                continue
            # masked median of the estimates over still-active real columns
            X, Z, Y = st.S[:n, :B_real], st.S[n:n + m, :B_real], st.S[n + m:, :B_real]
            ests = _batch_rho_estimate(CH, At, n, Qc[:, :B_real], X, Z, Y, st.rho)
            still = st.status[:B_real] == _UNSOLVED
            if valid is not None:
                still &= valid
            cnt = still.sum()
            vals = torch.sort(torch.where(still, ests, float('inf'))).values
            med_lo = vals[torch.clamp(cnt - 1, min=0) // 2]
            med_hi = vals[torch.clamp(cnt // 2, max=vals.shape[0] - 1)]
            med = 0.5 * (med_lo + med_hi)
            # the epoch's one host sync: both counts and the median together
            with tracing.span('sync', d2h=3 * Q.element_size()):
                n_uns, cnt, med = torch.stack([n_uns.to(dtype), cnt.to(dtype), med]).tolist()
            st.n_unsolved = int(n_uns)
            if st.n_unsolved == 0:
                continue
            rho_new = f(med) if cnt > 0 else st.rho
            tolr = settings.adaptive_rho_tolerance
            if not (rho_new > tolr * st.rho or rho_new < st.rho / tolr):
                continue
            with tracing.span('rho.update'):
                vec = core.rho_vec_from_types(types0, rho_new, settings.rho_is_vec, dtype)
                fac = core.factorize(P, A, sigma, vec, 'inv')
                rinv = torch.where(vec > 0, 1.0 / vec, 0.0)
                F_new, c0_new = _build_affine(A, At, fac.Minv, fac.L, vec, rinv, sigma, alpha,
                                              Qc)
            st = replace(
                st, rho=np.clip(rho_new, f(1e-6), f(1e6)), rho_vec=vec, rho_inv=rinv,
                Minv=fac.Minv, M=fac.L, F=F_new, c0=c0_new,
                rho_updates=st.rho_updates + 1,
            )
        return st

    with tracing.span('solve.loop'):
        # Straggler compaction: once the active tail fits a narrow buffer, gather
        # it and finish there, so the slowest instance no longer forces
        # full-batch epochs.  Exact (see ``run``).
        tail_width = max(128, _round_up(B // 16, 128))
        if B >= 4 * tail_width and compact != '0':
            st = run(st, Q, L_b, U_b, B, None, tail_width)
            # gather the still-active columns; fills duplicate column 0 and are
            # masked out of the adaptive-rho median through ``valid``
            with tracing.span('sync'):
                idx = torch.nonzero(st.status == _UNSOLVED).flatten()[:tail_width]
            idx = torch.cat([idx, idx.new_zeros(tail_width - idx.numel())])
            valid = torch.arange(tail_width, device=dev) < st.n_unsolved

            def g2(V):
                return V[:, idx]

            stc = replace(
                st, S=g2(st.S), dX=g2(st.dX), dY=g2(st.dY),
                fS=g2(st.fS), fdX=g2(st.fdX), fdY=g2(st.fdY), c0=g2(st.c0),
                status=st.status[idx], iters_done=st.iters_done[idx],
                pri_res=st.pri_res[idx], dua_res=st.dua_res[idx],
                obj_val=st.obj_val[idx], dual_obj_val=st.dual_obj_val[idx],
            )
            stc = run(stc, g2(Q), g2(L_b), g2(U_b), tail_width, valid, 0)
            for name in ('S', 'dX', 'dY', 'fS', 'fdX', 'fdY'):
                getattr(st, name)[:, idx] = getattr(stc, name)
            for name in ('status', 'iters_done', 'pri_res', 'dua_res', 'obj_val',
                         'dual_obj_val'):
                getattr(st, name)[idx] = getattr(stc, name)
            with tracing.span('sync', d2h=8):
                n_unsolved = int((st.status == _UNSOLVED).sum())
            st = replace(
                st, it=stc.it, rho=stc.rho, rho_vec=stc.rho_vec, rho_inv=stc.rho_inv,
                Minv=stc.Minv, M=stc.M, rho_updates=stc.rho_updates, n_unsolved=n_unsolved,
            )
        else:
            st = run(st, Q, L_b, U_b, B, None, 0)

        # post-loop max-iter handling: exact check, then approximate
        if st.n_unsolved:
            active = st.status == _UNSOLVED
            status_ex, pri_ex, dua_ex, obj_ex, dobj_ex = check(Q, L_b, U_b, st.S, st.dX, st.dY,
                                                               False)
            status_ap, _, _, obj_ap, _ = check(Q, L_b, U_b, st.S, st.dX, st.dY, True)
            status_fin = torch.where(
                status_ex != _UNSOLVED, status_ex,
                torch.where(status_ap != _UNSOLVED, status_ap, _MAX_ITER),
            ).to(torch.int32)
            a2 = active[None]
            st = replace(
                st,
                status=torch.where(active, status_fin, st.status),
                iters_done=torch.where(active, st.it, st.iters_done),
                pri_res=torch.where(active, pri_ex, st.pri_res),
                dua_res=torch.where(active, dua_ex, st.dua_res),
                obj_val=torch.where(active,
                                    torch.where(status_ex != _UNSOLVED, obj_ex, obj_ap),
                                    st.obj_val),
                dual_obj_val=torch.where(active, dobj_ex, st.dual_obj_val),
                fS=torch.where(a2, st.S, st.fS),
                fdX=torch.where(a2, st.dX, st.fdX),
                fdY=torch.where(a2, st.dY, st.fdY),
            )

    infeasible = torch.isin(st.status, _infeasible_codes(dev))[None]
    unscaled = not settings.scaled_termination
    fX = st.fS[:n]
    fY = st.fS[n + m:]
    X_out = torch.where(infeasible, float('nan'), scal.D[:, None] * fX)
    Y_out = torch.where(infeasible, float('nan'), scal.cinv * (scal.E[:, None] * fY))
    prim_cert = scal.E[:, None] * st.fdY if unscaled else st.fdY
    dual_cert = scal.D[:, None] * st.fdX if unscaled else st.fdX

    return dict(
        x=X_out.T, y=Y_out.T, prim_inf_cert=prim_cert.T, dual_inf_cert=dual_cert.T,
        status=st.status, iters=st.iters_done,
        pri_res=st.pri_res, dua_res=st.dua_res,
        obj_val=st.obj_val, dual_obj_val=st.dual_obj_val,
        rho=st.rho, rho_vec=st.rho_vec, Minv=st.Minv, M=st.M,
        rho_updates=st.rho_updates,
        X=st.S[:n], Z=st.S[n:n + m], Y=st.S[n + m:],
    )


@functools.cache
def _infeasible_codes(dev):
    """The four infeasibility statuses as a tensor on ``dev``, copied there
    once per device."""
    with tracing.span('sync', h2d=16):
        return torch.tensor([_PRIM_INF, _PRIM_INF_INACC, _DUAL_INF, _DUAL_INF_INACC],
                            dtype=torch.int32, device=dev)


def shared_mpc_rollout(P, A, Q0, L_b, U_b, scal, settings, rho0, Minv, M, rho_vec,
                       q_seq, *, fused: bool = True, compact: str = 'auto',
                       iter_prec: str = 'highest'):
    """Warm MPC steps on the shared path.  ``q_seq``: (S, n, B) UNSCALED
    per-step cost vectors.  Each step solves from the previous step's
    iterates, rho and factorization.  Returns ``(carry, (xs, iters,
    statuses))`` with carry ``(X, Z, Y, rho, Minv, M, rho_vec)``."""
    n, B = Q0.shape
    m = A.shape[0]
    dtype, dev = Q0.dtype, Q0.device
    carry = (torch.zeros((n, B), dtype=dtype, device=dev),
             torch.zeros((m, B), dtype=dtype, device=dev),
             torch.zeros((m, B), dtype=dtype, device=dev),
             rho0, Minv, M, rho_vec)
    xs, iters, statuses = [], [], []
    for q_new in q_seq:
        X, Z, Y, rho, Minv_c, M_c, rho_vec_c = carry
        out = shared_solve(
            P, A, settings_scale_q(scal, q_new), L_b, U_b, scal, settings, rho,
            Minv_c, M_c, rho_vec_c, X, Z, Y,
            fused=fused, compact=compact, iter_prec=iter_prec,
        )
        carry = (out['X'], out['Z'], out['Y'], out['rho'], out['Minv'], out['M'],
                 out['rho_vec'])
        xs.append(out['x'])
        iters.append(out['iters'])
        statuses.append(out['status'])
    return carry, (torch.stack(xs), torch.stack(iters), torch.stack(statuses))


def settings_scale_q(scal: Scaling, q_new):
    return scal.c * (scal.D[:, None] * q_new)


def shared_setup(P, A, q_b, l_b, u_b, settings_host: OracleSettings,
                 dtype=torch.float64, device=None):
    """Setup for the shared path.  P (n,n) and A (m,n) shared (dense or
    scipy sparse; P may be upper-triangular), q_b (B,n) and l_b/u_b (B,m)
    per instance.  Ruiz runs in float64 whatever ``dtype``.  Returns
    ``(P_s, A_s, Q, L, U, scaling, rho0, Minv, M, rho_vec)``, feature-first,
    on ``device`` (CUDA unless the caller passes one)."""
    dev = resolve_device(device)
    f = np_dtype(dtype)
    m = A.shape[0]
    P_full = np.asarray(sp.csc_matrix(P).todense(), np.float64)
    P_full = np.triu(P_full) + np.triu(P_full, 1).T
    A_d = np.asarray(sp.csc_matrix(A).todense(), np.float64)
    q_b = np.asarray(q_b, np.float64)
    l_b = np.maximum(np.asarray(l_b, np.float64), -1e30)
    u_b = np.minimum(np.asarray(u_b, np.float64), 1e30)

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

    # shared Ruiz from P/A with the batch-mean |q| as cost proxy
    zeros_m = torch.zeros(m, dtype=torch.float64, device=dev)
    with tracing.span('setup.scale'):
        data, scal = core.ruiz_scale(t64(P_full), t64(np.mean(np.abs(q_b), axis=0)), t64(A_d),
                                     zeros_m, zeros_m, int(settings_host.scaling))
    P_s = data.P.to(dtype)
    A_s = data.A.to(dtype)
    types = core.constraint_types((scal.E * t64(l_b[0])).to(dtype),
                                  (scal.E * t64(u_b[0])).to(dtype))
    rho0 = f(min(max(settings_host.rho, 1e-6), 1e6))
    rho_vec = core.rho_vec_from_types(types, rho0, bool(settings_host.rho_is_vec), dtype)
    fac = core.factorize(P_s, A_s, f(settings_host.sigma), rho_vec, 'inv')

    D = scal.D.cpu().numpy()
    E = scal.E.cpu().numpy()
    c = float(scal.c)

    def td(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    scal_t = Scaling(D=td(D), Dinv=td(1.0 / D), E=td(E), Einv=td(1.0 / E),
                     c=f(c), cinv=f(1.0 / c))
    Q = td(c * (D[None] * q_b).T)  # (n, B)
    L_t = td((E[None] * l_b).T)
    U_t = td((E[None] * u_b).T)
    return P_s, A_s, Q, L_t, U_t, scal_t, rho0, fac.Minv, fac.L, rho_vec
