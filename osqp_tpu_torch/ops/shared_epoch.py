"""Fused shared-structure ADMM epoch: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``osqp_tpu/ops/shared_epoch.py`` (``_body_kernel``, launched by
``shared_body_pallas``).  One call runs one whole epoch of the shared engine
for every batch column:

1. ``K`` affine ADMM iterations ``V = F @ S + c0``, ``Z = clip(V[n:], L, U)``,
   then the y and x relaxation updates (``S = [x; z; y]``, see
   ``osqp_tpu_torch.batch_shared._build_affine``);
2. the active-column merge (terminated columns stay frozen);
3. the full per-column termination check: residuals, objective, dual objective
   and gap with its noise floor, both infeasibility certificates and the
   non-convexity guard;
4. capture of newly terminated columns (``fS``, ``fdX``, ``fdY``).

Layout is instance-last, ``(feature, B)``, contiguous.  Nothing is padded:
the kernel masks the ragged batch edge itself.

``shared_epoch`` launches the kernel for CUDA tensors (and raises if it cannot)
and runs ``shared_epoch_plain`` for CPU tensors.  ``launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import OSQP_INFTY, MIN_SCALING, SolverStatus
from ..settings import np_dtype

SOLVED = int(SolverStatus.OSQP_SOLVED)
PINF = int(SolverStatus.OSQP_PRIMAL_INFEASIBLE)
DINF = int(SolverStatus.OSQP_DUAL_INFEASIBLE)
UNSOLVED = int(SolverStatus.OSQP_UNSOLVED)
NONCVX = int(SolverStatus.OSQP_NON_CVX)

# Kernel launches since the last reset; a plain counter read by chip_smoke.py.
launches = 0

# Dynamic shared memory a block may take on Hopper (232,448 bytes), less room
# for the kernel's static arrays.
_SMEM_LIMIT = 232_448 - 1024
# Threads per block at most (kMaxThreads) and rows of a thread's micro-tile,
# as in csrc/shared_epoch.cu.
_MAX_THREADS = 384
_ROWS = 4
# A block's fixed cost in columns of iteration work, for the planner; from
# timings of K1 on an H100 at several tile widths (PERF.md, section 6).
_BLOCK_COLS = 8


class EpochScalars(NamedTuple):
    """Per-epoch scalars (host values of the working dtype)."""

    alpha: np.floating
    eps_abs: np.floating
    eps_rel: np.floating
    eps_prim_inf: np.floating
    eps_dual_inf: np.floating
    c: np.floating
    cinv: np.floating
    K: int
    scaled_termination: bool
    check_dualgap: bool


def epoch_scalars(settings, c, cinv, K: int) -> EpochScalars:
    return EpochScalars(
        alpha=settings.alpha, eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        eps_prim_inf=settings.eps_prim_inf, eps_dual_inf=settings.eps_dual_inf,
        c=c, cinv=cinv, K=int(K),
        scaled_termination=bool(settings.scaled_termination),
        check_dualgap=bool(settings.check_dualgap),
    )


def affine_iterations(F, c0, rho_vec, rho_inv, L, U, S, dX, dY, alpha, K: int):
    """``K`` ADMM iterations in affine form (``_build_affine``): returns the
    new stacked state and the last iteration's deltas ``(S, dX, dY)``."""
    n = c0.shape[0] - L.shape[0]
    m = L.shape[0]
    rho = rho_vec[:, None]
    rhoinv = rho_inv[:, None]
    one_m_alpha = type(alpha)(1) - alpha
    for _ in range(K):
        X = S[:n]
        Y = S[n + m:]
        V = F @ S + c0
        Xt = V[:n]
        Pz = V[n:]
        Zn = torch.minimum(torch.maximum(Pz, L), U)
        Yn = Y + rho * (Pz - rhoinv * Y - Zn)
        Xn = alpha * Xt + one_m_alpha * X
        S = torch.cat([Xn, Zn, Yn], dim=0)
        dX = Xn - X
        dY = Yn - Y
    return S, dX, dY


def shared_epoch_plain(F, CH, At, rho_vec, rho_inv, D, Dinv, E, Einv,
                       c0, Q, L, U, S, dX, dY, fS, fdX, fdY, status,
                       sc: EpochScalars):
    """The epoch in plain torch ops: the same function as the kernel, written
    as ``_body_kernel`` writes it.  Returns ``(S, dX, dY, fS, fdX, fdY,
    status, pri, dua, obj, dobj)``."""
    n = Q.shape[0]
    m = L.shape[0]
    dtype = S.dtype
    eps = torch.finfo(dtype).eps
    f = np_dtype(dtype)
    alpha = f(sc.alpha)
    cinv = f(sc.cinv)
    c = f(sc.c)
    eps_abs, eps_rel = f(sc.eps_abs), f(sc.eps_rel)
    eps_pinf, eps_dinf = f(sc.eps_prim_inf), f(sc.eps_dual_inf)
    unscaled = not sc.scaled_termination
    loose = f(OSQP_INFTY * MIN_SCALING)

    # ---- 1. K ADMM iterations (affine form) ----
    Sn, dXn, dYn = affine_iterations(F, c0, rho_vec, rho_inv, L, U, S, dX, dY, alpha, sc.K)

    # ---- 2. merge: terminated columns stay frozen ----
    active = (status == UNSOLVED)[None]
    S = torch.where(active, Sn, S)
    dX = torch.where(active, dXn, dX)
    dY = torch.where(active, dYn, dY)
    X = S[:n]
    Z = S[n:n + m]
    Y = S[n + m:]

    # ---- 3. termination check ----
    def colmax(V):
        return V.abs().amax(dim=0)

    def dscale(V):
        return colmax(Dinv[:, None] * V) if unscaled else colmax(V)

    Einv_c = Einv[:, None]
    PAX = CH @ X
    PX = PAX[:n]
    AX = PAX[n:]
    AtY = At @ Y

    pri_vec = AX - Z
    pri = colmax(Einv_c * pri_vec) if unscaled else colmax(pri_vec)
    dua_vec = PX + Q + AtY
    dua = cinv * colmax(Dinv[:, None] * dua_vec) if unscaled else colmax(dua_vec)

    quad = 0.5 * (X * PX).sum(dim=0)
    qx = (Q * X).sum(dim=0)
    obj = (quad + qx) * cinv
    noncvx_neg = (quad * cinv) < (f(-1e-12) * torch.clamp((X * X).sum(dim=0), min=1.0))
    pri = torch.where(noncvx_neg, f(2 * OSQP_INFTY), pri)

    Yu = cinv * (E[:, None] * Y)
    y_tol = eps * Yu.abs().amax(dim=0, keepdim=True)
    Yu = torch.where(Yu.abs() > y_tol, Yu, 0.0)
    Lu = Einv_c * L
    Uu = Einv_c * U
    sup_pos = torch.where(Uu < loose, Uu * torch.clamp(Yu, min=0.0), 0.0)
    sup_neg = torch.where(Lu > -loose, Lu * torch.clamp(Yu, max=0.0), 0.0)
    sup = sup_pos.sum(dim=0) + sup_neg.sum(dim=0)
    sup_mag = sup_pos.abs().sum(dim=0) + sup_neg.abs().sum(dim=0)
    dobj = -quad * cinv - sup
    gap_noise = eps * (sup_mag + (quad * cinv).abs() + qx.abs() * cinv)

    Ax_t = colmax(Einv_c * AX) if unscaled else colmax(AX)
    z_t = colmax(Einv_c * Z) if unscaled else colmax(Z)
    eps_pri = eps_abs + eps_rel * torch.maximum(Ax_t, z_t)
    scale_d = cinv if unscaled else f(1)
    eps_dua = eps_abs + eps_rel * scale_d * torch.maximum(
        torch.maximum(dscale(AtY), dscale(PX)), dscale(Q))

    noncvx = (pri > f(OSQP_INFTY)) | (dua > f(OSQP_INFTY))
    pri_check = pri < eps_pri
    dua_check = dua < eps_dua

    # primal infeasibility certificate
    norm_dY = colmax(E[:, None] * dY) if unscaled else colmax(dY)
    lhs = (U * torch.clamp(dY, min=0.0) + L * torch.clamp(dY, max=0.0)).sum(dim=0)
    AtdY_n = dscale(At @ dY)
    pinf = (norm_dY > eps_pinf) & (lhs < -eps_pinf * norm_dY) & (AtdY_n < eps_pinf * norm_dY)
    pinf = pinf & ~pri_check

    # dual infeasibility certificate
    PAdX = CH @ dX
    PdX = PAdX[:n]
    AdX = PAdX[n:]
    norm_dX = colmax(D[:, None] * dX) if unscaled else colmax(dX)
    cost_scale = c if unscaled else f(1)
    dinf = norm_dX > eps_dinf
    dinf &= (Q * dX).sum(dim=0) < (-cost_scale * eps_dinf * norm_dX)
    dinf &= dscale(PdX) < cost_scale * eps_dinf * norm_dX
    if unscaled:
        AdX = Einv_c * AdX
    bad = ((U < loose) & (AdX > eps_dinf * norm_dX[None])) | (
        (L > -loose) & (AdX < -eps_dinf * norm_dX[None]))
    dinf &= ~bad.any(dim=0)
    dinf = dinf & ~dua_check

    gap = obj - dobj
    eps_gap = eps_abs + eps_rel * torch.maximum(obj.abs(), dobj.abs()) + f(10) * gap_noise
    gap_ok = (torch.isfinite(gap) & (gap.abs() < eps_gap)) if sc.check_dualgap \
        else torch.ones_like(pri_check)

    cand = torch.where(
        noncvx, NONCVX,
        torch.where(pri_check & dua_check & gap_ok, SOLVED,
                    torch.where(pinf, PINF, torch.where(dinf, DINF, UNSOLVED))),
    ).to(torch.int32)
    obj = torch.where(cand == NONCVX, float('nan'),
                      torch.where(cand == PINF, f(OSQP_INFTY),
                                  torch.where(cand == DINF, f(-OSQP_INFTY), obj)))

    # ---- 4. capture newly-terminated columns ----
    newly = active[0] & (cand != UNSOLVED)
    status_o = torch.where(newly, cand, status)
    fS = torch.where(newly[None], S, fS)
    fdX = torch.where(newly[None], dX, fdX)
    fdY = torch.where(newly[None], dY, fdY)
    return S, dX, dY, fS, fdX, fdY, status_o, pri, dua, obj, dobj


class TilePlan(NamedTuple):
    """How the kernel cuts one epoch: ``tb`` batch columns per block,
    ``threads`` per block, each owning a 4 x ``tc`` micro-tile of
    ``V = F S``, and F' staged ``ks`` rows of k at a time: all of it once per
    epoch (F resident, ``ks = n + 2m``) or in slabs in every iteration.  The
    block's shared memory is ``smem_bytes(n, m, tb, ks, itemsize)``."""

    tb: int
    threads: int
    tc: int
    ks: int


def w_stride(nm: int, itemsize: int) -> int:
    """Row stride (elements) of F' in shared memory: ``nm`` rounded up to 4,
    then to 16 bytes past a multiple of 128 bytes (``w_stride`` in the .cu
    source)."""
    r4 = -(-nm // 4) * 4
    mod, want = 128 // itemsize, 16 // itemsize
    return r4 + (want - r4 % mod) % mod


def smem_bytes(n: int, m: int, tb: int, ks: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: the ``Layout`` of the .cu source
    (F' staged ``ks`` rows deep; the state S, dX, dY; V and T of the check;
    the epoch-constant c0, L, U, Q and rho, 1/rho; 16 partial results per
    column of the check), each region rounded up to 16 bytes."""
    nm, N2 = n + m, n + 2 * m
    sizes = (ks * w_stride(nm, itemsize), N2 * tb, nm * tb, n * tb, n * tb, m * tb,
             nm * tb, m * tb, m * tb, n * tb, m, m, 16 * tb)
    align = 16 // itemsize
    return sum(-(-s // align) * align for s in sizes) * itemsize


def make_plan(n: int, m: int, tb: int, tc: int, itemsize: int) -> TilePlan:
    """The plan for a given block width and micro-tile: F resident when it
    fits beside the tiles, else the deepest slab (a multiple of 8 rows of k)
    that does.  Raises ``ValueError`` when not even an 8-deep slab fits, or
    when the kernel cannot run the micro-tile (more than 384 threads, or
    fewer threads than batch columns)."""
    N2 = n + 2 * m
    threads = -(-(n + m) // _ROWS) * (tb // tc)
    if not (tc <= tb and tb <= threads <= _MAX_THREADS):
        raise ValueError(f'shared_epoch: {tb} columns per block in micro-tiles {_ROWS} x {tc} '
                         f'take {threads} threads; the kernel runs {tb} to {_MAX_THREADS}')
    if smem_bytes(n, m, tb, N2, itemsize) <= _SMEM_LIMIT:
        ks = N2
    else:
        per_k = w_stride(n + m, itemsize) * itemsize
        ks = (_SMEM_LIMIT - smem_bytes(n, m, tb, 0, itemsize)) // per_k // 8 * 8
        if ks < 8:
            raise ValueError(
                f'shared_epoch: n={n}, m={m} needs {smem_bytes(n, m, tb, 8, itemsize)} bytes '
                f'of shared memory at {tb} batch columns per block (limit {_SMEM_LIMIT})')
    return TilePlan(tb, threads, tc, ks)


@functools.lru_cache(maxsize=64)
def plan_tile(n: int, m: int, B: int, itemsize: int, n_sm: int) -> TilePlan:
    """The kernel's plan.  Block width: the power of two up to 32 whose tile
    fits and that least loads the busiest SM (its blocks times each block's
    columns plus a fixed cost per block), the wider one on a tie.
    Micro-tile columns: 2 where that still gives the block at least eight
    warps, else 1.  Threads stay
    within the kernel's 384, and at least one per batch column of the tile
    (the check's column loops)."""
    n_groups = -(-(n + m) // _ROWS)
    if smem_bytes(n, m, 1, 8, itemsize) > _SMEM_LIMIT:
        raise ValueError(
            f'shared_epoch: n={n}, m={m} needs {smem_bytes(n, m, 1, 8, itemsize)} bytes of '
            f'shared memory even at one batch column per block (limit {_SMEM_LIMIT})')
    if n_groups > _MAX_THREADS:
        raise ValueError(f'shared_epoch: n + m = {n + m} exceeds {_ROWS * _MAX_THREADS} '
                         f'(one {_ROWS}-row micro-tile per thread, {_MAX_THREADS} threads)')
    plans = []
    for tb in (32, 16, 8, 4, 2, 1):
        runnable = []
        for tc in (2, 1):
            try:
                runnable.append(make_plan(n, m, tb, tc, itemsize))
            except ValueError:  # TB = 1, TC = 1 always runs (checked above)
                continue
        if runnable:
            plans.append(next((p for p in runnable if p.threads >= 256), runnable[-1]))
    # the busiest SM's work, with blocks dealt out evenly: its blocks times
    # each block's columns, plus a fixed cost per block (loads, barriers, the
    # check's serial steps) worth about _BLOCK_COLS columns
    def busiest_sm(p):
        blocks = -(-B // p.tb)
        return -(-blocks // n_sm) * (p.tb + _BLOCK_COLS)

    return min(plans, key=busiest_sm)


def _lib_fn(dtype):
    from ._build import load_library

    lib = load_library('shared_epoch')
    fn = lib.shared_epoch_f32 if dtype == torch.float32 else lib.shared_epoch_f64
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        fn.argtypes = [ci] * 9 + [vp] * 33
        fn.restype = ci
    return fn


def shared_epoch(F, CH, At, rho_vec, rho_inv, D, Dinv, E, Einv,
                 c0, Q, L, U, S, dX, dY, fS, fdX, fdY, status,
                 sc: EpochScalars):
    """One fused epoch.  CUDA tensors: one launch of the Hopper kernel in
    ``csrc/shared_epoch.cu`` on the current stream.  CPU tensors: the plain
    version.  Returns ``(S, dX, dY, fS, fdX, fdY, status, pri, dua, obj,
    dobj)``; the inputs are not modified."""
    args = (F, CH, At, rho_vec, rho_inv, D, Dinv, E, Einv,
            c0, Q, L, U, S, dX, dY, fS, fdX, fdY, status)
    if S.device.type == 'cpu':
        return shared_epoch_plain(*args, sc)
    if S.device.type != 'cuda':
        raise ValueError(f'shared_epoch: unsupported device {S.device}')
    n, B = Q.shape
    m = L.shape[0]
    dtype = S.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'shared_epoch: dtype must be float32 or float64, got {dtype}')
    if m == 0 or n == 0:
        raise ValueError('shared_epoch: needs n > 0 and m > 0')
    nm, N2 = n + m, n + 2 * m
    shapes = dict(F=(nm, N2), CH=(nm, n), At=(n, m), rho_vec=(m,), rho_inv=(m,),
                  D=(n,), Dinv=(n,), E=(m,), Einv=(m,), c0=(nm, B), Q=(n, B),
                  L=(m, B), U=(m, B), S=(N2, B), dX=(n, B), dY=(m, B),
                  fS=(N2, B), fdX=(n, B), fdY=(m, B), status=(B,))
    for name, t in zip(shapes, args):
        want_dt = torch.int32 if name == 'status' else dtype
        if t.device != S.device or t.dtype != want_dt or tuple(t.shape) != shapes[name] \
                or not t.is_contiguous():
            raise ValueError(
                f'shared_epoch: {name} must be a contiguous {want_dt} tensor of shape '
                f'{shapes[name]} on {S.device}, got {t.dtype} {tuple(t.shape)} on {t.device}'
            )
    n_sm = torch.cuda.get_device_properties(S.device).multi_processor_count
    plan = plan_tile(n, m, B, S.element_size(), n_sm)

    outs = (torch.empty_like(S), torch.empty_like(dX), torch.empty_like(dY),
            torch.empty_like(fS), torch.empty_like(fdX), torch.empty_like(fdY),
            torch.empty_like(status)) + tuple(
        torch.empty(B, dtype=dtype, device=S.device) for _ in range(4))
    scal = np.array([sc.alpha, sc.eps_abs, sc.eps_rel, sc.eps_prim_inf,
                     sc.eps_dual_inf, sc.c, sc.cinv], dtype=np_dtype(dtype))
    stream = torch.cuda.current_stream(S.device).cuda_stream
    global launches
    with torch.cuda.device(S.device):
        err = _lib_fn(dtype)(
            n, m, B, plan.tb, plan.tc, plan.ks, int(sc.K),
            int(not sc.scaled_termination),
            int(sc.check_dualgap),
            scal.ctypes.data, *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in outs), stream,
        )
    launches += 1
    if err != 0:
        raise RuntimeError(f'shared_epoch: CUDA kernel launch failed with error {err}')
    return outs
