"""Fused shared-structure ADMM epoch: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``osqp_tpu/ops/shared_epoch.py`` (``_body_kernel``, launched by
``shared_body_pallas``).  One call runs one whole epoch of the shared engine
for every batch column:

1. ``K`` affine ADMM iterations ``V = F @ S + c0``, ``Z = clip(V[n:], L, U)``,
   then the y and x relaxation updates (``S = [x; z; y]``, see
   ``osqp_tpu_torch.batch_shared._build_affine``), with the product ``F @ S``
   at the precision ``iter_prec`` names (``ITER_PRECS``);
2. the active-column merge (terminated columns stay frozen);
3. the full per-column termination check: residuals, objective, dual objective
   and gap with its noise floor, both infeasibility certificates and the
   non-convexity guard;
4. capture of newly terminated columns (``fS``, ``fdX``, ``fdY``).

Layout is instance-last, ``(feature, B)``, contiguous.  Nothing is padded:
the kernel masks the ragged batch edge itself.

``iter_prec`` is the JAX kernel's ``iter_mode``: ``'highest'`` an exact
product in the working dtype; ``'high'`` F and S split into bfloat16 hi and lo
halves and ``F_hi S_hi + (F_hi S_lo + F_lo S_hi)``; ``'default'`` one product of
the bfloat16 roundings.  Each bfloat16 product is exact in float32 and summed
in float32, as on the TPU's matrix unit (``iteration_product``, the plain
version's).  ``tc_iteration_product`` sums the same products as Hopper's
tensor cores do (``tc_accumulate``), in the kernel's k order: it gives the
kernel's iterates bit for bit, and the card's checks put it in the plain
version's place where they hold the kernel to that.  The
reduced modes are float32 only, as in the JAX package.  Only the iteration
product changes: the check, residuals and certificates stay at full precision.
On the card ``plan_tile`` picks the kernel's design: the CUDA cores for
'highest'; for the reduced modes ``wgmma`` with the state in registers in an
internal feature order (``wg_positions``) where n and m fit its paddings, else
``mma.sync`` tiles with F's halves streamed.

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
# Iteration-product precisions and the bfloat16 halves each keeps of F and S
# (the kernel's H): 0 is the working dtype's exact product.
ITER_PRECS = {'highest': 0, 'default': 1, 'high': 2}
# Tensor-core tiles (16 rows of V by 8 columns) a warp may own in the reduced
# modes' streamed design (kMaxTiles in csrc/shared_epoch.cu).
_MAX_TILES = 4
# The reduced modes' register-resident design (shared_epoch_kernel_wg): the
# first warpgroup of a block of 256 threads (kWgThreads) iterates 32 batch
# columns (kWgCols, one per thread), and the (XC, YC) it is instantiated
# for: x padded to 8 XC features, z and y each to 8 YC (start_wg).
_WG_THREADS = 256
_WG_COLS = 32
_WG_PAD = (4, 6)
# The tensor cores' float32 accumulation of bfloat16 products (tc_accumulate):
# the k step of one wgmma or mma.sync, and the bits each term keeps below
# the step's largest exponent.
TC_K_STEP = 16
TC_ALIGN_BITS = 25


def iter_halves(iter_prec: str, dtype) -> int:
    """The bfloat16 halves of ``iter_prec`` (``ITER_PRECS``); raises
    ``ValueError`` for an unknown mode, or for a reduced mode in another dtype
    than float32 (the JAX package runs its fused kernel in float32 only)."""
    if iter_prec not in ITER_PRECS:
        raise ValueError(f"iter_prec must be one of {tuple(ITER_PRECS)}, got {iter_prec!r}")
    if iter_prec != 'highest' and dtype != torch.float32:
        raise ValueError(f"iter_prec={iter_prec!r} splits the iteration product into bfloat16 "
                         f"passes and runs in float32 only, got {dtype}")
    return ITER_PRECS[iter_prec]


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
    iter_prec: str = 'highest'


def epoch_scalars(settings, c, cinv, K: int, iter_prec: str = 'highest') -> EpochScalars:
    return EpochScalars(
        alpha=settings.alpha, eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        eps_prim_inf=settings.eps_prim_inf, eps_dual_inf=settings.eps_dual_inf,
        c=c, cinv=cinv, K=int(K),
        scaled_termination=bool(settings.scaled_termination),
        check_dualgap=bool(settings.check_dualgap), iter_prec=iter_prec,
    )


def _bf16(X):
    """``X`` rounded to bfloat16 (to nearest even, as ``astype``) and back."""
    return X.to(torch.bfloat16).to(X.dtype)


def _split(X):
    """The bfloat16 hi and lo halves of ``X``, as values of its dtype."""
    hi = _bf16(X)
    return hi, _bf16(X - hi)


def tc_k_order(n: int, m: int, halves: int) -> np.ndarray:
    """The order in which the kernel's reduced modes sum over the features
    of S, in whole k steps of ``TC_K_STEP`` (-1 for a padding feature): the
    wgmma design's internal order (``wg_positions``) where it runs, else
    the natural order (the streamed ``mma.sync`` design)."""
    N2 = n + 2 * m
    if _wg_plan(n, m, halves, 4) is not None:
        s_pos, _, n_s, _ = wg_positions(n, m, *_WG_PAD)
        order = np.full(n_s, -1)
        order[s_pos] = np.arange(N2)
        return order
    return np.concatenate([np.arange(N2), np.full(-N2 % TC_K_STEP, -1)])


def _exponent(X):
    """floor(log2 |X|) as float64, and -4096 for a zero."""
    _, e = torch.frexp(X)
    return torch.where(X != 0, (e - 1).to(torch.float64), -4096.0)


def _pow2(e):
    """2^e for integer-valued float64 ``e`` in the normal range, built from
    its bits (torch.pow and exp2 need not be exact on the card)."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _to_f32_toward_zero(s):
    r = s.to(torch.float32)
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def tc_accumulate(steps, R: int, C: int, device):
    """``sum_t A_t @ B_t`` over the k steps ``(A_t (R, g), B_t (g, C))`` of
    bfloat16 values, as Hopper's tensor cores accumulate it in float32
    (wgmma and mma.sync): each step adds its products, exact, to the
    accumulator, every term cut toward zero to a multiple of 2^(e - 25),
    e the largest of the accumulator's exponent and the products' exponent
    sums, and rounds the exact sum toward zero to float32.  Measured on an
    H100 against K1's reduced modes, bit for bit (PERF.md, section 6).
    Returns the float32 (R, C) result."""
    acc = torch.zeros((R, C), dtype=torch.float64, device=device)
    for A, B in steps:
        a, b = A.double(), B.double().T
        prod = a[:, None, :] * b[None, :, :]
        e = torch.where(prod != 0, _exponent(a)[:, None, :] + _exponent(b)[None, :, :], -4096.0)
        emax = torch.maximum(e.amax(dim=-1), _exponent(acc)).clamp(min=-990.0)
        q = _pow2(emax - TC_ALIGN_BITS)
        s = torch.trunc(acc / q) * q + (torch.trunc(prod / q[..., None]) * q[..., None]).sum(-1)
        acc = _to_f32_toward_zero(s).double()
    return acc.float()


def iteration_product(F, iter_prec: str = 'highest'):
    """The function ``S -> F @ S`` at the precision ``iter_prec`` names, as
    ``_body_kernel``'s ``iter_mm`` computes it.  The bfloat16 operands are cast
    back to the working dtype before each product: a torch product of
    bfloat16 tensors rounds its result to bfloat16, which the TPU does not."""
    iter_halves(iter_prec, F.dtype)
    if iter_prec == 'high':
        F_hi, F_lo = _split(F)

        def product(S):
            S_hi, S_lo = _split(S)
            return F_hi @ S_hi + (F_hi @ S_lo + F_lo @ S_hi)
        return product
    if iter_prec == 'default':
        F_b = _bf16(F)
        return lambda S: F_b @ _bf16(S)
    return lambda S: F @ S


def tc_iteration_product(F, iter_prec: str = 'highest'):
    """``iteration_product`` with the reduced modes' bfloat16 products
    summed as K1 sums them on Hopper's tensor cores (``tc_accumulate``, in
    the kernel's k order ``tc_k_order``): 'default' one accumulation of the
    bfloat16 products, 'high' the hi products in one accumulator and the two
    cross products in another, k step by k step, F_hi S_lo then F_lo S_hi,
    added in float32.  It gives the kernel's iterates bit for bit; the
    card's checks put it in ``iteration_product``'s place.  'highest' is
    ``iteration_product``'s."""
    halves = iter_halves(iter_prec, F.dtype)
    if not halves:
        return iteration_product(F, iter_prec)
    if iter_prec == 'high':
        F_hi, F_lo = _split(F)
    else:
        F_b = _bf16(F)
    R, N2 = F.shape
    m = N2 - R
    order = tc_k_order(R - m, m, halves) if 0 <= m <= R else np.arange(N2)
    k_steps = [torch.as_tensor(order[t:t + TC_K_STEP], device=F.device)
               for t in range(0, len(order), TC_K_STEP)]

    def steps(Fh, Sh):  # (F[:, ks], S[ks]) a k step, zero where ks is padding
        return [(torch.where(ks[None, :] >= 0, Fh[:, ks.clamp(min=0)], 0.0),
                 torch.where(ks[:, None] >= 0, Sh[ks.clamp(min=0)], 0.0)) for ks in k_steps]

    def product(S):
        C = S.shape[1]
        if iter_prec == 'default':
            return tc_accumulate(steps(F_b, _bf16(S)), R, C, F.device)
        S_hi, S_lo = _split(S)
        hh = tc_accumulate(steps(F_hi, S_hi), R, C, F.device)
        cross = zip(steps(F_hi, S_lo), steps(F_lo, S_hi))  # interleaved k step by k step
        cx = tc_accumulate([pair for k_step in cross for pair in k_step], R, C, F.device)
        return hh + cx
    return product


def affine_iterations(F, c0, rho_vec, rho_inv, L, U, S, dX, dY, alpha, K: int,
                      iter_prec: str = 'highest'):
    """``K`` ADMM iterations in affine form (``_build_affine``), the product
    at the precision ``iter_prec`` names: returns the new stacked state and
    the last iteration's deltas ``(S, dX, dY)``."""
    n = c0.shape[0] - L.shape[0]
    m = L.shape[0]
    rho = rho_vec[:, None]
    rhoinv = rho_inv[:, None]
    one_m_alpha = type(alpha)(1) - alpha
    product = iteration_product(F, iter_prec)
    for _ in range(K):
        X = S[:n]
        Y = S[n + m:]
        V = product(S) + c0
        Xt = V[:n]
        Pz = V[n:]
        Zn = torch.minimum(torch.maximum(Pz, L), U)
        Yn = Y + rho * (Pz - rhoinv * Y - Zn)
        Xn = alpha * Xt + one_m_alpha * X
        S = torch.cat([Xn, Zn, Yn], dim=0)
        dX = Xn - X
        dY = Yn - Y
    return S, dX, dY


def ordered_product(W, S):
    """``W @ S`` summed over k in increasing order, each product and each
    sum rounded on its own: the check's products as the kernel computes them
    (``tile_product<T, TC, true>``)."""
    acc = W.new_zeros((W.shape[0], S.shape[1]))
    for k in range(W.shape[1]):
        acc = acc + W[:, k, None] * S[k]
    return acc


def ordered_sum(V):
    """Column sums of ``V`` over its rows in increasing order, each addition
    rounded on its own: the check's sums as the kernel computes them."""
    acc = V.new_zeros(V.shape[1:])
    for row in V:
        acc = acc + row
    return acc


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
    Sn, dXn, dYn = affine_iterations(F, c0, rho_vec, rho_inv, L, U, S, dX, dY, alpha, sc.K,
                                     sc.iter_prec)

    # ---- 2. merge: terminated columns stay frozen ----
    active = (status == UNSOLVED)[None]
    S = torch.where(active, Sn, S)
    dX = torch.where(active, dXn, dX)
    dY = torch.where(active, dYn, dY)
    X = S[:n]
    Z = S[n:n + m]
    Y = S[n + m:]

    # ---- 3. termination check ----
    # Every product and sum below runs in the kernel's order, each operation
    # rounded on its own (ordered_product, ordered_sum; the kernel's mul_rn
    # and add_rn), so that status, obj and dobj equal the kernel's bit for
    # bit on the same iterates.
    def colmax(V):
        return V.abs().amax(dim=0)

    def dscale(V):
        return colmax(Dinv[:, None] * V) if unscaled else colmax(V)

    Einv_c = Einv[:, None]
    PAX = ordered_product(CH, X)
    PX = PAX[:n]
    AX = PAX[n:]
    AtY = ordered_product(At, Y)

    pri_vec = AX - Z
    pri = colmax(Einv_c * pri_vec) if unscaled else colmax(pri_vec)
    dua_vec = PX + Q + AtY
    dua = cinv * colmax(Dinv[:, None] * dua_vec) if unscaled else colmax(dua_vec)

    quad = 0.5 * ordered_sum(X * PX)
    qx = ordered_sum(Q * X)
    obj = (quad + qx) * cinv
    noncvx_neg = (quad * cinv) < (f(-1e-12) * torch.clamp(ordered_sum(X * X), min=1.0))
    pri = torch.where(noncvx_neg, f(2 * OSQP_INFTY), pri)

    Yu = cinv * (E[:, None] * Y)
    y_tol = eps * Yu.abs().amax(dim=0, keepdim=True)
    Yu = torch.where(Yu.abs() > y_tol, Yu, 0.0)
    Lu = Einv_c * L
    Uu = Einv_c * U
    sup_pos = torch.where(Uu < loose, Uu * torch.clamp(Yu, min=0.0), 0.0)
    sup_neg = torch.where(Lu > -loose, Lu * torch.clamp(Yu, max=0.0), 0.0)
    sup = ordered_sum(sup_pos) + ordered_sum(sup_neg)
    sup_mag = ordered_sum(sup_pos.abs()) + ordered_sum(sup_neg.abs())
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
    lhs = ordered_sum(U * torch.clamp(dY, min=0.0) + L * torch.clamp(dY, max=0.0))
    AtdY_n = dscale(ordered_product(At, dY))
    pinf = (norm_dY > eps_pinf) & (lhs < -eps_pinf * norm_dY) & (AtdY_n < eps_pinf * norm_dY)
    pinf = pinf & ~pri_check

    # dual infeasibility certificate
    PAdX = ordered_product(CH, dX)
    PdX = PAdX[:n]
    AdX = PAdX[n:]
    norm_dX = colmax(D[:, None] * dX) if unscaled else colmax(dX)
    cost_scale = c if unscaled else f(1)
    dinf = norm_dX > eps_dinf
    dinf &= ordered_sum(Q * dX) < (-cost_scale * eps_dinf * norm_dX)
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
    ``V = F S`` (of the check's products, in the reduced modes), and F' staged
    ``ks`` rows of k at a time: all of it once per epoch (F resident,
    ``ks = n + 2m``) or in slabs in every iteration.  ``design`` names the
    iterations' code: ``'cuda_cores'`` ('highest'), ``'wgmma'`` (the reduced
    modes with the state in registers; ``xc``, ``yc`` its padding, see
    ``wg_positions``) or ``'mma_sync'`` (the reduced modes where that does not
    fit: F's halves streamed).  The block's shared memory is
    ``smem_bytes(n, m, tb, ks, itemsize, halves)``, or
    ``wg_smem_bytes(n, m, halves, xc, yc, tb)`` for ``'wgmma'``."""

    tb: int
    threads: int
    tc: int
    ks: int
    design: str = 'cuda_cores'
    xc: int = 0
    yc: int = 0


def w_stride(nm: int, itemsize: int) -> int:
    """Row stride (elements) of F' in shared memory: ``nm`` rounded up to 4,
    then to 16 bytes past a multiple of 128 bytes (``w_stride`` in the .cu
    source)."""
    r4 = -(-nm // 4) * 4
    mod, want = 128 // itemsize, 16 // itemsize
    return r4 + (want - r4 % mod) % mod


def bf16_words(k: int) -> int:
    """Row stride, in 32-bit words, of a bfloat16 matrix of ``k`` columns in
    shared memory: ``k`` rounded up to 16, plus 8 bfloat16 (``bf16_words`` in
    the .cu source)."""
    return -(-k // 16) * 8 + 4


def smem_bytes(n: int, m: int, tb: int, ks: int, itemsize: int, halves: int = 0) -> int:
    """Dynamic shared memory of one block: the ``Layout`` of the .cu source
    (F' staged ``ks`` rows deep, or in the reduced modes F's ``halves``
    bfloat16 halves, row-major, whichever is larger; the state S, dX, dY; V
    and T of the check; the epoch-constant c0, L, U, Q and rho, 1/rho; 16
    partial results per column of the check; the state's bfloat16 halves),
    each region rounded up to 16 bytes."""
    nm, N2 = n + m, n + 2 * m
    mp = -(-nm // 16) * 16
    sizes = (max(ks * w_stride(nm, itemsize), halves * mp * bf16_words(ks)),
             N2 * tb, nm * tb, n * tb, n * tb, m * tb,
             nm * tb, m * tb, m * tb, n * tb, m, m, 16 * tb, halves * tb * bf16_words(N2))
    align = 16 // itemsize
    return sum(-(-s // align) * align for s in sizes) * itemsize


def wg_positions(n: int, m: int, xc: int, yc: int):
    """The wgmma design's internal feature order (``wg_orig`` in the .cu
    source): the positions of the features of ``S = [x; z; y]`` among the
    kernel's ``n_s`` state features and of ``V = [x~; Pz]`` among its ``n_v``
    product features.  x_i sits at i, z_j at 8 xc + j, y_j at 8 (xc + yc) + j;
    x~_i and Pz_j where x_i and z_j do.  A thread holds features
    8 c + 2 tig + {0, 1} of every chunk c of 8, so Pz_j, z_j and y_j, 8 yc
    apart, fall in one position of its fragments.  ``n_v = 8 (xc + yc)`` is
    wgmma's N; ``n_s`` is 8 (xc + 2 yc) rounded up to whole k steps of 16.
    Returns ``(s_pos, v_pos, n_s, n_v)``; raises ``ValueError`` where x or z
    does not fit its padding."""
    if not (0 <= n <= 8 * xc and 0 <= m <= 8 * yc):
        raise ValueError(f'wg_positions: n={n}, m={m} exceed 8 xc = {8 * xc}, 8 yc = {8 * yc}')
    s_pos = np.concatenate([np.arange(n), 8 * xc + np.arange(m), 8 * (xc + yc) + np.arange(m)])
    return s_pos, s_pos[:n + m], 16 * (-(-(xc + 2 * yc) // 2)), 8 * (xc + yc)


def wg_smem_bytes(n: int, m: int, halves: int, xc: int, yc: int, tb: int) -> int:
    """Dynamic shared memory of one block of ``tb`` columns in the wgmma
    design: the ``WgLayout`` of the .cu source (F's ``halves`` bfloat16
    halves in wgmma's layout or the check's [P; A]' and A'', whichever is
    larger; the state S, V, T of the check (V first holds c0), dX, dY, L, U,
    Q; 16 partial results per column; rho and 1/rho in z's internal order;
    c0, L and U in fragment order), each region rounded up to 16 bytes."""
    nm, N2 = n + m, n + 2 * m
    nv, kt = xc + yc, -(-(xc + 2 * yc) // 2)
    sizes = (max(halves * kt * nv * 64, nm * w_stride(nm, 4)),
             N2 * tb, nm * tb, n * tb, n * tb, m * tb, m * tb, m * tb, n * tb, 16 * tb,
             16 * yc, nv * 8 * tb, yc * 16 * tb)
    return sum(-(-s // 4) * 4 for s in sizes) * 4


def _wg_plan(n: int, m: int, halves: int, itemsize: int):
    """The wgmma design's plan, or None where it does not run (float64,
    'highest', or n and m past the instantiated padding): 32 columns per
    block, one per iterating thread, at every batch size; shared memory
    within the limit."""
    xc, yc = _WG_PAD
    if itemsize != 4 or not halves or n > 8 * xc or m > 8 * yc:
        return None
    if wg_smem_bytes(n, m, halves, xc, yc, _WG_COLS) > _SMEM_LIMIT:
        return None
    return TilePlan(_WG_COLS, _WG_THREADS, 2, n + 2 * m, 'wgmma', xc, yc)


def make_plan(n: int, m: int, tb: int, tc: int, itemsize: int, halves: int = 0) -> TilePlan:
    """The plan for a given block width and micro-tile: F resident when it
    fits beside the tiles, else the deepest slab (a multiple of 8 rows of k,
    of 16 in the reduced modes) that does.  Raises ``ValueError`` when not
    even the shallowest slab fits, or when the kernel cannot run the plan
    (more than 384 threads, fewer threads than batch columns; in the reduced
    modes float32, at least 8 columns and at most 4 tensor-core tiles per
    warp, the threads rounded up to whole warps)."""
    N2 = n + 2 * m
    threads = -(-(n + m) // _ROWS) * (tb // tc)
    if halves:
        threads = -(-threads // 32) * 32
        tiles = -(-(n + m) // 16) * (tb // 8)
        if itemsize != 4 or tb < 8 or -(-tiles // (threads // 32)) > _MAX_TILES:
            raise ValueError(f'shared_epoch: the reduced modes run float32 tiles of 8 to 32 '
                             f'columns with at most {_MAX_TILES} tensor-core tiles per warp; '
                             f'{tb} columns in {threads} threads do not')
    if not (tc <= tb and tb <= threads <= _MAX_THREADS):
        raise ValueError(f'shared_epoch: {tb} columns per block in micro-tiles {_ROWS} x {tc} '
                         f'take {threads} threads; the kernel runs {tb} to {_MAX_THREADS}')
    if smem_bytes(n, m, tb, N2, itemsize, halves) <= _SMEM_LIMIT:
        ks = N2
    elif halves:
        ks = (N2 - 1) // 16 * 16
        while ks >= 16 and smem_bytes(n, m, tb, ks, itemsize, halves) > _SMEM_LIMIT:
            ks -= 16
        if ks < 16:
            raise ValueError(
                f'shared_epoch: n={n}, m={m} needs {smem_bytes(n, m, tb, 16, itemsize, halves)} '
                f'bytes of shared memory at {tb} batch columns per block (limit {_SMEM_LIMIT})')
    else:
        per_k = w_stride(n + m, itemsize) * itemsize
        ks = (_SMEM_LIMIT - smem_bytes(n, m, tb, 0, itemsize)) // per_k // 8 * 8
        if ks < 8:
            raise ValueError(
                f'shared_epoch: n={n}, m={m} needs {smem_bytes(n, m, tb, 8, itemsize)} bytes '
                f'of shared memory at {tb} batch columns per block (limit {_SMEM_LIMIT})')
    return TilePlan(tb, threads, tc, ks, 'mma_sync' if halves else 'cuda_cores')


@functools.lru_cache(maxsize=64)
def plan_tile(n: int, m: int, B: int, itemsize: int, n_sm: int, halves: int = 0) -> TilePlan:
    """The kernel's plan.  The reduced modes take the wgmma design where its
    padding holds n and m and its shared memory fits (``_wg_plan``);
    otherwise, and in 'highest', ``block_plan``."""
    wg = _wg_plan(n, m, halves, itemsize)
    return wg if wg is not None else block_plan(n, m, B, itemsize, n_sm, halves)


def block_plan(n: int, m: int, B: int, itemsize: int, n_sm: int, halves: int = 0) -> TilePlan:
    """The plan of the CUDA-core design ('highest') and of the streamed
    ``mma.sync`` design (the reduced modes).  Block width: the power of two
    up to 32 (at least 8 in the reduced modes, whose tensor-core tiles are 8
    columns wide) whose tile fits and that least loads the busiest SM (its
    blocks times each block's columns plus a fixed cost per block), the
    wider one on a tie.  Micro-tile columns: 2 where that still gives the
    block at least eight warps, else 1.  Threads stay within the kernel's
    384, and at least one per batch column of the tile (the check's column
    loops)."""
    n_groups = -(-(n + m) // _ROWS)
    widths = (32, 16, 8) if halves else (32, 16, 8, 4, 2, 1)
    least = smem_bytes(n, m, widths[-1], 16 if halves else 8, itemsize, halves)
    if least > _SMEM_LIMIT:
        raise ValueError(
            f'shared_epoch: n={n}, m={m} needs {least} bytes of shared memory even at '
            f'{widths[-1]} batch columns per block (limit {_SMEM_LIMIT})')
    if n_groups > _MAX_THREADS:
        raise ValueError(f'shared_epoch: n + m = {n + m} exceeds {_ROWS * _MAX_THREADS} '
                         f'(one {_ROWS}-row micro-tile per thread, {_MAX_THREADS} threads)')
    plans = []
    for tb in widths:
        runnable = []
        for tc in (2, 1):
            try:
                runnable.append(make_plan(n, m, tb, tc, itemsize, halves))
            except ValueError:  # TB = 1, TC = 1 always runs (checked above)
                continue
        if runnable:
            plans.append(next((p for p in runnable if p.threads >= 256), runnable[-1]))
    if not plans:
        raise ValueError(f'shared_epoch: no plan of the reduced modes runs n={n}, m={m}')

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
        fn.argtypes = [ci] * 12 + [vp] * 33
        fn.restype = ci
    return fn


def shared_epoch(F, CH, At, rho_vec, rho_inv, D, Dinv, E, Einv,
                 c0, Q, L, U, S, dX, dY, fS, fdX, fdY, status,
                 sc: EpochScalars):
    """One fused epoch.  CUDA tensors: one launch of the Hopper kernel in
    ``csrc/shared_epoch.cu`` on the current stream, whose iteration product
    runs on the tensor cores in the reduced modes of ``sc.iter_prec`` (the
    design ``plan_tile`` picks).  CPU tensors: the plain version.  Returns
    ``(S, dX, dY, fS, fdX, fdY, status, pri, dua, obj, dobj)``; the inputs
    are not modified."""
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
    halves = iter_halves(sc.iter_prec, dtype)
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
    plan = plan_tile(n, m, B, S.element_size(), n_sm, halves)

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
            n, m, B, plan.tb, plan.tc, plan.ks, halves, plan.xc, plan.yc, int(sc.K),
            int(not sc.scaled_termination),
            int(sc.check_dualgap),
            scal.ctypes.data, *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in outs), stream,
        )
    launches += 1
    if err != 0:
        raise RuntimeError(f'shared_epoch: CUDA kernel launch failed with error {err}')
    return outs
