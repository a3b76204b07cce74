"""A plain primal-dual interior-point solve of batches of convex QPs.

    minimize 1/2 x'Px + q'x  subject to  l <= Ax <= u

P (n, n) and A (m, n) are dense and shared by the batch; q (B, n), l and u
(B, m) are per instance.  Rows with l == u are equalities; every other finite
bound is an inequality with its own slack; infinite bounds are dropped.  The
pattern of equalities and finite bounds must be the batch's first instance's
in every instance.

Mehrotra's predictor-corrector on the augmented system

    [P + G'WG   E'] [dx]   [-r_d + G'((r_c - lam r_p) / s)]
    [E          0 ] [dnu] = [-r_e                          ]

with G = [A_upper; -A_lower], W = lam / s, factored once a step (``_factor``)
and solved twice.  The multipliers are returned in the
convention of the solver under test: P x + q + A'y = 0, y > 0 where the
upper bound holds, y < 0 where the lower bound holds.

Every matrix product goes through ``Precision.mm``, so the same code runs in
float64 (the reference), float32, or float32 with TF32 products (the
controls: operands rounded to TF32's 10-bit mantissa before each product).
Imports nothing of the system under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SOLVED = 1
MAX_ITER_REACHED = -2


@dataclass(frozen=True)
class Precision:
    """The working precision: ``'float64'``, ``'float32'`` or ``'tf32'``
    (float32 storage, products on TF32-rounded operands)."""

    name: str = 'float64'

    def __post_init__(self):
        if self.name not in ('float64', 'float32', 'tf32'):
            raise ValueError(f'unknown precision {self.name!r}')

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == 'float64' else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == 'tf32':
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), as the tensor cores read a TF32 operand."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


@dataclass
class Result:
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    status: torch.Tensor  # (B,) int: SOLVED or MAX_ITER_REACHED
    iters: torch.Tensor  # (B,) Newton steps taken
    obj_val: torch.Tensor  # (B,) 1/2 x'Px + q'x, in the working precision
    dual_res: torch.Tensor  # (B,) ||Px + q + A'y||_inf, in the working precision


def _bmv(prec: Precision, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` (B, k) times M' for a shared M (r, k): (B, r)."""
    return prec.mm(v, M.T)


def _factor(prec: Precision, H, E):
    """A solver of [[H, E'], [E, 0]] [dx; dnu] = [r1; r2] for a batch of H
    (B, n, n): by H's Cholesky factor and the Schur complement E H^-1 E' where
    every H is positive definite, else by an LU with partial pivoting of the
    whole matrix.  A factorization that breaks down leaves non-finite steps,
    which stop the instance."""
    B, n, _ = H.shape
    me = E.shape[0]
    Lh, info = torch.linalg.cholesky_ex(H)
    if bool((info == 0).all()):
        if not me:
            return lambda r1, r2: (torch.cholesky_solve(r1.unsqueeze(-1), Lh).squeeze(-1), r2)
        HiEt = torch.cholesky_solve(E.T.expand(B, n, me).contiguous(), Lh)
        LUs, pivs, _ = torch.linalg.lu_factor_ex(prec.mm(E, HiEt))

        def schur(r1, r2):
            h = torch.cholesky_solve(r1.unsqueeze(-1), Lh)
            dnu = torch.linalg.lu_solve(LUs, pivs, prec.mm(E, h) - r2.unsqueeze(-1))
            return (h - prec.mm(HiEt, dnu)).squeeze(-1), dnu.squeeze(-1)
        return schur
    K = torch.zeros((B, n + me, n + me), dtype=H.dtype, device=H.device)
    K[:, :n, :n] = H
    K[:, :n, n:] = E.T
    K[:, n:, :n] = E
    LU, piv, _ = torch.linalg.lu_factor_ex(K)

    def whole(r1, r2):
        sol = torch.linalg.lu_solve(LU, piv, torch.cat([r1, r2], 1).unsqueeze(-1)).squeeze(-1)
        return sol[:, :n], sol[:, n:]
    return whole


def solve(P, A, q, l, u, prec: Precision = Precision(), tol: float = 1e-9,
          max_iter: int = 60) -> Result:
    """Solve the batch; tensors on one device, any float dtype (cast to the
    working precision).  An instance that meets ``tol`` stops moving; one
    that does not within ``max_iter`` steps ends MAX_ITER_REACHED."""
    dt = prec.dtype
    P, A, q, l, u = (t.to(dt) for t in (P, A, q, l, u))
    B, n = q.shape
    big = 1e19
    eq = (l[0] == u[0])
    up = (u[0] < big) & ~eq
    lo = (l[0] > -big) & ~eq
    for name, mask, v in (('equality', eq, l == u), ('upper', up, (u < big) & ~(l == u)),
                          ('lower', lo, (l > -big) & ~(l == u))):
        if not torch.equal(v, mask.expand_as(v)):
            raise ValueError(f'the {name} rows differ between instances')
    E, Au, Al = A[eq], A[up], A[lo]
    b, hu, hl = l[:, eq], u[:, up], l[:, lo]
    me, mu_, ml = E.shape[0], Au.shape[0], Al.shape[0]
    mi = mu_ + ml
    # G = [Au; -Al], h = [hu; -hl]
    G = torch.cat([Au, -Al])
    h = torch.cat([hu, -hl], dim=1)

    x = torch.zeros((B, n), dtype=dt, device=q.device)
    nu = torch.zeros((B, me), dtype=dt, device=q.device)
    s = torch.ones((B, mi), dtype=dt, device=q.device)
    lam = torch.ones((B, mi), dtype=dt, device=q.device)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    # an instance whose step is not finite (the system has run out of the
    # precision's digits) stops where it is, unsolved
    stalled = torch.zeros(B, dtype=torch.bool, device=q.device)
    iters = torch.zeros(B, dtype=torch.int64, device=q.device)
    scale_q = q.abs().amax(1)
    scale_b = b.abs().amax(1) if me else torch.zeros(B, dtype=dt, device=q.device)
    scale_h = h.abs().amax(1) if mi else torch.zeros(B, dtype=dt, device=q.device)

    def residuals(x, nu, s, lam):
        Px = _bmv(prec, P, x)
        At = _bmv(prec, E.T, nu) + _bmv(prec, G.T, lam)
        rd = Px + q + At
        re = _bmv(prec, E, x) - b
        rp = _bmv(prec, G, x) + s - h
        return rd, re, rp, Px, At

    def step_to_boundary(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float('inf')))
        return ratio.amin(1).clamp(max=1.0) if v.shape[1] else torch.ones(B, dtype=dt,
                                                                          device=v.device)

    for _ in range(max_iter):
        rd, re, rp, Px, At = residuals(x, nu, s, lam)
        mu = (s * lam).sum(1) / max(mi, 1)
        obj = 0.5 * (x * Px).sum(1) + (q * x).sum(1)
        conv = ((rd.abs().amax(1) <= tol * (1 + torch.maximum(torch.maximum(
                    Px.abs().amax(1), At.abs().amax(1)), scale_q)))
                & ((re.abs().amax(1) if me else 0) <= tol * (1 + scale_b))
                & ((rp.abs().amax(1) if mi else 0) <= tol * (1 + scale_h))
                & (mu <= tol * (1 + obj.abs())))
        done = done | (conv & ~stalled)
        halt = done | stalled
        if bool(halt.all()):
            break
        iters = iters + (~halt).long()
        W = lam / s
        # a finished instance no longer moves: keep its (ill-conditioned)
        # system out of the factorization
        H = P + prec.mm(G.T * W[:, None, :], G)
        H = torch.where(halt[:, None, None], torch.eye(n, dtype=dt, device=q.device), H)
        kkt = _factor(prec, H, E)

        def newton(rc):
            r1 = -rd + _bmv(prec, G.T, (rc - lam * rp) / s)
            dx, dnu = kkt(r1, -re)
            ds = -rp - _bmv(prec, G, dx)
            dlam = (-rc - lam * ds) / s
            return dx, dnu, ds, dlam

        dx, dnu, ds, dlam = newton(s * lam)
        a_aff = torch.minimum(step_to_boundary(s, ds), step_to_boundary(lam, dlam))
        mu_aff = ((s + a_aff[:, None] * ds) * (lam + a_aff[:, None] * dlam)).sum(1) / max(mi, 1)
        sigma = (mu_aff / mu.clamp(min=torch.finfo(dt).tiny)) ** 3
        dx, dnu, ds, dlam = newton(s * lam + ds * dlam - (sigma * mu)[:, None])
        alpha = 0.99 * torch.minimum(step_to_boundary(s, ds), step_to_boundary(lam, dlam))
        alpha = alpha.clamp(max=1.0)[:, None]
        finite = torch.stack([torch.isfinite(v).all(1) for v in (dx, dnu, ds, dlam, alpha)]).all(0)
        stalled = stalled | (~halt & ~finite)
        keep = (halt | ~finite)[:, None]
        x = torch.where(keep, x, x + alpha * dx)
        nu = torch.where(keep, nu, nu + alpha * dnu)
        s = torch.where(keep, s, s + alpha * ds)
        lam = torch.where(keep, lam, lam + alpha * dlam)

    y = torch.zeros((B, A.shape[0]), dtype=dt, device=q.device)
    y[:, eq] = nu
    y[:, up] += lam[:, :mu_]
    y[:, lo] -= lam[:, mu_:]
    Px = _bmv(prec, P, x)
    obj = 0.5 * (x * Px).sum(1) + (q * x).sum(1)
    dual_res = (Px + q + _bmv(prec, A.T, y)).abs().amax(1)
    status = torch.where(done, SOLVED, MAX_ITER_REACHED)
    return Result(x=x, y=y, status=status, iters=iters, obj_val=obj, dual_res=dual_res)
