"""Differentiable batched QP layer on torch tensors.

Counterpart of ``osqp_tpu/nn/layer.py``: ``make_qp_layer`` returns
``layer(P, q, A, l, u) -> x`` backed by a ``torch.autograd.Function``.  Its
forward pass is the vmap engine's fused solve (``batch.batch_qp_solve``,
rho 0.1); its backward pass applies the adjoint of the active-set KKT system
at the solution as dense masked linear algebra, one batched Cholesky for the
whole batch (``_adjoint_system``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch import batch_qp_solve, default_core_settings
from ..settings import CoreSettings, np_dtype
from ..solver.core_batched import _cho_solve, _mtv, _mv, cholesky


class QPLayerResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor


def _solve_batch_fwd(P, q, A, l, u, settings: CoreSettings, rho):
    res = batch_qp_solve(P, q, A, l, u, settings, rho)
    return QPLayerResult(x=res.x, y=res.y, status=res.status, iters=res.iters)


def _adjoint_system(P, A, l, u, x, y, dx, dy, delta, refine_iters: int):
    """Masked adjoint KKT solve of every instance of the batch.

    Solves ``[[P, A_act'], [A_act, 0]] r = [dx; dy_act]`` through its
    delta-regularized Schur form and ``refine_iters`` steps of iterative
    refinement, for all instances at once: one batched Cholesky of the
    (B, n, n) Schur matrices.  The active set is the polish's rule (ref
    _osqp.py:1719-1720), robust to |y| at solver-tolerance noise on inactive
    rows.  Returns ``(dP, dq, dA, dl, du)``, each with a leading batch axis.
    """
    n = P.shape[-1]
    m = A.shape[-2]
    z = _mv(A, x) if m else x.new_zeros(x.shape[:-1] + (0,))
    low = (z - l) < -y
    upp = (u - z) < y
    active = (low | upp).to(x.dtype)
    A_act = active.unsqueeze(-1) * A
    dy_act = active * dy

    M = P + delta * torch.eye(n, dtype=x.dtype, device=x.device)
    if m:
        M = M + A_act.mT @ (A_act / delta)
    L = cholesky(M)

    def kkt_solve(r1, r2):
        rhs = r1 + _mtv(A_act, r2 / delta) if m else r1
        xs = _cho_solve(L, rhs)
        ys = (_mv(A_act, xs) - r2) / delta if m else r2
        return xs, ys

    r_x, r_nu = kkt_solve(dx, dy_act)
    for _ in range(int(refine_iters)):
        res1 = dx - (_mv(P, r_x) + _mtv(A_act, r_nu) if m else _mv(P, r_x))
        res2 = dy_act - _mv(A_act, r_x) if m else dy_act
        d1, d2 = kkt_solve(res1, res2)
        r_x, r_nu = r_x + d1, r_nu + d2

    dq = -r_x
    dl = torch.where(low, r_nu, 0.0)
    du = torch.where(upp, r_nu, 0.0)
    outer_rx = r_x.unsqueeze(-1) * x.unsqueeze(-2)
    dP = -0.5 * (outer_rx + outer_rx.mT)
    if m:
        dA = -((active * y).unsqueeze(-1) * r_x.unsqueeze(-2)
               + r_nu.unsqueeze(-1) * x.unsqueeze(-2))
    else:
        dA = torch.zeros_like(A)
    return dP, dq, dA, dl, du


def make_qp_layer(settings: CoreSettings | None = None, dtype=torch.float32, delta=None,
                  refine_iters=4, **setting_overrides):
    """Build a differentiable batched QP layer.

    Returns ``layer(P, q, A, l, u) -> x`` where every argument carries a
    leading batch axis; it solves on the arguments' device, and gradients
    flow to every argument.  ``dtype`` is the settings' precision; ``delta``
    the adjoint's regularization (1e-4 at float32, where 1e-6 leaves the
    Schur matrix's float32 Cholesky NaN, and 1e-9 at float64).
    """
    if settings is None:
        settings = default_core_settings(dtype, **setting_overrides)
    if delta is None:
        delta = 1e-4 if dtype == torch.float32 else 1e-9

    class _Layer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, P, q, A, l, u):
            rho = torch.full((P.shape[0],), 0.1, dtype=P.dtype, device=P.device)
            res = _solve_batch_fwd(P, q, A, l, u, settings, rho)
            ctx.save_for_backward(P, A, l, u, res.x, res.y)
            return res.x

        @staticmethod
        def backward(ctx, dx):
            P, A, l, u, x, y = ctx.saved_tensors
            return _adjoint_system(P, A, l, u, x, y, dx, torch.zeros_like(y),
                                   np_dtype(x.dtype)(delta), refine_iters)

    return _Layer.apply
