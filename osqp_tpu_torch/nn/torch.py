"""Differentiable torch layer with the reference's module API.

Counterpart of ``osqp_tpu/nn/torch.py``: the constructor ``OSQP(P_idx,
P_shape, A_idx, A_shape, eps_rel, eps_abs, verbose, max_iter, algebra,
solver_type)`` and ``forward(P_val, q_val, A_val, l_val, u_val)`` returning
the batch of primal solutions (reference src/osqp/nn/torch.py:22-57).

The batch is densified on the tensors' device and solved there by the vmap
engine (``batch.BatchedOSQP``); the backward pass solves the whole batch's
masked adjoint KKT systems at once (``nn.layer._adjoint_system``).  A CPU
tensor is the caller asking for the CPU: nothing is moved between devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.autograd import Function
from torch.nn import Module

from ..batch import BatchedOSQP
from ..constants import status_string
from ..settings import np_dtype
from .layer import _adjoint_system

# Constructor surface shared with the reference layer (API contract).
_LAYER_OPTS = ('P_idx', 'P_shape', 'A_idx', 'A_shape', 'eps_rel', 'eps_abs',
               'verbose', 'max_iter', 'algebra', 'solver_type')


def _batched_adjoint(refine_iters):
    """The batched adjoint with ``refine_iters`` refinement steps:
    ``f(P, A, l, u, x, y, dx, delta) -> (dP, dq, dA, dl, du)``."""

    def f(P, A, l, u, x, y, dx, delta):
        return _adjoint_system(P, A, l, u, x, y, dx, torch.zeros_like(y), delta, refine_iters)

    return f


def to_numpy(t):
    """Detach a torch tensor to numpy; None passes through, empty -> empty."""
    if t is None:
        return None
    return np.empty(0) if t.nelement() == 0 else t.detach().cpu().numpy()


def _solver_dtype():
    """The solver's precision: float64, native on the CPU and on the H100
    (the JAX package takes float32 on accelerators, where the TPU emulates
    float64).  ``OSQP_TPU_NN_DTYPE=float32|float64`` overrides it."""
    forced = os.environ.get('OSQP_TPU_NN_DTYPE')
    return torch.float32 if forced == 'float32' else torch.float64


class OSQP(Module):
    def __init__(self, P_idx, P_shape, A_idx, A_shape, eps_rel=1e-5,
                 eps_abs=1e-5, verbose=False, max_iter=10000, algebra=None,
                 solver_type='direct'):
        super().__init__()
        cfg = locals()
        for name in _LAYER_OPTS:
            setattr(self, name, cfg[name])

    def forward(self, P_val, q_val, A_val, l_val, u_val):
        fn = _OSQP_Fn(**{name: getattr(self, name) for name in _LAYER_OPTS})
        return fn(P_val, q_val, A_val, l_val, u_val)


def _index(idx, device):
    return tuple(torch.as_tensor(np.asarray(i, np.int64), device=device) for i in idx)


def _OSQP_Fn(P_idx, P_shape, A_idx, A_shape, eps_rel, eps_abs, verbose, max_iter,
             algebra, solver_type):
    m, n = A_shape

    class _OSQP_FnFn(Function):
        @staticmethod
        def forward(ctx, P_val, q_val, A_val, l_val, u_val):
            """Solve a batch of QPs given as pattern values."""
            params = [P_val, q_val, A_val, l_val, u_val]
            for p in params:
                assert p.ndimension() <= 2, 'parameters must be vectors or batches of vectors'
            batch_mode = any(t.ndimension() > 1 for t in params)
            n_batch = max(t.size(0) if t.ndimension() == 2 else 1
                          for t in params) if batch_mode else 1

            dtype = P_val.dtype
            device = P_val.device
            dt = _solver_dtype()

            params = [
                p.unsqueeze(0).expand(n_batch, p.size(0)) if p.ndimension() == 1 else p
                for p in params
            ]
            P_val_b, q_val_b, A_val_b, l_val_b, u_val_b = params
            assert A_val_b.size(1) == len(A_idx[0]), 'A_val length must match the A_idx pattern'
            assert P_val_b.size(1) == len(P_idx[0]), 'P_val length must match the P_idx pattern'

            # densify the batch on its device: one scatter-add per matrix
            # (np.add.at's counterpart: repeated pattern entries add up)
            Pi, Ai = _index(P_idx, device), _index(A_idx, device)
            rows = torch.arange(n_batch, device=device).unsqueeze(-1)
            P_d = torch.zeros((n_batch, n, n), dtype=dt, device=device)
            A_d = torch.zeros((n_batch, m, n), dtype=dt, device=device)
            P_d.index_put_((rows, Pi[0], Pi[1]), P_val_b.detach().to(dt), accumulate=True)
            A_d.index_put_((rows, Ai[0], Ai[1]), A_val_b.detach().to(dt), accumulate=True)
            # symmetrize triu-style input the same way the solver does
            P_sym = torch.triu(P_d) + torch.triu(P_d, 1).mT
            q_d, l_d, u_d = (v.detach().to(dt) for v in (q_val_b, l_val_b, u_val_b))

            solver = BatchedOSQP(dtype=dt, device=device, engine='vmap')
            solver.setup(P_sym, q_d, A_d, l_d, u_d, verbose=verbose, eps_abs=eps_abs,
                         eps_rel=eps_rel, max_iter=max_iter, solver_type=solver_type)
            res = solver._solve_vmap()
            status = to_numpy(res.status)
            for s in status:
                if s != 1:
                    raise RuntimeError(f'Unable to solve QP, status: {status_string(s)}')

            ctx.sol_x, ctx.sol_y = res.x, res.y
            ctx.P_d, ctx.A_d, ctx.l_d, ctx.u_d = P_sym, A_d, l_d, u_d

            x = res.x.to(dtype)
            return x if batch_mode else x.squeeze(0)

        @staticmethod
        def backward(ctx, dl_dx_val):
            # the whole batch's adjoint KKT systems in one batched solve
            dtype = dl_dx_val.dtype
            batch_mode = dl_dx_val.ndimension() == 2
            if not batch_mode:
                dl_dx_val = dl_dx_val.unsqueeze(0)
            dt = ctx.P_d.dtype
            # the same float32 delta floor as make_qp_layer
            delta = np_dtype(dt)(1e-4 if dt == torch.float32 else 1e-9)
            dPs, dq, dA, dl, du = _batched_adjoint(8)(
                ctx.P_d, ctx.A_d, ctx.l_d, ctx.u_d, ctx.sol_x, ctx.sol_y,
                dl_dx_val.detach().to(dt), delta)
            # triu-gradient convention: an off-diagonal pattern entry
            # receives both symmetric halves of the full dP
            dP_full = dPs + dPs.mT
            dP_full = dP_full - torch.diag_embed(torch.diagonal(dPs, dim1=-2, dim2=-1))
            Pi, Ai = _index(P_idx, dPs.device), _index(A_idx, dPs.device)
            grads = [g.to(dtype) for g in (dP_full[:, Pi[0], Pi[1]], dq,
                                           dA[:, Ai[0], Ai[1]], dl, du)]
            if not batch_mode:
                grads = [g.squeeze(0) for g in grads]
            return tuple(grads)

    return _OSQP_FnFn.apply
