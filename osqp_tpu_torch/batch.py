"""Batched QP solving on torch tensors: the shared-structure engine.

Counterpart of ``osqp_tpu/batch.py``'s ``BatchedOSQP`` with ``engine='shared'``
(chosen automatically when P and A are unbatched).  The vmap engine for
per-instance P or A is not ported yet.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .batch_shared import settings_scale_q, shared_setup, shared_solve
from .constants import status_string
from .device import resolve_device
from .ops.shared_epoch import iter_halves
from .settings import OracleSettings, core_settings

_VMAP_LATER = ("the vmap engine (per-instance P or A) is not ported yet; it comes in a "
               "later slice of the port.  Pass P and A unbatched for the shared engine")


class BatchedOSQP:
    """Solve a batch of QPs that share ``P`` and ``A``.

    ``P: (n,n)``, ``A: (m,n)`` shared; ``q: (B,n)`` per instance; ``l,u:
    (B,m) | (m,)`` per instance or broadcast.  Runs on CUDA unless ``device`` says
    otherwise; raises when no device is given and CUDA is absent.

    ``fused`` (one fused-epoch kernel launch per epoch), ``compact``
    (``'auto'`` or ``'0'``) and ``iter_prec`` are the JAX package's
    ``OSQP_TPU_FUSED_SHARED``, ``OSQP_TPU_COMPACT`` and
    ``OSQP_TPU_ITER_PRECISION`` as arguments.  ``iter_prec`` sets the
    precision of the ADMM iteration's product: ``'highest'`` (exact, either
    dtype), ``'high'`` (three bfloat16 passes, near float32) or ``'default'``
    (one bfloat16 pass, slower to converge); the last two need
    ``dtype=torch.float32`` and run on the card's tensor cores.  The
    termination check stays at full precision in every mode, so a reduced
    mode may cost iterations but never accepts an unconverged instance.
    """

    def __init__(self, dtype=torch.float64, device=None, engine='auto', *,
                 fused=True, compact='auto', iter_prec='highest'):
        if engine not in ('auto', 'shared', 'vmap'):
            raise ValueError(f"engine must be 'auto', 'shared' or 'vmap', got {engine!r}")
        if engine == 'vmap':
            raise NotImplementedError(_VMAP_LATER)
        iter_halves(iter_prec, dtype)
        self._dtype = dtype
        self._device = resolve_device(device)
        self._pending = {}
        self._engine = None
        self._opts = dict(fused=fused, compact=compact, iter_prec=iter_prec)

    def setup(self, P, q, A, l, u, **settings):
        t0 = time.perf_counter()
        if settings.pop('solver_type', 'direct') != 'direct':
            raise NotImplementedError(
                'the shared engine solves its KKT system directly; the indirect '
                'solver is a later slice of the port')
        self._stg = OracleSettings(**settings)
        P = np.asarray(P, np.float64)
        A = np.asarray(A, np.float64)
        q = np.asarray(q, np.float64)
        if P.ndim != 2 or A.ndim != 2:
            raise NotImplementedError(_VMAP_LATER)
        if q.ndim != 2:
            raise ValueError('cannot infer batch size: pass q as (B, n)')
        self._engine = 'shared'
        n = P.shape[-1]
        m = A.shape[-2]
        B = max(
            q.shape[0],
            np.asarray(l).shape[0] if np.asarray(l).ndim == 2 else 1,
            np.asarray(u).shape[0] if np.asarray(u).ndim == 2 else 1,
        )
        self.B, self.n, self.m = B, n, m

        qb = np.broadcast_to(q, (B, n)).copy()
        lb = np.broadcast_to(np.asarray(l, np.float64), (B, m)).copy()
        ub = np.broadcast_to(np.asarray(u, np.float64), (B, m)).copy()
        (self._sh_P, self._sh_A, self._sh_Q, self._sh_L, self._sh_U,
         self._sh_scal, self._sh_rho, self._sh_Minv, self._sh_M,
         self._sh_rho_vec) = shared_setup(P, A, qb, lb, ub, self._stg,
                                          dtype=self._dtype, device=self._device)
        self._zero_iterates()
        self.setup_time = time.perf_counter() - t0
        return self

    def _zeros(self, rows):
        return torch.zeros((rows, self.B), dtype=self._dtype, device=self._device)

    def _zero_iterates(self):
        self._sh_X = self._zeros(self.n)
        self._sh_Z = self._zeros(self.m)
        self._sh_Y = self._zeros(self.m)

    def _tensor(self, v):
        return torch.tensor(np.asarray(v), dtype=self._dtype, device=self._device)

    def update(self, q=None, l=None, u=None):
        """Stage batched vector updates; applied at the next solve."""
        for name, v in (('q', q), ('l', l), ('u', u)):
            if v is not None:
                dim = self.n if name == 'q' else self.m
                v = np.broadcast_to(np.asarray(v, np.float64), (self.B, dim))
                if name == 'l':
                    v = np.maximum(v, -1e30)
                if name == 'u':
                    v = np.minimum(v, 1e30)
                self._pending[name] = self._tensor(v)

    def warm_start(self, x=None, y=None):
        scal = self._sh_scal
        if x is not None:
            xs = scal.Dinv[:, None] * self._tensor(np.asarray(x, np.float64).T)
            self._sh_X = xs
            self._sh_Z = self._sh_A @ xs
        if y is not None:
            self._sh_Y = scal.c * (scal.Einv[:, None] * self._tensor(np.asarray(y, np.float64).T))

    def solve(self):
        t0 = time.perf_counter()
        stg = core_settings(self._stg, self._dtype)
        scal = self._sh_scal
        if not self._stg.warm_starting:
            self._zero_iterates()
        if 'q' in self._pending:
            self._sh_Q = settings_scale_q(scal, self._pending['q'].T).contiguous()
        if 'l' in self._pending:
            self._sh_L = (scal.E[:, None] * self._pending['l'].T).contiguous()
        if 'u' in self._pending:
            self._sh_U = (scal.E[:, None] * self._pending['u'].T).contiguous()
        self._pending = {}
        out = shared_solve(
            self._sh_P, self._sh_A, self._sh_Q, self._sh_L, self._sh_U,
            scal, stg, self._sh_rho, self._sh_Minv, self._sh_M,
            self._sh_rho_vec, self._sh_X, self._sh_Z, self._sh_Y, **self._opts,
        )
        self._sh_X, self._sh_Z, self._sh_Y = out['X'], out['Z'], out['Y']
        self._sh_rho = out['rho']
        self._sh_rho_vec = out['rho_vec']
        self._sh_Minv, self._sh_M = out['Minv'], out['M']

        def host(t):
            return t.cpu().numpy()

        status_vals = host(out['status'])
        solve_time = time.perf_counter() - t0
        info = SimpleNamespace(
            status_val=status_vals,
            status=[status_string(s) for s in status_vals],
            iter=host(out['iters']),
            obj_val=host(out['obj_val']),
            dual_obj_val=host(out['dual_obj_val']),
            duality_gap=host(out['obj_val'] - out['dual_obj_val']),
            prim_res=host(out['pri_res']),
            dual_res=host(out['dua_res']),
            rho_estimate=float(out['rho']),
            rho_updates=int(out['rho_updates']),
            solve_time=solve_time,
            setup_time=self.setup_time,
            run_time=self.setup_time + solve_time,
        )
        return SimpleNamespace(
            x=host(out['x']),
            y=host(out['y']),
            prim_inf_cert=host(out['prim_inf_cert']),
            dual_inf_cert=host(out['dual_inf_cert']),
            info=info,
        )
