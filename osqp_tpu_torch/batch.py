"""Batched QP solving on torch tensors: the vmap and shared-structure engines.

Counterpart of ``osqp_tpu/batch.py``.  The vmap engine solves a batch whose
instances each have their own P and A: ``_setup_batch`` (Ruiz scaling,
constraint typing and factorization of every instance), ``_solve_batch``
(the batched ADMM loop of ``solver.core_batched``),
``_update_and_solve_batch`` (the MPC step: rescale the new vectors, retype
the constraints, refactorize, solve), and on top of them the pure entry
points ``batch_qp_solve`` and ``mpc_rollout``.  ``BatchedOSQP`` takes the
vmap engine when P or A carries a batch axis and the shared-structure engine
(``batch_shared``) when both are shared.
"""

from __future__ import annotations

import itertools
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import tracing
from .batch_shared import settings_scale_q, shared_setup, shared_solve
from .constants import LinsysSolverType, status_strings
from .device import resolve_device
from .ops.shared_epoch import iter_halves
from .settings import CoreSettings, OracleSettings, core_settings
from .settings import default_core_settings  # noqa: F401  (osqp_tpu.batch's name)
from .solver import core_batched as core


@torch.no_grad()
def _setup_batch(P, q, A, l, u, rho, settings: CoreSettings, scaling_iters: int,
                 indirect: bool, kkt_method: str = 'chol'):
    """Scale, type constraints and factorize every instance.  Returns
    ``(QPData, Scaling, RhoState, Factor)`` of the batch."""
    B, n = q.shape
    m = A.shape[-2]
    if scaling_iters > 0:
        data, scal = core.ruiz_scale(P, q, A, l, u, scaling_iters)
    else:
        data = core.QPData(P=P, q=q, A=A, l=l, u=u)
        scal = core.identity_scaling(B, n, m, P.dtype, P.device)
    rho_state = core.make_rho_state(data.l, data.u, rho, settings.rho_is_vec)
    if indirect:
        factor = core.Factor(L=None, diag=core.build_M_diag(data.P, data.A, settings.sigma,
                                                            rho_state.rho_vec), Minv=None)
    else:
        factor = core.factorize(data.P, data.A, settings.sigma, rho_state.rho_vec, kkt_method)
    return data, scal, rho_state, factor


@torch.no_grad()
def _solve_batch(data, scal, settings: CoreSettings, rho, factor, iterates, indirect: bool,
                 kkt_method: str = 'chol') -> core.SolveResult:
    return core.solve_scaled_impl(data, scal, settings, rho, factor, iterates,
                                  indirect=indirect, kkt_method=kkt_method)


@torch.no_grad()
def _update_and_solve_batch(data, scal, settings: CoreSettings, rho, factor, iterates,
                            q_new, l_new, u_new, has_q: bool, has_l: bool, has_u: bool,
                            indirect: bool, kkt_method: str = 'chol'):
    """The MPC step: rescale the new vectors with each instance's own scaling,
    retype the constraints and rebuild rho_vec at each instance's current
    rho, refactorize (always, as the JAX package does), solve.  Returns
    ``(SolveResult, QPData)``."""
    q = scal.c.unsqueeze(-1) * (scal.D * q_new) if has_q else data.q
    l = scal.E * l_new if has_l else data.l
    u = scal.E * u_new if has_u else data.u
    data = data._replace(q=q, l=l, u=u)
    types = core.constraint_types(data.l, data.u)
    vec = core.rho_vec_from_types(types, rho.rho, settings.rho_is_vec)
    rho = core.RhoState(rho=rho.rho, rho_vec=vec,
                        rho_inv_vec=torch.where(vec > 0, 1.0 / vec, 0.0), constr_type=types)
    if indirect:
        factor = factor._replace(diag=core.build_M_diag(data.P, data.A, settings.sigma, vec))
    else:
        factor = core.factorize(data.P, data.A, settings.sigma, vec, kkt_method)
    res = core.solve_scaled_impl(data, scal, settings, rho, factor, iterates,
                                 indirect=indirect, kkt_method=kkt_method)
    return res, data


def _zero_iterates(B, n, m, dtype, device):
    return core.Iterates(*(torch.zeros((B, k), dtype=dtype, device=device) for k in (n, m, m)))


@torch.no_grad()
def batch_qp_solve(P, q, A, l, u, settings: CoreSettings, rho, scaling_iters: int = 10,
                   indirect: bool = False, kkt_method: str = 'chol') -> core.SolveResult:
    """Pure batched solve: scale, factorize and run ADMM from zero iterates.

    Every input carries a leading batch axis and lies on the device the solve
    runs on; ``rho`` is (B,).  The counterpart of the JAX package's flagship
    jitted step."""
    data, scal, rho_state, factor = _setup_batch(P, q, A, l, u, rho, settings, scaling_iters,
                                                 indirect, kkt_method)
    iterates = _zero_iterates(q.shape[0], q.shape[1], A.shape[-2], P.dtype, P.device)
    return _solve_batch(data, scal, settings, rho_state, factor, iterates, indirect, kkt_method)


@torch.no_grad()
def mpc_rollout(data, scal, settings: CoreSettings, rho, factor, iterates, q_seq,
                indirect: bool = False, kkt_method: str = 'chol'):
    """MPC rollout over a sequence of cost vectors: each step updates q and
    re-solves warm from the last step's iterates, rho and factor, with no
    copy of a result to the host (the loop's per-epoch syncs aside).

    ``q_seq`` is (steps, B, n).  Returns ``(carry, (x, iters, status))``:
    the final ``(data, rho, factor, iterates)`` and the per-step results
    stacked along a leading steps axis."""
    zeros_m = torch.zeros_like(iterates.z)
    xs, its, sts = [], [], []
    for q_new in q_seq:
        res, data = _update_and_solve_batch(data, scal, settings, rho, factor, iterates, q_new,
                                            zeros_m, zeros_m, True, False, False, indirect,
                                            kkt_method)
        rho, factor, iterates = res.rho, res.factor, res.iterates
        xs.append(res.x)
        its.append(res.iters)
        sts.append(res.status)
    return (data, rho, factor, iterates), (torch.stack(xs), torch.stack(its), torch.stack(sts))


# The JAX package donates the carry's buffers here; torch has no donation,
# so the continuation entry point is the same function.
mpc_rollout_donated = mpc_rollout


class BatchedOSQP:
    """Solve a batch of QPs.

    Inputs may be per instance (leading batch axis) or shared (broadcast):
    ``P: (B,n,n) | (n,n)``, ``q: (B,n) | (n,)``, ``A: (B,m,n) | (m,n)``,
    ``l,u: (B,m) | (m,)``, as numpy arrays or, for the vmap engine, torch
    tensors (kept on their device when it is the solver's).  Runs on CUDA
    unless ``device`` says otherwise; raises when no device is given and CUDA
    is absent.

    ``engine``: ``'vmap'`` (every instance its own P and A: batched Cholesky
    or explicit inverse, or PCG with ``solver_type='indirect'``),
    ``'shared'`` (P and A shared by the batch: one fused-epoch kernel launch
    per epoch) or ``'auto'`` (shared when P and A are both unbatched).
    ``kkt_method`` (vmap engine): ``'chol'``, ``'inv'`` (the explicit
    inverse with one refinement step per iteration), or ``'auto'`` (``'inv'``
    for float32, ``'chol'`` otherwise).

    ``fused`` (one fused-epoch kernel launch per epoch), ``compact``
    (``'auto'`` or ``'0'``) and ``iter_prec`` are the shared engine's, the
    JAX package's ``OSQP_TPU_FUSED_SHARED``, ``OSQP_TPU_COMPACT`` and
    ``OSQP_TPU_ITER_PRECISION`` as arguments.  ``iter_prec`` sets the
    precision of the ADMM iteration's product: ``'highest'`` (exact, either
    dtype), ``'high'`` (three bfloat16 passes, near float32) or ``'default'``
    (one bfloat16 pass, slower to converge); the last two need
    ``dtype=torch.float32`` and run on the card's tensor cores.  The
    termination check stays at full precision in every mode, so a reduced
    mode may cost iterations but never accepts an unconverged instance.  The
    vmap engine iterates at full precision only.
    """

    def __init__(self, dtype=torch.float64, device=None, kkt_method='auto', engine='auto', *,
                 fused=True, compact='auto', iter_prec='highest'):
        if engine not in ('auto', 'shared', 'vmap'):
            raise ValueError(f"engine must be 'auto', 'shared' or 'vmap', got {engine!r}")
        if kkt_method not in ('auto', 'chol', 'inv'):
            raise ValueError(f"kkt_method must be 'auto', 'chol' or 'inv', got {kkt_method!r}")
        iter_halves(iter_prec, dtype)
        if engine == 'vmap' and iter_prec != 'highest':
            raise ValueError(f"iter_prec={iter_prec!r} is the shared engine's; the vmap "
                             "engine iterates at full precision ('highest')")
        self._dtype = dtype
        self._device = resolve_device(device)
        self._pending = {}
        self._kkt_method_opt = kkt_method
        self._engine_opt = engine
        self._engine = None
        self._opts = dict(fused=fused, compact=compact, iter_prec=iter_prec)

    @property
    def _kkt_method(self):
        if self._kkt_method_opt != 'auto':
            return self._kkt_method_opt
        # float32 batches: the explicit-inverse matvec solve; float64:
        # Cholesky (the reference's trajectories)
        return 'inv' if self._dtype == torch.float32 else 'chol'

    @property
    def _indirect(self):
        return self._stg.linsys_solver == int(LinsysSolverType.OSQP_INDIRECT_SOLVER)

    @tracing.traced('setup')
    def setup(self, P, q, A, l, u, **settings):
        t0 = time.perf_counter()
        solver_type = settings.pop('solver_type', 'direct')
        if solver_type not in ('direct', 'indirect'):
            raise ValueError(f"solver_type must be 'direct' or 'indirect', got {solver_type!r}")
        self._stg = OracleSettings(**settings)
        if solver_type == 'indirect':
            self._stg.linsys_solver = int(LinsysSolverType.OSQP_INDIRECT_SOLVER)
        batched = (_ndim(P) == 3, _ndim(A) == 3)
        if self._engine_opt == 'auto':
            self._engine = 'vmap' if any(batched) else 'shared'
        else:
            self._engine = self._engine_opt
        if self._engine == 'shared':
            if any(batched):
                raise ValueError('the shared engine requires unbatched P and A')
            if solver_type == 'indirect':
                raise NotImplementedError(
                    'the shared engine solves its KKT system directly; pass a batched P '
                    "or A, or engine='vmap', for the indirect solver")
            self._setup_shared(P, q, A, l, u)
        else:
            if self._opts['iter_prec'] != 'highest':
                raise ValueError(f"iter_prec={self._opts['iter_prec']!r} is the shared "
                                 "engine's; the vmap engine iterates at full precision")
            self._setup_vmap(P, q, A, l, u)
        self.setup_time = time.perf_counter() - t0
        return self

    # -- the vmap engine ---------------------------------------------------

    def _setup_vmap(self, P, q, A, l, u):
        if _ndim(P) == 2 and not (_ndim(q) == 2 or _ndim(A) == 3):
            raise ValueError('cannot infer batch size')
        n = _shape(P)[-1]
        m = _shape(A)[-2]
        B = max(_shape(v)[0] if _ndim(v) == k else 1
                for v, k in ((P, 3), (q, 2), (A, 3), (l, 2), (u, 2)))
        self.B, self.n, self.m = B, n, m

        Pb = self._batch(P, (n, n))
        # symmetrize (accept triu-only input like the reference API)
        Pb = torch.triu(Pb) + torch.triu(Pb, 1).mT
        qb = self._batch(q, (n,))
        Ab = self._batch(A, (m, n))
        lb = self._batch(l, (m,)).clamp(min=-1e30)
        ub = self._batch(u, (m,)).clamp(max=1e30)
        rho = torch.full((B,), self._stg.rho, dtype=self._dtype, device=self._device)
        self._data, self._scal, self._rho, self._factor = _setup_batch(
            Pb, qb, Ab, lb, ub, rho, self._core_settings(), int(self._stg.scaling),
            self._indirect, self._kkt_method)
        self._iterates = _zero_iterates(B, n, m, self._dtype, self._device)

    def _batch(self, v, shape):
        """``v`` at the working dtype on the device, broadcast to (B,) + shape."""
        if isinstance(v, torch.Tensor):
            t = v.detach().to(dtype=torch.float64).to(device=self._device, dtype=self._dtype)
        else:
            t = torch.tensor(np.asarray(v, np.float64), dtype=self._dtype, device=self._device)
        return t.expand((self.B,) + shape).clone() if t.dim() < len(shape) + 1 else t

    def _core_settings(self) -> CoreSettings:
        return core_settings(self._stg, self._dtype)

    def _solve_vmap(self) -> core.SolveResult:
        """One vmap-engine solve with the staged updates; the result stays
        on the device."""
        stg = self._core_settings()
        if not self._stg.warm_starting:
            self._iterates = _zero_iterates(self.B, self.n, self.m, self._dtype, self._device)
        if self._pending:
            zero = torch.zeros_like
            res, self._data = _update_and_solve_batch(
                self._data, self._scal, stg, self._rho, self._factor, self._iterates,
                self._pending.get('q', zero(self._iterates.x)),
                self._pending.get('l', zero(self._iterates.z)),
                self._pending.get('u', zero(self._iterates.z)),
                'q' in self._pending, 'l' in self._pending, 'u' in self._pending,
                self._indirect, self._kkt_method)
            self._pending = {}
        else:
            res = _solve_batch(self._data, self._scal, stg, self._rho, self._factor,
                               self._iterates, self._indirect, self._kkt_method)
        self._iterates = res.iterates
        self._rho = res.rho
        self._factor = res.factor
        return res

    def solve_device(self) -> core.SolveResult:
        """A vmap-engine solve from the current state that copies nothing to
        the host and changes no state (staged updates are not applied),
        as ``osqp_tpu.batch.BatchedOSQP.solve_device`` does."""
        if self._engine != 'vmap':
            raise NotImplementedError('solve_device runs the vmap engine')
        return _solve_batch(self._data, self._scal, self._core_settings(), self._rho,
                            self._factor, self._iterates, self._indirect, self._kkt_method)

    # -- the shared engine -------------------------------------------------

    def _setup_shared(self, P, q, A, l, u):
        P = np.asarray(P, np.float64)
        A = np.asarray(A, np.float64)
        q = np.asarray(q, np.float64)
        if q.ndim != 2:
            raise ValueError('cannot infer batch size: pass q as (B, n)')
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
        self._zero_shared_iterates()

    def _zeros(self, rows):
        return torch.zeros((rows, self.B), dtype=self._dtype, device=self._device)

    def _zero_shared_iterates(self):
        self._sh_X = self._zeros(self.n)
        self._sh_Z = self._zeros(self.m)
        self._sh_Y = self._zeros(self.m)

    # -- both engines: the host's traffic through pinned staging ----------

    @property
    def _pin(self):
        return self._device.type == 'cuda'

    def _stage(self, parts):
        """``parts``, pairs of an array (numpy, or a CPU tensor) and a shape
        it broadcasts to, on the device at the working dtype: cast through
        float64, as ``torch.tensor(np.asarray(v, np.float64), dtype)``
        would, in one host pass into one fresh buffer (pinned on CUDA), then
        copied in one copy that does not wait.  The buffer is the solver's
        own, so a caller may change its arrays once this returns; a fresh
        block of torch's caching host allocator is not reused before the
        copy that reads it has run."""
        bounds = list(itertools.pairwise(
            itertools.accumulate((math.prod(shape) for _, shape in parts), initial=0)))
        total = bounds[-1][1]
        with tracing.span('stage', h2d=total * torch.finfo(self._dtype).bits // 8, pinned=True):
            host = torch.empty(total, dtype=self._dtype, pin_memory=self._pin)
            flat = host.numpy()
            with np.errstate(over='ignore'):  # beyond float32's range: inf, as torch casts
                for (v, shape), (a, b) in zip(parts, bounds):
                    np.copyto(flat[a:b].reshape(shape), np.asarray(v, np.float64),
                              casting='same_kind')
            dev = host.to(self._device, non_blocking=True)
        return [dev[a:b].view(shape) for (_, shape), (a, b) in zip(parts, bounds)]

    def _fetch(self, arrays: dict) -> dict:
        """The tensors of ``arrays`` on the host, as numpy arrays of their
        dtypes, shapes and values: gathered on the device into one buffer
        (transposes included), brought back in one copy and one wait into a
        fresh host buffer (pinned on CUDA), and returned as views into it.
        Each call has its own buffer, so a later solve overwrites no array a
        caller keeps."""
        place, off = [], 0
        for t in arrays.values():
            place.append(off)
            off += -(-t.nbytes // 16) * 16  # each array 16-byte aligned
        dev = torch.empty(off, dtype=torch.uint8, device=self._device)
        for t, o in zip(arrays.values(), place):
            dev[o:o + t.nbytes].view(t.dtype).view(t.shape).copy_(t)
        host = torch.empty(off, dtype=torch.uint8, pin_memory=self._pin)
        with tracing.span('sync', d2h=off, pinned=True):
            host.copy_(dev)
        return {name: host[o:o + t.nbytes].view(t.dtype).view(t.shape).numpy()
                for (name, t), o in zip(arrays.items(), place)}

    @tracing.traced('update')
    def update(self, q=None, l=None, u=None):
        """Stage batched vector updates; applied at the next solve."""
        given = {name: v for name, v in (('q', q), ('l', l), ('u', u)) if v is not None}
        if not given:
            return
        staged = self._stage([(v, (self.B, self.n if name == 'q' else self.m))
                              for name, v in given.items()])
        for name, t in zip(given, staged):
            # the clip after the cast: rounding is monotone, so the values
            # are those of the clip before it
            if name == 'l':
                t.clamp_(min=-1e30)
            if name == 'u':
                t.clamp_(max=1e30)
            self._pending[name] = t

    def warm_start(self, x=None, y=None):
        if self._engine == 'shared':
            scal = self._sh_scal
            if x is not None:
                (xt,) = self._stage([(np.asarray(x, np.float64).T, (self.n, self.B))])
                xs = scal.Dinv[:, None] * xt
                self._sh_X = xs
                self._sh_Z = self._sh_A @ xs
            if y is not None:
                (yt,) = self._stage([(np.asarray(y, np.float64).T, (self.m, self.B))])
                self._sh_Y = scal.c * (scal.Einv[:, None] * yt)
            return
        scal, it = self._scal, self._iterates
        if x is not None:
            (xt,) = self._stage([(x, (self.B, self.n))])
            xs = scal.Dinv * xt
            it = it._replace(x=xs, z=core._mv(self._data.A, xs))
        if y is not None:
            (yt,) = self._stage([(y, (self.B, self.m))])
            it = it._replace(y=scal.c.unsqueeze(-1) * (scal.Einv * yt))
        self._iterates = it

    @tracing.traced('solve')
    def solve(self):
        t0 = time.perf_counter()
        if self._engine == 'shared':
            return self._solve_shared(t0)
        res = self._solve_vmap()
        h = self._fetch(dict(
            x=res.x, y=res.y, prim_inf_cert=res.prim_inf_cert, dual_inf_cert=res.dual_inf_cert,
            status=res.status, iters=res.iters, obj_val=res.obj_val,
            dual_obj_val=res.dual_obj_val, duality_gap=res.duality_gap, pri_res=res.pri_res,
            dua_res=res.dua_res, rho_estimate=res.rho_estimate, rho_updates=res.rho_updates,
            cg_iters=res.cg_iters))
        solve_time = time.perf_counter() - t0
        info = SimpleNamespace(
            status_val=h['status'],
            status=status_strings(h['status']),
            iter=h['iters'],
            obj_val=h['obj_val'],
            dual_obj_val=h['dual_obj_val'],
            duality_gap=h['duality_gap'],
            prim_res=h['pri_res'],
            dual_res=h['dua_res'],
            rho_estimate=h['rho_estimate'],
            rho_updates=h['rho_updates'],
            cg_iters=h['cg_iters'],
            host_syncs=res.host_syncs,
            solve_time=solve_time,
            setup_time=self.setup_time,
            run_time=self.setup_time + solve_time,
        )
        return SimpleNamespace(x=h['x'], y=h['y'], prim_inf_cert=h['prim_inf_cert'],
                               dual_inf_cert=h['dual_inf_cert'], info=info)

    def _solve_shared(self, t0):
        stg = core_settings(self._stg, self._dtype)
        scal = self._sh_scal
        if not self._stg.warm_starting:
            self._zero_shared_iterates()
        if 'q' in self._pending:
            self._sh_Q = settings_scale_q(scal, self._pending['q'].T).contiguous()
        if 'l' in self._pending:
            self._sh_L = (scal.E[:, None] * self._pending['l'].T).contiguous()
        if 'u' in self._pending:
            self._sh_U = (scal.E[:, None] * self._pending['u'].T).contiguous()
        self._pending = {}
        syncs = tracing.thread_syncs()
        out = shared_solve(
            self._sh_P, self._sh_A, self._sh_Q, self._sh_L, self._sh_U,
            scal, stg, self._sh_rho, self._sh_Minv, self._sh_M,
            self._sh_rho_vec, self._sh_X, self._sh_Z, self._sh_Y, **self._opts,
        )
        self._sh_X, self._sh_Z, self._sh_Y = out['X'], out['Z'], out['Y']
        self._sh_rho = out['rho']
        self._sh_rho_vec = out['rho_vec']
        self._sh_Minv, self._sh_M = out['Minv'], out['M']
        host_syncs = tracing.thread_syncs() - syncs

        h = self._fetch(dict(
            x=out['x'], y=out['y'], prim_inf_cert=out['prim_inf_cert'],
            dual_inf_cert=out['dual_inf_cert'], status=out['status'], iters=out['iters'],
            obj_val=out['obj_val'], dual_obj_val=out['dual_obj_val'],
            duality_gap=out['obj_val'] - out['dual_obj_val'], pri_res=out['pri_res'],
            dua_res=out['dua_res']))
        solve_time = time.perf_counter() - t0
        info = SimpleNamespace(
            status_val=h['status'],
            status=status_strings(h['status']),
            iter=h['iters'],
            obj_val=h['obj_val'],
            dual_obj_val=h['dual_obj_val'],
            duality_gap=h['duality_gap'],
            prim_res=h['pri_res'],
            dual_res=h['dua_res'],
            rho_estimate=float(out['rho']),
            rho_updates=int(out['rho_updates']),
            host_syncs=host_syncs,
            solve_time=solve_time,
            setup_time=self.setup_time,
            run_time=self.setup_time + solve_time,
        )
        return SimpleNamespace(x=h['x'], y=h['y'], prim_inf_cert=h['prim_inf_cert'],
                               dual_inf_cert=h['dual_inf_cert'], info=info)


def _ndim(v):
    return v.dim() if isinstance(v, torch.Tensor) else np.ndim(v)


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
