"""The single-QP solver handle on torch tensors.

Counterpart of ``osqp_tpu/backends/jax_backend.py::Solver``: host-side setup,
updates and bookkeeping around ``osqp_tpu_torch.solver.core.solve_scaled``,
with the reference binding's surface (``setup / solve / warm_start /
update_data_vec / update_data_mat / update_settings / update_rho``).

Two modes, chosen at setup as the JAX package chooses them:

- dense: P and A as dense tensors, Ruiz on the device, the convexity check;
  direct mode factors ``M = P + sigma I + A' diag(rho) A`` by Cholesky,
  indirect mode runs PCG on dense matvecs;
- sparse (``sparse=True``, or ``'auto'`` above 25M dense entries): Ruiz on the
  host in scipy, P and A as sparse operators (``ops.spmv``: DIA, ELL, BSR,
  or the CSR fallback for ragged patterns, each picked from its pattern by
  the JAX package's ladder) whose matvecs are hand-written CUDA kernels on the
  card (cuSPARSE for the fallback), and always the indirect (PCG) solver.

``solve`` runs the ADMM loop in one call, or in chunks between which it
checks the clock (``time_limit``) and where a SIGINT stops it; then, for a
solved problem with ``polishing``, the float64 active-set polish and, if that
is rejected, its line-search family; ``verbose`` prints the JAX package's
console rows.

The JAX package's environment knobs are arguments: ``sparse``
(``OSQP_TPU_SPARSE``), ``sparse_format`` (``OSQP_TPU_SPARSE_FORMAT``) and
``dense_budget_bytes`` (``OSQP_TPU_DENSE_SPMV_BYTES``).
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
import torch

from .constants import (
    CapabilitiesType,
    LinsysSolverType,
    OSQP_INFTY,
    SolverError,
    SolverStatus,
    status_string,
)
from .device import resolve_device
from .exceptions import OSQPException
from .ops import spmv
from .settings import Info, OracleSettings, Solution, core_settings, np_dtype
from .solver import core
from .utils.printing import print_footer, print_iter_header, print_setup_header
from .utils.scaling_host import ruiz_scale_scipy

SPARSE_AUTO_ENTRIES = 25_000_000
VERSION = '1.0.0.dev0'  # the version the verbose header prints, as the JAX package's
NAME = 'torch'  # the algebra's name (osqp_tpu_torch.algebra), the JAX package's 'jax'


def capabilities() -> int:
    return (CapabilitiesType.OSQP_CAPABILITY_DIRECT_SOLVER
            | CapabilitiesType.OSQP_CAPABILITY_INDIRECT_SOLVER
            | CapabilitiesType.OSQP_CAPABILITY_UPDATE_MATRICES
            | CapabilitiesType.OSQP_CAPABILITY_DERIVATIVES
            | CapabilitiesType.OSQP_CAPABILITY_CODEGEN)


def solver_types():
    return ('direct', 'indirect')


def _poll_interrupt():
    """Between-chunk interrupt point of the chunked (time_limit) solve loop.

    A real SIGINT raises KeyboardInterrupt in the host loop wherever it
    lands; this hook lets tests inject one deterministically (by
    monkeypatching it to raise).  A no-op otherwise."""


def _invalid():
    return OSQPException(int(SolverError.OSQP_DATA_VALIDATION_ERROR))


def _scale_csc(S, rowscale, colscale, mult=1.0):
    """rowscale[i] * S[i, j] * colscale[j] * mult, keeping the exact stored
    pattern (scipy's diags @ S @ diags would prune explicit zeros and change
    the pinned DIA offsets or ELL widths across updates)."""
    S = S.tocsc(copy=True)
    cols = np.repeat(np.arange(S.shape[1]), np.diff(S.indptr))
    S.data = S.data * rowscale[S.indices] * colscale[cols] * mult
    return S


class Solver:
    """Single-QP solver handle: host state plus device tensors."""

    ALGEBRA = NAME  # the verbose header's algebra

    def __init__(self, dtype=torch.float64, device=None, sparse='auto',
                 sparse_format='auto', dense_budget_bytes=spmv.DENSE_BUDGET_BYTES):
        if sparse not in ('auto', True, False):
            raise ValueError(f"sparse must be 'auto', True or False, got {sparse!r}")
        if str(sparse_format).lower() not in spmv.FORMATS:
            raise ValueError(f'sparse_format must be one of {spmv.FORMATS}, got {sparse_format!r}')
        np_dtype(dtype)
        self._dtype = dtype
        self._device = resolve_device(device)
        self._sparse_opt = sparse
        self._sparse_format = sparse_format
        self._dense_budget = int(dense_budget_bytes)
        self._is_sparse = False
        # the last solve's polish: PCG steps (sparse mode) and host syncs
        self.polish_cg_iters = self.polish_host_syncs = 0

    # -- helpers -----------------------------------------------------------

    @property
    def _indirect(self) -> bool:
        return self._stg.linsys_solver == int(LinsysSolverType.OSQP_INDIRECT_SOLVER)

    def _f(self):
        return np_dtype(self._dtype)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self._dtype, device=self._device)

    def _check_convexity(self):
        """Direct mode: the scaled KKT matrix has valid inertia iff
        P_scaled + sigma I is positive definite."""
        if self._indirect:
            return
        P = self._data.P
        n = P.shape[0]
        eye = torch.eye(n, dtype=P.dtype, device=P.device)
        _, info = torch.linalg.cholesky_ex(P + self._f()(self._stg.sigma) * eye)
        if int(info) != 0:
            raise OSQPException(int(SolverError.OSQP_NONCVX_ERROR))

    def _refactorize(self):
        sigma = self._f()(self._stg.sigma)
        if self._indirect:
            diag = core.build_M_diag(self._data.P, self._data.A, sigma, self._rho.rho_vec)
            self._factor = core.Factor(L=None, diag=diag, Minv=None)
        else:
            if self._is_sparse:
                raise ValueError('sparse mode solves by PCG only (linsys_solver indirect)')
            self._factor = core.factorize(self._data.P, self._data.A, sigma, self._rho.rho_vec)

    def _zero_iterates(self):
        z = torch.zeros
        kw = dict(dtype=self._dtype, device=self._device)
        self._iterates = core.Iterates(x=z((self.n,), **kw), z=z((self.m,), **kw),
                                       y=z((self.m,), **kw))

    def _solver_name(self) -> str:
        return 'indirect' if self._indirect else 'direct'

    def _adapt_after(self, t0):
        """The time-based first rho adaptation, ``(t0, seconds)``, or None:
        this solver takes the fixed interval (the JAX package's jitted core
        cannot read clocks mid-solve)."""
        return None

    # -- low-level API -----------------------------------------------------

    def _ingest(self, P, q, A, l, u):
        """Validate the data and keep its patterns and bounds; returns the
        full symmetric P (CSC), A, q, l and u as float64."""
        P = sp.csc_matrix(P).astype(np.float64)
        A = sp.csc_matrix(A).astype(np.float64)
        n, m = P.shape[0], A.shape[0]
        q = np.asarray(q, np.float64).ravel()
        l = np.full(m, -OSQP_INFTY) if l is None else np.asarray(l, np.float64).ravel()
        u = np.full(m, OSQP_INFTY) if u is None else np.asarray(u, np.float64).ravel()
        l = np.maximum(l, -OSQP_INFTY)
        u = np.minimum(u, OSQP_INFTY)
        if np.any(l > u):
            raise _invalid()

        P_triu = sp.triu(P, format='csc')
        P_full = (P_triu + P_triu.T - sp.diags(P_triu.diagonal())).tocsc()
        self.n, self.m = n, m
        self._P_triu_pattern = P_triu  # CSC pattern for update_data_mat
        self._A_pattern = A.copy()
        self._nnz_P, self._nnz_A = P_full.nnz, A.nnz  # for the verbose header
        self._l_orig = l.copy()
        self._u_orig = u.copy()
        return P_full, A, q, l, u

    def _setup_sparse(self, P_full, A, q, l, u):
        """Sparse mode's data: Ruiz on the host in scipy (the scaled P and A
        kept as ``_P_s`` and ``_A_s``), then P and A as sparse operators,
        each in the format its pattern picks, pinned for value updates."""
        n, m = self.n, self.m
        f = self._f()
        if int(self._stg.scaling) > 0:
            P_s, A_s, q_s, l_s, u_s, D, E, c = ruiz_scale_scipy(
                P_full, A, q, l, u, int(self._stg.scaling))
        else:
            P_s, A_s, q_s, l_s, u_s = P_full, A, q, l, u
            D, E, c = np.ones(n), np.ones(m), 1.0
        self._P_s, self._A_s = P_s, A_s
        fmt = dict(sparse_format=self._sparse_format, dense_budget_bytes=self._dense_budget)
        self._sparse_fmt_P = spmv.choose_format(P_s, **fmt)
        self._sparse_fmt_A = spmv.choose_format(A_s, **fmt)
        self._data = core.QPData(
            P=spmv.from_scipy(P_s, self._dtype, self._sparse_fmt_P, self._device),
            q=self._t(q_s),
            A=spmv.from_scipy(A_s, self._dtype, self._sparse_fmt_A, self._device),
            l=self._t(l_s),
            u=self._t(u_s),
        )
        self._scal = core.Scaling(
            D=self._t(D), Dinv=self._t(1.0 / D), E=self._t(E),
            Einv=self._t(1.0 / E if m else E), c=f(c), cinv=f(1.0 / c))

    def setup(self, P, q, A, l, u, **settings):
        t0 = time.perf_counter()
        self._stg = OracleSettings(**settings)
        P_full, A, q, l, u = self._ingest(P, q, A, l, u)
        n, m = self.n, self.m
        self._is_sparse = self._sparse_opt is True or (
            self._sparse_opt == 'auto' and n * n + m * n > SPARSE_AUTO_ENTRIES)
        if self._is_sparse:
            # the sparse path is CG-only: a dense factorization would not fit
            self._stg.linsys_solver = int(LinsysSolverType.OSQP_INDIRECT_SOLVER)
            self._setup_sparse(P_full, A, q, l, u)
        else:
            Pj = self._t(P_full.toarray())
            Aj = self._t(A.toarray() if m else np.zeros((m, n)))
            qj, lj, uj = self._t(q), self._t(l), self._t(u)
            if int(self._stg.scaling) > 0:
                self._data, self._scal = core.ruiz_scale(Pj, qj, Aj, lj, uj,
                                                         int(self._stg.scaling))
            else:
                self._data = core.QPData(P=Pj, q=qj, A=Aj, l=lj, u=uj)
                self._scal = core.identity_scaling(n, m, self._dtype, self._device)
            self._check_convexity()
        self._finish_setup(t0)

    def _finish_setup(self, t0):
        """Constraint types and rho, the factorization, zero iterates and a
        fresh info; ``t0`` is the setup's start on the host clock."""
        self._rho = core.make_rho_state(self._data.l, self._data.u, self._stg.rho,
                                        bool(self._stg.rho_is_vec))
        self._refactorize()
        self._zero_iterates()
        self._info = Info()
        self._solution = Solution()
        self._first_run = True
        self._clear_update_time = False
        self._info.setup_time = time.perf_counter() - t0
        self._info.rho_estimate = self._stg.rho

    def _run_admm(self, t0):
        """The ADMM loop: one ``core.solve_scaled`` call, or chunks of it
        when a time limit is set or ``OSQP_TPU_CHUNKED_SOLVE=1`` (the JAX
        package's environment switch, ``jax_backend.py``).  Between chunks
        the wall clock is compared with ``time_limit`` (TIME_LIMIT_REACHED),
        and a KeyboardInterrupt (SIGINT) gives OSQP_SIGINT with the last
        completed chunk's iterates; one before the first chunk completes
        propagates."""
        stg = self._stg
        verbose = bool(stg.verbose)
        cs = core_settings(stg, self._dtype)
        time_limit = float(stg.time_limit or 0.0)
        adapt_after = self._adapt_after(t0)
        if not (time_limit > 0.0 or os.environ.get('OSQP_TPU_CHUNKED_SOLVE') == '1'):
            return core.solve_scaled(self._data, self._scal, cs, self._rho, self._factor,
                                     self._iterates, indirect=self._indirect, verbose=verbose,
                                     adapt_after=adapt_after)
        ct = max(int(stg.check_termination), 1)
        chunk = max(10 * ct, 100)
        chunk -= chunk % ct
        it0, max_iter = 0, int(stg.max_iter)
        iterates, rho, factor = self._iterates, self._rho, self._factor
        # summed over chunks: rho updates and the primal-dual integral as in
        # the JAX package, and the port's CG steps and host syncs
        acc = dict(primdual_acc=0.0, rho_updates=0, cg_iters=0, host_syncs=0)
        res = None
        try:
            while True:
                _poll_interrupt()
                # each chunk starts from a fresh loop state, as the JAX
                # package's chunks do (so the CG tolerance restarts at 1e-3)
                res = core.solve_scaled(self._data, self._scal,
                                        cs._replace(iter_cap=min(it0 + chunk, max_iter)),
                                        rho, factor, iterates, indirect=self._indirect,
                                        verbose=verbose, it0=it0, adapt_after=adapt_after)
                it0 = int(res.iters)
                for k in acc:
                    acc[k] += getattr(res, k)
                iterates, rho, factor = res.iterates, res.rho, res.factor
                if res.status != int(SolverStatus.OSQP_UNSOLVED) or it0 >= max_iter:
                    break
                if time_limit > 0.0 and time.perf_counter() - t0 > time_limit:
                    res = res._replace(status=int(SolverStatus.OSQP_TIME_LIMIT_REACHED))
                    break
        except KeyboardInterrupt:
            if res is None:
                raise  # interrupted before any chunk completed
            res = res._replace(status=int(SolverStatus.OSQP_SIGINT))
        return res._replace(**acc)

    def _polish(self, res):
        """Polish the ADMM solution in float64 (``jax_backend.py``: the Schur
        operator's 1/delta conditioning defeats float32).  Data, scaling and
        iterates are cast to float64 for this call only; sparse operands keep
        their patterns.  Returns the polish result, the float64 data and
        scaling."""
        f64 = torch.float64
        d = self._data

        def cast(M):
            return M.astype(f64) if spmv.is_structured(M) else M.to(f64)

        data = core.QPData(P=cast(d.P), q=d.q.to(f64), A=cast(d.A), l=d.l.to(f64),
                           u=d.u.to(f64))
        sc = self._scal
        scal = core.Scaling(D=sc.D.to(f64), Dinv=sc.Dinv.to(f64), E=sc.E.to(f64),
                            Einv=sc.Einv.to(f64), c=np.float64(sc.c), cinv=np.float64(sc.cinv))
        it = res.iterates
        pol = core.polish(data, scal, core_settings(self._stg, f64), self._stg.delta,
                          int(self._stg.polish_refine_iter), it.x.to(f64), it.z.to(f64),
                          it.y.to(f64), res.pri_res, res.dua_res)
        return pol, data, scal

    def solve(self):
        stg = self._stg
        info = self._info
        t0 = time.perf_counter()
        if self._clear_update_time:
            info.update_time = 0.0
        if not stg.warm_starting:
            self._zero_iterates()

        if stg.verbose:
            print_setup_header(self.n, self.m, self._nnz_P + self._nnz_A, stg, self.ALGEBRA,
                               self._solver_name(), VERSION, self._device)
            print_iter_header()

        res = self._run_admm(t0)
        status = int(res.status)
        self._iterates = res.iterates
        self._rho = res.rho
        self._factor = res.factor

        x_out = res.x.cpu().numpy().astype(np.float64)
        y_out = res.y.cpu().numpy().astype(np.float64)
        info.iter = int(res.iters)
        info.obj_val = float(res.obj_val)
        info.dual_obj_val = float(res.dual_obj_val)
        info.duality_gap = float(res.duality_gap)
        info.prim_res = float(res.pri_res)
        info.dual_res = float(res.dua_res)
        info.rho_estimate = float(res.rho_estimate)
        info.rho_updates = int(res.rho_updates)
        info.status_val = status
        info.status = status_string(status)
        info.cg_iters = int(res.cg_iters)
        info.host_syncs = int(res.host_syncs)
        self._stg.rho = float(res.rho.rho)
        info.solve_time = time.perf_counter() - t0
        info.rel_kkt_error = float(res.rel_kkt_error)
        # the core accumulates the iteration integral of min(1, rel_kkt);
        # the mean iteration time turns it into the time integral
        info.primdual_int = float(res.primdual_acc) * info.solve_time / max(int(res.iters), 1)

        # polish: only a SOLVED run, always in float64
        info.status_polish = 0
        info.polish_time = 0.0
        self.polish_cg_iters = self.polish_host_syncs = 0
        linesearch = None
        if stg.polishing and status == int(SolverStatus.OSQP_SOLVED):
            tp = time.perf_counter()
            pol, data64, scal64 = self._polish(res)
            self.polish_cg_iters, self.polish_host_syncs = pol.cg_iters, pol.host_syncs
            if pol.success:
                info.status_polish = 1
                info.obj_val = float(pol.obj_val)
                info.prim_res = float(pol.pri_res)
                info.dual_res = float(pol.dua_res)
                self._iterates = core.Iterates(x=pol.x.to(self._dtype), z=pol.z.to(self._dtype),
                                               y=pol.y.to(self._dtype))
                x_out = (scal64.D * pol.x).cpu().numpy()
                y_out = (scal64.cinv * (scal64.E * pol.y)).cpu().numpy()
            elif pol.x is None:
                info.status_polish = -1  # the reduced KKT matrix had a zero pivot
            else:
                info.status_polish = -1
                # the line-search fallback family (ref _osqp.py:1817-1826):
                # unscaled samples of the ADMM -> polished segment
                it = res.iterates
                ls = core.line_search_family(data64, scal64, it.x.to(torch.float64),
                                             it.z.to(torch.float64), it.y.to(torch.float64),
                                             pol.x, pol.z, pol.y)
                linesearch = SimpleNamespace(**{k: v.cpu().numpy()
                                                for k, v in ls._asdict().items()})
            info.polish_time = time.perf_counter() - tp

        if self._first_run:
            info.run_time = info.setup_time + info.solve_time + info.polish_time
        else:
            info.run_time = info.update_time + info.solve_time + info.polish_time
        self._first_run = False
        self._clear_update_time = True
        if stg.verbose:
            print_footer(info, stg.polishing)

        sol = self._solution
        sol.x = x_out
        sol.y = y_out
        sol.prim_inf_cert = res.prim_inf_cert.cpu().numpy().astype(np.float64)
        sol.dual_inf_cert = res.dual_inf_cert.cpu().numpy().astype(np.float64)
        sol.linesearch = linesearch
        return sol, info

    # -- warm start / updates ----------------------------------------------

    def warm_start(self, x=None, y=None):
        self._stg.warm_starting = True
        it = self._iterates
        if x is not None:
            x = np.asarray(x, np.float64).ravel()
            if x.shape != (self.n,):
                raise _invalid()
            xs = self._scal.Dinv * self._t(x)
            zs = self._data.A @ xs if self.m else it.z.new_zeros((0,))
            it = it._replace(x=xs, z=zs)
        if y is not None:
            y = np.asarray(y, np.float64).ravel()
            if y.shape != (self.m,):
                raise _invalid()
            it = it._replace(y=self._scal.c * (self._scal.Einv * self._t(y)))
        self._iterates = it

    def _begin_update(self):
        if self._clear_update_time:
            self._clear_update_time = False
            self._info.update_time = 0.0
        return time.perf_counter()

    def update_data_vec(self, q=None, l=None, u=None):
        t0 = self._begin_update()
        data = self._data
        if q is not None:
            q = np.asarray(q, np.float64).ravel()
            if q.shape != (self.n,):
                raise _invalid()
            data = data._replace(q=self._scal.c * (self._scal.D * self._t(q)))
        bounds_changed = False
        if l is not None:
            l = np.maximum(np.asarray(l, np.float64).ravel(), -OSQP_INFTY)
            if l.shape != (self.m,):
                raise _invalid()
            self._l_orig = l.copy()
            data = data._replace(l=self._scal.E * self._t(l))
            bounds_changed = True
        if u is not None:
            u = np.minimum(np.asarray(u, np.float64).ravel(), OSQP_INFTY)
            if u.shape != (self.m,):
                raise _invalid()
            self._u_orig = u.copy()
            data = data._replace(u=self._scal.E * self._t(u))
            bounds_changed = True
        self._data = data
        if bounds_changed:
            if np.any(self._l_orig > self._u_orig):
                raise _invalid()
            # re-type the constraints; refactor only on a type change
            # (ref _osqp.py:526-562)
            new_types = core.constraint_types(self._data.l, self._data.u)
            changed = bool(torch.any(new_types != self._rho.constr_type))
            rho = core.clip_rho(self._stg.rho, self._dtype)
            vec = core.rho_vec_from_types(new_types, rho, bool(self._stg.rho_is_vec), self._dtype)
            self._rho = core.RhoState(rho=rho, rho_vec=vec,
                                      rho_inv_vec=torch.where(vec > 0, 1.0 / vec, 0.0),
                                      constr_type=new_types)
            if changed:
                self._refactorize()
        info = self._info
        info.status_val = int(SolverStatus.OSQP_UNSOLVED)
        info.status = status_string(info.status_val)
        info.rho_updates = 0
        info.solve_time = 0.0
        info.polish_time = 0.0
        info.update_time += time.perf_counter() - t0

    def update_data_mat(self, P_x=None, P_i=None, A_x=None, A_i=None):
        t0 = self._begin_update()
        dt = self._dtype
        D = self._scal.D.cpu().numpy().astype(np.float64)
        if P_x is not None:
            P_triu = self._P_triu_pattern.copy()
            data = P_triu.data.copy()
            if P_i is None:
                if len(P_x) != len(data):
                    raise _invalid()
                data[:] = P_x
            else:
                data[np.asarray(P_i, np.int64)] = P_x
            P_triu = sp.csc_matrix((data, P_triu.indices, P_triu.indptr), shape=P_triu.shape)
            self._P_triu_pattern = P_triu
            P_full = (P_triu + P_triu.T - sp.diags(P_triu.diagonal())).tocsc()
            self._nnz_P = P_full.nnz
            if self._is_sparse:
                self._P_s = _scale_csc(P_full, D, D, float(self._scal.c))
                P_new = spmv.from_scipy(self._P_s, dt, self._sparse_fmt_P, self._device)
            else:
                Pj = self._t(P_full.toarray())
                P_new = self._scal.c * (self._scal.D[:, None] * Pj * self._scal.D[None, :])
            self._data = self._data._replace(P=P_new)
        if A_x is not None:
            A = self._A_pattern.copy()
            data = A.data.copy()
            if A_i is None:
                if len(A_x) != len(data):
                    raise _invalid()
                data[:] = A_x
            else:
                data[np.asarray(A_i, np.int64)] = A_x
            A = sp.csc_matrix((data, A.indices, A.indptr), shape=A.shape)
            self._A_pattern = A
            self._nnz_A = A.nnz
            if self._is_sparse:
                E = self._scal.E.cpu().numpy().astype(np.float64)
                self._A_s = _scale_csc(A, E, D)
                A_new = spmv.from_scipy(self._A_s, dt, self._sparse_fmt_A, self._device)
            else:
                Aj = self._t(A.toarray())
                A_new = self._scal.E[:, None] * Aj * self._scal.D[None, :]
            self._data = self._data._replace(A=A_new)
        if P_x is not None and not self._is_sparse:
            self._check_convexity()
        self._refactorize()
        info = self._info
        info.status_val = int(SolverStatus.OSQP_UNSOLVED)
        info.status = status_string(info.status_val)
        info.update_time += time.perf_counter() - t0

    def update_rho(self, rho_new):
        if rho_new <= 0:
            raise ValueError('rho must be positive')
        self._stg.rho = float(core.clip_rho(rho_new, torch.float64))
        rho = core.clip_rho(self._stg.rho, self._dtype)
        vec = core.rho_vec_from_types(self._rho.constr_type, rho, bool(self._stg.rho_is_vec),
                                      self._dtype)
        self._rho = self._rho._replace(rho=rho, rho_vec=vec,
                                       rho_inv_vec=torch.where(vec > 0, 1.0 / vec, 0.0))
        self._refactorize()

    def update_settings(self, **kwargs):
        refactor_needed = False
        for k, v in kwargs.items():
            if not hasattr(self._stg, k):
                raise ValueError(f'Unrecognized setting {k}')
        for k, v in kwargs.items():
            if k in ('linsys_solver', 'sigma') and getattr(self._stg, k) != v:
                refactor_needed = True
            setattr(self._stg, k, v)
        if refactor_needed:
            self._refactorize()
