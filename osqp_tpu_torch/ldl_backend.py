"""The ``ldl`` algebra: sparse direct solves by an LDL' of the full KKT matrix.

Counterpart of ``osqp_tpu/backends/numpy_backend.py`` (the float64 core of
``osqp_tpu._oracle.solver.ReferenceSolver`` with the QDLDL-class factor of
``osqp_tpu/native/ldl.py``).  ``Solver`` is ``backend.Solver`` in sparse
mode (Ruiz on the host, P and A as the port's sparse operators) on the
solver core's sparse direct mode: each ADMM step solves the quasi-definite
KKT matrix ``[[P + sigma I, A'], [A, -diag(1/rho)]]`` with the factor of
``ops.ldl`` (on the card: the numeric factorization K5 and the solves K6;
the host does the symbolic analysis once, at setup).  Where the numpy
algebra's behaviour differs from the 'torch' algebra's, this one follows
the numpy algebra:

- inertia: a factorization with ``n_positive != n`` raises
  ``OSQP_NONCVX_ERROR`` under the direct solver (a zero pivot too);
- ``update_rho`` and adaptive rho refactor numerically on the same
  symbolic; ``update_data_vec`` refactors only if a constraint's type
  changed; ``update_data_mat`` refactors with the new values;
- ``adaptive_rho_fraction > 0`` takes the time-based first adaptation;
- the polish factors ``[[P + delta I, Ared'], [Ared, -delta I]]`` by the
  same LDL' (a new symbolic pass each polish), refines against the
  unregularized operator and gives ``status_polish = -1`` on a zero pivot
  (the JAX package factors it with scipy's ``splu``).

Float64 only.  ``ordering`` ('rcm' or 'natural') is the JAX package's
``OSQP_TPU_LDL_ORDERING``.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from . import backend, tracing
from .constants import CapabilitiesType, LinsysSolverType, SolverError
from .exceptions import OSQPException
from .ops import ldl as ldl_ops
from .settings import OracleSettings, core_settings
from .solver import core

NAME = 'ldl'


def capabilities() -> int:
    return (CapabilitiesType.OSQP_CAPABILITY_DIRECT_SOLVER
            | CapabilitiesType.OSQP_CAPABILITY_UPDATE_MATRICES
            | CapabilitiesType.OSQP_CAPABILITY_DERIVATIVES
            | CapabilitiesType.OSQP_CAPABILITY_CODEGEN)


def solver_types():
    return ('direct',)


def _values_at(S, rows, cols):
    """``S[rows[k], cols[k]]`` for each k (0 where S stores nothing)."""
    if not len(rows):
        return np.zeros(0)
    return np.asarray(sp.csr_matrix(S)[rows, cols], np.float64).ravel()


class KKTSystem:
    """The full KKT matrix of the scaled data and its LDL' factor.

    The upper triangle's pattern is built once from the caller's P (upper
    triangle, explicit zeros kept) and A patterns, with every diagonal
    entry: the P block, then A' above the (2,2) block's diagonal.  Its
    values come from one source vector, ``[P + sigma I (triu), A,
    -1/rho]``, gathered into the pattern's order on the device, so that a
    new rho is a numeric refactorization on the same symbolic."""

    def __init__(self, P_triu, A, device, ordering: str, direct: bool):
        n, m = P_triu.shape[0], A.shape[0]
        self.n, self.m, self.direct = n, m, direct
        Pc = sp.csc_matrix(P_triu).tocoo()
        has_diag = np.zeros(n, bool)
        has_diag[Pc.row[Pc.row == Pc.col]] = True
        extra = np.flatnonzero(~has_diag)
        Ac = sp.csc_matrix(A).tocoo()
        self._p_rows = np.concatenate([Pc.row, extra]).astype(np.int64)
        self._p_cols = np.concatenate([Pc.col, extra]).astype(np.int64)
        self._a_rows, self._a_cols = Ac.row.astype(np.int64), Ac.col.astype(np.int64)
        rows = np.concatenate([self._p_rows, self._a_cols, n + np.arange(m)])
        cols = np.concatenate([self._p_cols, n + self._a_rows, n + np.arange(m)])
        ids = np.arange(1, len(rows) + 1, dtype=np.float64)
        K = sp.csc_matrix((ids, (rows, cols)), shape=(n + m, n + m))
        K.sort_indices()
        self._src_map = torch.as_tensor((K.data - 1.0).astype(np.int64), device=device)
        self._K_pattern = K
        self._device = device
        self._ordering = ordering
        self.factor = None

    def set_static(self, P_s, A_s, sigma):
        """The P and A parts of the source vector from the scaled P (full)
        and A: P's values at the upper-triangle pattern plus sigma on the
        diagonal, A's at its pattern."""
        pv = _values_at(P_s, self._p_rows, self._p_cols)
        pv = np.where(self._p_rows == self._p_cols, pv + sigma, pv)
        av = _values_at(A_s, self._a_rows, self._a_cols)
        self._static = torch.as_tensor(np.concatenate([pv, av]), device=self._device)

    def _values(self, rho_inv_vec):
        """The KKT matrix's values in its pattern's order: one gather on the
        device."""
        return torch.cat([self._static, -rho_inv_vec.to(torch.float64)])[self._src_map]

    def refactor(self, rho_inv_vec):
        """Factor with 1/rho = ``rho_inv_vec``: the symbolic pass the first
        time, then numeric only (K5 on the card).  Checks the inertia;
        returns self."""
        try:
            if self.factor is None:  # LDLFactor times its symbolic pass and factorization
                self.factor = ldl_ops.LDLFactor(self._K_pattern, self._device, self._ordering,
                                                values=self._values(rho_inv_vec))
            else:
                with tracing.span('ldl.factor'):
                    self.factor.update_values(self._values(rho_inv_vec))
        except ZeroDivisionError:
            # a quasi-definite KKT matrix has no zero pivot: P + sigma I is
            # not positive definite
            raise OSQPException(int(SolverError.OSQP_NONCVX_ERROR if self.direct
                                    else SolverError.OSQP_LINSYS_SOLVER_INIT_ERROR))
        if self.factor.n_positive != self.n and self.direct:
            raise OSQPException(int(SolverError.OSQP_NONCVX_ERROR))
        self.rho_inv_vec = rho_inv_vec
        return self

    def solve(self, b):
        return self.factor.solve(b)


class Solver(backend.Solver):
    """Single-QP solver handle of the 'ldl' algebra (float64)."""

    ALGEBRA = NAME

    def __init__(self, dtype=torch.float64, device=None, ordering: str = 'rcm'):
        if dtype != torch.float64:
            raise ValueError(f"the 'ldl' algebra solves in float64 only, got {dtype}")
        if ordering not in ('rcm', 'natural'):
            raise ValueError(f"ordering must be 'rcm' or 'natural', got {ordering!r}")
        super().__init__(dtype=torch.float64, device=device, sparse=True)
        self._ordering = ordering
        self._kkt = None

    @property
    def _indirect(self) -> bool:
        return False

    def _direct(self) -> bool:
        return self._stg.linsys_solver == int(LinsysSolverType.OSQP_DIRECT_SOLVER)

    def _solver_name(self) -> str:
        return 'direct'

    def _adapt_after(self, t0):
        stg = self._stg
        if (stg.adaptive_rho and int(stg.adaptive_rho_interval) == 0
                and float(stg.adaptive_rho_fraction) > 0):
            return (t0, float(stg.adaptive_rho_fraction) * self._info.setup_time)
        return None

    def setup(self, P, q, A, l, u, **settings):
        t0 = time.perf_counter()
        self._stg = OracleSettings(**settings)
        P_full, A, q, l, u = self._ingest(P, q, A, l, u)
        self._is_sparse = True
        self._setup_sparse(P_full, A, q, l, u)
        self._kkt = KKTSystem(self._P_triu_pattern, self._A_pattern, self._device,
                              self._ordering, self._direct())
        self._finish_setup(t0)

    def _refactorize(self):
        """Numeric refactorization at the current data, sigma and rho."""
        self._kkt.direct = self._direct()
        self._kkt.set_static(self._P_s, self._A_s, float(self._stg.sigma))
        self._factor = core.Factor(L=None, diag=None, Minv=None,
                                   ldl=self._kkt.refactor(self._rho.rho_inv_vec))

    def solve(self):
        out = super().solve()
        # an interrupted chunked solve keeps an earlier chunk's rho: the
        # factor must be that rho's
        if self._kkt.rho_inv_vec is not self._rho.rho_inv_vec:
            self._refactorize()
        return out

    def _polish(self, res):
        """The numpy algebra's polish (``_oracle/solver.py:832-912``) with
        the LDL' factor: ``[[P + delta I, Ared'], [Ared, -delta I]]`` on the
        guessed active rows (lower first, then upper), a new symbolic pass,
        ``polish_refine_iter`` refinements against the unregularized
        operator, then the normal-cone projection.  A zero pivot gives a
        result with ``x`` None (``status_polish = -1``)."""
        stg = self._stg
        d, sc = self._data, self._scal
        n, m = self.n, self.m
        f64 = torch.float64
        it = res.iterates
        zyl = torch.stack([it.z, it.y, d.l, d.u])
        with tracing.span('sync', d2h=zyl.nbytes):
            z, y, l, u = zyl.cpu().numpy()  # one host sync
        ind_low = np.flatnonzero(z - l < -y)
        ind_upp = np.flatnonzero(u - z < y)
        idx = np.concatenate([ind_low, ind_upp])
        n_red = len(idx)
        delta = float(stg.delta)
        Ared = sp.csr_matrix(self._A_s)[idx] if m else sp.csr_matrix((0, n))
        K = sp.bmat([[self._P_s + delta * sp.eye(n), Ared.T if n_red else None],
                     [Ared if n_red else None, -delta * sp.eye(n_red) if n_red else None]],
                    format='csc')
        try:  # the factorization reads its pivots in one more sync
            fac = ldl_ops.LDLFactor(sp.triu(K, format='csc'), self._device, self._ordering)
        except ZeroDivisionError:
            return core.PolishResult(success=False, x=None, z=None, y=None, obj_val=None,
                                     pri_res=None, dua_res=None, cg_iters=0,
                                     host_syncs=2), d, sc
        idx_t = torch.as_tensor(idx, device=self._device)

        def ared_t(v):  # Ared' v
            w = v.new_zeros(m)
            w[idx_t] = v
            return d.A.T @ w

        rhs = torch.cat([-d.q, d.l[idx_t[:len(ind_low)]], d.u[idx_t[len(ind_low):]]])
        sol = fac.solve(rhs)
        for _ in range(int(stg.polish_refine_iter)):
            xk, yk = sol[:n], sol[n:]
            r1 = d.P @ xk + ared_t(yk) if n_red else d.P @ xk
            r2 = (d.A @ xk)[idx_t] if n_red else xk.new_zeros(0)
            sol = sol + fac.solve(rhs - torch.cat([r1, r2]))
        x_pol, y_red = sol[:n], sol[n:]
        if m:
            z_pol = d.A @ x_pol
            y_pol = x_pol.new_zeros(m)
            y_pol[idx_t] = y_red
            tmp = z_pol + y_pol  # normal-cone projection
            z_pol = torch.clamp(tmp, d.l, d.u)
            y_pol = tmp - z_pol
        else:
            z_pol = y_pol = x_pol.new_zeros(0)
        cs = core_settings(stg, f64)
        pri, dua, obj, *_ = core.compute_info(d, sc, x_pol, z_pol, y_pol, cs)
        with tracing.span('sync', d2h=24):
            pri, dua, obj = (float(v) for v in torch.stack([pri, dua, obj]).cpu())
        pri0, dua0 = float(res.pri_res), float(res.dua_res)
        success = ((pri < pri0 and dua < dua0) or (pri < pri0 and dua0 < 1e-10)
                   or (dua < dua0 and pri0 < 1e-10))
        return core.PolishResult(success=success, x=x_pol, z=z_pol, y=y_pol, obj_val=obj,
                                 pri_res=pri, dua_res=dua, cg_iters=0, host_syncs=3), d, sc

