"""User-facing ``OSQP`` API on torch tensors.

The port's own copy of ``osqp_tpu/interface.py``'s ``OSQP``: problem
ingestion and validation, settings with their deprecation shims and aliases,
the solve / update lifecycle and warm starts, the adjoint and forward
derivatives of the solution (``solver.derivatives``) and embedded code
generation (``codegen``), over the backend of the algebra chosen
(``osqp_tpu_torch.algebra``: 'torch', the default, or 'ldl').
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import scipy.sparse as spa
import torch

from . import tracing
from .algebra import algebra_available, algebra_module, default_algebra
from .constants import (
    CapabilitiesType,
    LinsysSolverType,
    OSQP_INFTY,
    PrecondType,
    SolverStatus,
    constant,
)
from .device import resolve_device
from .exceptions import OSQPException
from .ops.spmv import DENSE_BUDGET_BYTES
from .solver import derivatives

# Settings understood by the solver, with reference defaults.
DEFAULT_SETTINGS = {
    'device': 0,
    'linsys_solver': int(LinsysSolverType.OSQP_DIRECT_SOLVER),
    'verbose': False,
    'warm_starting': True,
    'scaling': 10,
    'polishing': False,
    'rho': 0.1,
    'rho_is_vec': True,
    'sigma': 1e-6,
    'alpha': 1.6,
    'cg_max_iter': 20,
    'cg_tol_reduction': 10,
    'cg_tol_fraction': 0.15,
    'cg_precond': int(PrecondType.OSQP_DIAGONAL_PRECONDITIONER),
    'adaptive_rho': True,
    'adaptive_rho_interval': 0,
    # 0 = the deterministic fixed adaptation interval (ADAPTIVE_RHO_FIXED)
    'adaptive_rho_fraction': 0.0,
    'adaptive_rho_tolerance': 5.0,
    'max_iter': 4000,
    'eps_abs': 1e-3,
    'eps_rel': 1e-3,
    'eps_prim_inf': 1e-4,
    'eps_dual_inf': 1e-4,
    'scaled_termination': False,
    'check_termination': 25,
    'check_dualgap': True,
    'time_limit': 0.0,
    'delta': 1e-6,
    'polish_refine_iter': 3,
}

_INFO_FIELDS = (
    'status',
    'status_val',
    'status_polish',
    'obj_val',
    'dual_obj_val',
    'prim_res',
    'dual_res',
    'duality_gap',
    'iter',
    'rho_updates',
    'rho_estimate',
    'setup_time',
    'solve_time',
    'update_time',
    'polish_time',
    'run_time',
    'primdual_int',
    'rel_kkt_error',
    'cg_iters',
    'host_syncs',
)


class OSQPSettings(SimpleNamespace):
    """Mutable settings namespace."""

    def __init__(self, **kwargs):
        merged = dict(DEFAULT_SETTINGS)
        merged.update(kwargs)
        super().__init__(**merged)

    def as_dict(self):
        return dict(self.__dict__)


class OSQP:
    """Operator-splitting QP solver on torch tensors.

    Solves ``minimize 1/2 x'Px + q'x  subject to  l <= Ax <= u`` with the
    public API of ``osqp_tpu.OSQP``.  ``algebra`` is 'torch' (the default)
    or 'ldl' (float64 sparse direct solves by an LDL' of the full KKT
    matrix, the counterpart of the JAX package's 'numpy'; ``ordering``
    'rcm' or 'natural' picks its fill-reducing ordering).  ``dtype`` is the
    working precision (float64 by default, float32 on request, 'torch'
    only); ``device`` defaults to the current CUDA device and raises without
    one; ``sparse`` ('auto', True, False) selects the 'torch' algebra's
    sparse mode (sparse operators, PCG); ``sparse_format`` forces an
    operator format and ``dense_budget_bytes`` bounds the dense format.
    """

    def __init__(self, dtype=torch.float64, device=None, sparse='auto',
                 sparse_format='auto', dense_budget_bytes=DENSE_BUDGET_BYTES, algebra=None,
                 ordering='rcm'):
        self.m = None
        self.n = None
        self.algebra = default_algebra() if algebra is None else algebra
        if not algebra_available(self.algebra):
            raise RuntimeError(f'Algebra {self.algebra} not available')
        self.ext = algebra_module(self.algebra)
        # the device is resolved here: no device and no CUDA raises at once
        self._solver_kwargs = dict(dtype=dtype, device=resolve_device(device))
        if self.algebra == 'ldl':
            self._solver_kwargs.update(ordering=ordering)
        else:
            self._solver_kwargs.update(sparse=sparse, sparse_format=sparse_format,
                                       dense_budget_bytes=dense_budget_bytes)
        self.settings = None
        self._solver = None
        self._cache = {}

    def __str__(self):
        if self._solver is None:
            return f'Uninitialized OSQP with algebra={self.algebra}'
        return f'OSQP with algebra={self.algebra} ({self.solver_type})'

    # -- error translation -------------------------------------------------

    @classmethod
    def raises_error(cls, fn, *args, **kwargs):
        """Translate backend ValueErrors into OSQPException."""
        try:
            return fn(*args, **kwargs)
        except OSQPException:
            raise
        except ValueError as e:
            error_code = None
            if e.args:
                try:
                    error_code = int(e.args[0])
                except (ValueError, TypeError):
                    pass
            raise OSQPException(error_code)

    # -- ingestion ---------------------------------------------------------

    @staticmethod
    def _require_csc(M, name):
        """Coerce a matrix argument to CSC with sorted indices.  Dense
        ndarrays are rejected; sparse-but-not-CSC inputs convert with a
        warning."""
        if isinstance(M, np.ndarray) and M.ndim == 2:
            raise TypeError(f'{name} must be a scipy sparse matrix, got a dense ndarray')
        if not (spa.issparse(M) and spa.isspmatrix_csc(M)):
            warnings.warn(f'{name}: converting to CSC (pass csc_matrix to avoid this copy)')
            M = spa.csc_matrix(M)
        if not M.has_sorted_indices:
            M.sort_indices()
        return M

    def _infer_mnpqalu(self, P=None, q=None, A=None, l=None, u=None):
        """Fill in whatever the caller omitted and normalize the rest: n from
        P, else q, else A's columns; m from A (0 when absent); empty P, zero
        q, infinite bounds and an empty 0 x n A synthesized; a full symmetric
        P reduced to its upper triangle; bounds clamped to +/-OSQP_INFTY."""
        for candidate in (
            (lambda: P.shape[0]) if P is not None else None,
            (lambda: len(q)) if q is not None else None,
            (lambda: A.shape[1]) if A is not None else None,
        ):
            if candidate is not None:
                n = candidate()
                break
        else:
            raise ValueError('Cannot infer the number of variables: '
                             'pass at least one of P, q or A')
        m = A.shape[0] if A is not None else 0

        if A is None:
            if l is not None or u is not None:
                raise AssertionError('Bounds l/u given without a constraint matrix A')
            A = spa.csc_matrix((0, n), dtype=np.float64)
            l = np.zeros(0)
            u = np.zeros(0)
        else:
            if l is None and u is None:
                raise AssertionError('A given without either bound; pass l and/or u')
            if l is None:
                l = np.full(m, -np.inf)
            if u is None:
                u = np.full(m, np.inf)

        if P is None:
            P = spa.csc_matrix((n, n), dtype=np.float64)
        if q is None:
            q = np.zeros(n)

        for vec, length, name in ((q, n, 'q'), (l, m, 'l'), (u, m, 'u')):
            assert len(vec) == length, f'{name} has length {len(vec)}, expected {length}'

        if spa.issparse(P) and spa.tril(P, -1).nnz > 0:
            P = spa.triu(P, format='csc')
        P = self._require_csc(P, 'P')
        A = self._require_csc(A, 'A')

        q = np.asarray(q, dtype=np.float64).ravel()
        l = np.clip(np.asarray(l, dtype=np.float64).ravel(), -OSQP_INFTY, None)
        u = np.clip(np.asarray(u, dtype=np.float64).ravel(), None, OSQP_INFTY)
        return m, n, P, q, A, l, u

    # -- capability / properties -------------------------------------------

    @property
    def capabilities(self) -> int:
        return int(self.ext.capabilities())

    def has_capability(self, capability: str) -> bool:
        try:
            cap = int(CapabilitiesType[capability])
        except KeyError:
            raise RuntimeError(f'Unrecognized capability {capability}')
        return (self.capabilities & cap) != 0

    @property
    def solver_type(self) -> str:
        return ('direct'
                if self.settings.linsys_solver == int(LinsysSolverType.OSQP_DIRECT_SOLVER)
                else 'indirect')

    @property
    def cg_preconditioner(self):
        return ('diagonal'
                if self.settings.cg_precond == int(PrecondType.OSQP_DIAGONAL_PRECONDITIONER)
                else None)

    def constant(self, which):
        return constant(which, algebra=self.algebra)

    # -- settings ----------------------------------------------------------

    def update_settings(self, **kwargs):
        assert self.settings is not None, 'Solver has not been set up'

        renamed = {'polish': 'polishing', 'warm_start': 'warm_starting'}
        for old, new in renamed.items():
            if old in kwargs:
                warnings.warn(f'"{old}" is deprecated. Please use "{new}" instead.',
                              DeprecationWarning)
                kwargs[new] = kwargs.pop(old)

        changed = {}
        if 'rho' in kwargs and self._solver is not None:
            # rho goes through update_rho, not update_settings
            self.raises_error(self._solver.update_rho, kwargs.pop('rho'))
        if 'solver_type' in kwargs:
            value = kwargs.pop('solver_type')
            assert value in ('direct', 'indirect')
            self.settings.linsys_solver = int(
                LinsysSolverType.OSQP_DIRECT_SOLVER if value == 'direct'
                else LinsysSolverType.OSQP_INDIRECT_SOLVER)
            changed['linsys_solver'] = self.settings.linsys_solver
        if 'cg_preconditioner' in kwargs:
            value = kwargs.pop('cg_preconditioner')
            assert value in (None, 'diagonal')
            self.settings.cg_precond = int(
                PrecondType.OSQP_DIAGONAL_PRECONDITIONER if value == 'diagonal'
                else PrecondType.OSQP_NO_PRECONDITIONER)
            changed['cg_precond'] = self.settings.cg_precond

        for k in list(kwargs.keys()):
            if k in DEFAULT_SETTINGS:
                v = kwargs.pop(k)
                setattr(self.settings, k, v)
                changed[k] = v

        if kwargs:
            raise ValueError(f'Unrecognized settings {list(kwargs.keys())}')

        if changed and self._solver is not None:
            self.raises_error(self._solver.update_settings, **changed)

    # -- data updates ------------------------------------------------------

    @tracing.traced('update')
    def update(self, **kwargs):
        """Update problem vectors and/or matrix values in place."""
        q, l, u = kwargs.get('q'), kwargs.get('l'), kwargs.get('u')
        if l is not None:
            l = np.maximum(np.asarray(l, np.float64).ravel(), -OSQP_INFTY)
        if u is not None:
            u = np.minimum(np.asarray(u, np.float64).ravel(), OSQP_INFTY)
        if q is not None:
            q = np.asarray(q, np.float64).ravel()

        if q is not None or l is not None or u is not None:
            self.raises_error(self._solver.update_data_vec, q=q, l=l, u=u)
        if any(k in kwargs for k in ('Px', 'Px_idx', 'Ax', 'Ax_idx')):
            self.raises_error(self._solver.update_data_mat, P_x=kwargs.get('Px'),
                              P_i=kwargs.get('Px_idx'), A_x=kwargs.get('Ax'),
                              A_i=kwargs.get('Ax_idx'))

        for name, v in (('q', q), ('l', l), ('u', u)):
            if v is not None:
                self._cache[name] = v
        for var in ('P', 'A'):
            varx = f'{var}x'
            if kwargs.get(varx) is not None:
                mat = self._cache[var] = self._cache[var].copy()
                if kwargs.get(f'{varx}_idx') is None:
                    mat.data = np.asarray(kwargs[varx], np.float64)
                else:
                    mat.data[np.asarray(kwargs[f'{varx}_idx'])] = kwargs[varx]
        self._cache.pop('results', None)

    # -- lifecycle ---------------------------------------------------------

    @tracing.traced('setup')
    def setup(self, P, q, A, l, u, **settings):
        m, n, P, q, A, l, u = self._infer_mnpqalu(P=P, q=q, A=A, l=l, u=u)
        self._cache.update({'P': P, 'q': q, 'A': A, 'l': l, 'u': u})
        self.m = m
        self.n = n

        self.settings = OSQPSettings()
        self.update_settings(**settings)

        self._solver = self.ext.Solver(**self._solver_kwargs)
        self.raises_error(self._solver.setup, P, q, A, l, u, **self.settings.as_dict())
        if 'rho' in settings:
            self.raises_error(self._solver.update_rho, settings['rho'])

    def warm_start(self, x=None, y=None):
        return self.raises_error(self._solver.warm_start, x, y)

    def _rel_kkt_error(self, x, y, info):
        """Relative KKT error at the returned solution, from the original
        (unscaled) data: the max of the relative primal residual, relative
        dual residual and relative duality gap."""
        P, q = self._cache['P'], self._cache['q']
        A, l, u = self._cache['A'], self._cache['l'], self._cache['u']
        Pf = spa.triu(P, 1)
        Px = P @ x + Pf.T @ x  # P is stored triu; symmetrize the matvec
        if self.m:
            Ax = A @ x
            Aty = A.T @ y
            r_p = np.abs(Ax - np.clip(Ax, l, u)).max(initial=0.0)
            p_scale = max(1.0, np.abs(Ax).max(initial=0.0),
                          np.abs(np.clip(Ax, l, u)).max(initial=0.0))
        else:
            Aty = np.zeros_like(x)
            r_p, p_scale = 0.0, 1.0
        r_d = np.abs(Px + q + Aty).max(initial=0.0)
        d_scale = max(1.0, np.abs(Px).max(initial=0.0), np.abs(Aty).max(initial=0.0),
                      np.abs(q).max(initial=0.0))
        gap = abs(float(info.duality_gap))
        g_scale = max(1.0, abs(float(info.obj_val)), abs(float(info.dual_obj_val)))
        return float(max(r_p / p_scale, r_d / d_scale, gap / g_scale))

    @tracing.traced('solve')
    def solve(self, raise_error=None):
        if raise_error is None:
            warnings.warn('The default value of raise_error will change to True in the future.',
                          PendingDeprecationWarning)
            raise_error = False

        solution, info = self.raises_error(self._solver.solve)

        info_ns = SimpleNamespace(**{k: getattr(info, k) for k in _INFO_FIELDS})
        if info_ns.status_val == int(SolverStatus.OSQP_NON_CVX):
            info_ns.obj_val = np.nan
        if info_ns.status_val in (int(SolverStatus.OSQP_SOLVED),
                                  int(SolverStatus.OSQP_SOLVED_INACCURATE)):
            info_ns.rel_kkt_error = self._rel_kkt_error(solution.x, solution.y, info_ns)

        if info_ns.status_val != int(SolverStatus.OSQP_SOLVED) and raise_error:
            raise OSQPException(info_ns.status_val)

        results = SimpleNamespace(
            x=solution.x,
            y=solution.y,
            prim_inf_cert=solution.prim_inf_cert,
            dual_inf_cert=solution.dual_inf_cert,
            info=info_ns,
            linesearch=solution.linesearch,
        )
        self._cache['results'] = results
        return results

    # -- derivatives -------------------------------------------------------

    def _derivative_results(self):
        try:
            results = self._cache['results']
        except KeyError:
            raise ValueError('Problem has not been solved. You cannot take derivatives. '
                             'Please call the solve function.')
        if results.info.status_val != int(SolverStatus.OSQP_SOLVED):
            raise ValueError('Problem has not been solved to optimality. '
                             'You cannot take derivatives')
        return results

    def _derivative_data(self):
        c = self._cache
        return dict(P=c['P'], q=c['q'], A=c['A'], l=c['l'], u=c['u'],
                    device=self._solver_kwargs['device'])

    def adjoint_derivative_compute(self, dx=None, dy=None):
        """Adjoint derivatives of a loss with seeds ``dx`` (n,) and ``dy``
        (m,) at the last solution, which must be solved to optimality
        (``solver.derivatives.adjoint_derivative``, float64 on the solver's
        device); read them with ``adjoint_derivative_get_mat`` and
        ``adjoint_derivative_get_vec``."""
        results = self._derivative_results()
        dx = np.zeros(self.n) if dx is None else np.asarray(dx, np.float64)
        dy = np.zeros(self.m) if dy is None else np.asarray(dy, np.float64)
        self._cache['derivs'] = derivatives.adjoint_derivative(
            x=results.x, y=results.y, dx=dx, dy=dy, **self._derivative_data())

    def _derivs(self):
        self._derivative_results()
        derivs = self._cache.get('derivs')
        if derivs is None:
            raise ValueError('Call adjoint_derivative_compute first')
        return derivs

    def adjoint_derivative_get_mat(self, as_dense=True, dP_as_triu=True):
        """``(dP, dA)``: dense numpy arrays, or CSC matrices with
        ``as_dense=False``.  ``dP`` is the gradient with respect to the full
        symmetric P (each entry on its own), or with ``dP_as_triu`` with
        respect to its upper triangle (the two halves of an off-diagonal
        entry added), on P's pattern when sparse."""
        derivs = self._derivs()
        dP, dA = derivs['dP'], derivs['dA']
        if dP_as_triu:
            dP_dense = np.triu(dP + dP.T) - np.diag(np.diag(dP))
            P_triu = spa.triu(self._cache['P'], format='csc').tocoo()
            dP_out = spa.csc_matrix((dP_dense[P_triu.row, P_triu.col],
                                     (P_triu.row, P_triu.col)), shape=P_triu.shape)
        else:
            dP_dense = dP
            dP_out = spa.csc_matrix(dP)
        if as_dense:
            return dP_dense, np.asarray(dA)
        return dP_out, spa.csc_matrix(dA)

    def adjoint_derivative_get_vec(self):
        """``(dq, dl, du)`` as numpy arrays."""
        derivs = self._derivs()
        return derivs['dq'], derivs['dl'], derivs['du']

    def forward_derivative(self, dP=None, dq=None, dA=None, dl=None, du=None):
        """Directional derivatives ``(dx, dyl, dyu)`` of the solution in the
        data direction ``(dP, dq, dA, dl, du)``
        (``solver.derivatives.forward_derivative``)."""
        results = self._derivative_results()
        return derivatives.forward_derivative(x=results.x, y=results.y, dP=dP, dq=dq, dA=dA,
                                              dl=dl, du=du, **self._derivative_data())

    # -- codegen -----------------------------------------------------------

    def codegen(
        self,
        folder,
        parameters='vectors',
        extension_name='emosqp',
        force_rewrite=False,
        use_float=False,
        printing_enable=False,
        profiling_enable=False,
        interrupt_enable=False,
        derivatives_enable=False,
        include_codegen_src=True,
        prefix='',
        compile=False,
        embedded_algebra='auto',
    ):
        """Generate an embedded C solver with the problem data baked in
        (``codegen.driver.generate``); returns the folder.  The ``*_enable``
        flags compile printing, profiling, the interrupt flag and the
        derivatives define in or out of the emitted C.  The workspace is
        exported in float64 whatever the working dtype."""
        assert self.has_capability('OSQP_CAPABILITY_CODEGEN'), \
            'This OSQP object does not support codegen'
        assert parameters in ('vectors', 'matrices'), 'Unknown parameters specification'

        from .codegen.driver import generate

        return generate(
            self,
            folder,
            parameters=parameters,
            extension_name=extension_name,
            force_rewrite=force_rewrite,
            use_float=use_float,
            prefix=prefix,
            compile=compile,
            printing_enable=printing_enable,
            profiling_enable=profiling_enable,
            interrupt_enable=interrupt_enable,
            derivatives_enable=derivatives_enable,
            embedded_algebra=embedded_algebra,
        )
