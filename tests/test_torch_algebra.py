"""The port's 'ldl' algebra against the JAX package's 'numpy' algebra on the
CPU, in float64.

``osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')`` solves each ADMM step
by an LDL' of the full KKT matrix (on the CPU the plain versions of K5 and
K6), as ``osqp_tpu.OSQP(algebra='numpy')`` does with its native factor.
The two take the same steps in another summation order, so statuses,
iterations and rho updates are held equal, x and y within 1e-8 (of the
solution's max-norm, at least 1) and infeasibility certificates within 1e-6
relative.  Then the updates (bounds that retype the constraints and bounds
that do not, matrix values, rho), the polish, the time-based first rho
adaptation, the inertia check, the registry, the capabilities and the
emitted code.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp

import osqp_tpu
from osqp_tpu.codegen import driver as jdriver

import osqp_tpu_torch
from osqp_tpu_torch import algebra as talgebra
from osqp_tpu_torch.codegen import driver as tdriver
from osqp_tpu_torch.exceptions import OSQPException

import problems
from chip_smoke import portfolio_family

TOL = 1e-8
CERT_TOL = 1e-6


def _pair(build, **opts):
    """The same problem set up in both algebras; returns (numpy, ldl)."""
    P, q, A, l, u = build()
    opts = {'verbose': False, **opts}
    if A is not None and (not hasattr(l, 'size') or l.size == 0):
        A, l, u = None, None, None
    out = []
    for model in (osqp_tpu.OSQP(algebra='numpy'),
                  osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')):
        model.setup(P=P, q=q, A=A, l=l, u=u, **opts)
        out.append(model)
    return out


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max(initial=0.0))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale, (got, want)


def _same(ra, rb, polish=False):
    assert rb.info.status == ra.info.status
    assert rb.info.iter == ra.info.iter
    assert rb.info.rho_updates == ra.info.rho_updates
    if polish:
        assert rb.info.status_polish == ra.info.status_polish
    if ra.info.status_val in (1, 2):  # solved, solved inaccurate
        _close(rb.x, ra.x, TOL)
        _close(rb.y, ra.y, TOL)
    elif 'primal infeasible' in ra.info.status:
        _close(rb.prim_inf_cert, ra.prim_inf_cert, CERT_TOL)
    elif 'dual infeasible' in ra.info.status:
        _close(rb.dual_inf_cert, ra.dual_inf_cert, CERT_TOL)


FAMILIES = {name: getattr(problems, name) for name in (
    'basic_qp', 'polish_simple', 'polish_unconstrained', 'polish_random', 'unconstrained',
    'feasibility', 'primal_infeasible', 'dual_infeasible_lp', 'dual_infeasible_qp',
    'primal_dual_infeasible', 'warm_start_big')}
FAMILIES['portfolio_200x5'] = lambda: portfolio_family(200, 5)


@pytest.mark.parametrize('name', list(FAMILIES))
def test_family_matches_numpy(name):
    a, b = _pair(FAMILIES[name])
    _same(a.solve(raise_error=False), b.solve(raise_error=False))


def _bounds_problem():
    P, q, A, l, u = problems.basic_qp()
    return P, q, A, np.full(5, -1e3), u


@pytest.mark.parametrize('case', ['q', 'bounds_same_types', 'bounds_retype', 'matrices',
                                  'matrices_indexed', 'rho'])
def test_updates_match_numpy(case):
    """A solve, an update, a warm solve: the same statuses, iterations, rho
    updates and x, y, on each of the update paths."""
    if case.startswith('matrices'):
        fam = problems.update_matrices_family()
        build = lambda: (fam['P'], fam['q'], fam['A'], fam['l'], fam['u'])  # noqa: E731
    else:
        build = _bounds_problem
    a, b = _pair(build)
    _same(a.solve(raise_error=False), b.solve(raise_error=False))
    if case == 'q':
        kw = dict(q=np.array([1.0, -2.0]))
    elif case == 'bounds_same_types':
        kw = dict(l=np.full(5, -2e3), u=np.array([0.5, 0.5, -10.0, 90.0, 70.0]))
    elif case == 'bounds_retype':  # rows 0 and 1 become equalities, row 4 loose
        kw = dict(l=np.array([0.0, 0.0, -1e3, -1e3, -np.inf]),
                  u=np.array([0.0, 0.0, -15.0, 100.0, np.inf]))
    elif case == 'matrices':
        Pt = sp.triu(fam['P_new'], format='csc')
        kw = dict(Px=Pt.data, Ax=fam['A_new'].data)
    elif case == 'matrices_indexed':
        Pt = sp.triu(fam['P_new'], format='csc')
        idx = np.arange(0, Pt.nnz, 2)
        kw = dict(Px=Pt.data[idx], Px_idx=idx)
    if case == 'rho':
        a.update_settings(rho=0.7)
        b.update_settings(rho=0.7)
    else:
        a.update(**kw)
        b.update(**kw)
    _same(a.solve(raise_error=False), b.solve(raise_error=False))


@pytest.mark.parametrize('name', ['basic_qp', 'polish_simple', 'polish_random',
                                  'polish_unconstrained', 'portfolio_200x5'])
def test_polish_matches_numpy(name):
    """The polish by the same LDL' of the reduced KKT matrix: the same
    status_polish, x and y."""
    build = FAMILIES[name]
    a, b = _pair(build, polishing=True, eps_abs=1e-5, eps_rel=1e-5)
    _same(a.solve(raise_error=False), b.solve(raise_error=False), polish=True)


@pytest.mark.parametrize('name', ['basic_qp', 'polish_random', 'portfolio_200x5'])
def test_time_based_adaptation_iterations(name):
    """adaptive_rho_fraction > 0: the first adaptation at the first check
    past fraction * setup time (a tiny fraction: the first check), the
    interval then frozen there.  Iterations are held equal."""
    a, b = _pair(FAMILIES[name], adaptive_rho_fraction=1e-9)
    ra, rb = a.solve(raise_error=False), b.solve(raise_error=False)
    assert rb.info.iter == ra.info.iter
    assert rb.info.status == ra.info.status


@pytest.mark.parametrize('where', ['setup', 'update_P'])
def test_non_convex_raises(where):
    """The inertia check: n_positive != n under the direct solver raises
    OSQP_NONCVX_ERROR, at setup (as the numpy algebra does) or when a P
    update makes P non-convex."""
    code = int(osqp_tpu_torch.constants.SolverError.OSQP_NONCVX_ERROR)
    if where == 'setup':
        with pytest.raises(osqp_tpu.OSQPException) as want:
            osqp_tpu.OSQP(algebra='numpy').setup(*problems.non_convex(), verbose=False)
        with pytest.raises(OSQPException) as got:
            osqp_tpu_torch.OSQP(device='cpu', algebra='ldl').setup(*problems.non_convex(),
                                                                   verbose=False)
        assert got.value.args[0] == want.value.args[0] == code
        return
    b = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
    b.setup(*problems.basic_qp(), verbose=False)
    with pytest.raises(OSQPException) as got:
        b.update(Px=np.array([-40.0]), Px_idx=np.array([0]))
    assert got.value.args[0] == code


@pytest.mark.parametrize('case', ['names', 'default', 'jax_name', 'numpy_name', 'unknown',
                                  'float32', 'capabilities', 'solver_types', 'constant',
                                  'str'])
def test_registry(case):
    """The registry's names, default and errors; float64 only; the
    capabilities of the numpy backend."""
    if case == 'names':
        assert talgebra.algebras_available() == ['torch', 'ldl']
    elif case == 'default':
        assert talgebra.default_algebra() == 'torch'
        assert osqp_tpu_torch.OSQP(device='cpu').algebra == 'torch'
    elif case in ('jax_name', 'numpy_name'):
        name, counterpart = ('jax', 'torch') if case == 'jax_name' else ('numpy', 'ldl')
        with pytest.raises(RuntimeError, match=repr(counterpart)):
            osqp_tpu_torch.OSQP(device='cpu', algebra=name)
    elif case == 'unknown':
        with pytest.raises(RuntimeError, match='Unknown algebra'):
            osqp_tpu_torch.OSQP(device='cpu', algebra='mkl')
    elif case == 'float32':
        import torch

        m = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl', dtype=torch.float32)
        with pytest.raises(ValueError, match='float64'):
            m.setup(*problems.basic_qp(), verbose=False)
    elif case == 'capabilities':
        want = osqp_tpu.OSQP(algebra='numpy').capabilities
        assert osqp_tpu_torch.OSQP(device='cpu', algebra='ldl').capabilities == want
        m = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
        assert m.has_capability('OSQP_CAPABILITY_DIRECT_SOLVER')
        assert not m.has_capability('OSQP_CAPABILITY_INDIRECT_SOLVER')
    elif case == 'solver_types':
        from osqp_tpu.backends import numpy_backend

        assert talgebra.algebra_module('ldl').solver_types() == numpy_backend.solver_types()
        assert talgebra.algebra_module('ldl').NAME == 'ldl'
    elif case == 'constant':
        m = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
        for which in ('OSQP_INFTY', 'OSQP_SOLVED', 'OSQP_NONCVX_ERROR'):
            assert m.constant(which) == osqp_tpu.OSQP(algebra='numpy').constant(which)
    else:
        m = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
        assert str(m) == 'Uninitialized OSQP with algebra=ldl'
        m.setup(*problems.basic_qp(), verbose=False)
        assert str(m) == 'OSQP with algebra=ldl (direct)'


def test_verbose_header_names_ldl(capsys):
    b = _pair(problems.basic_qp, verbose=True)[1]
    b.solve(raise_error=False)
    out = capsys.readouterr().out
    assert re.search(r'algebra = ldl', out) and 'direct' in out


_DECL = re.compile(r'^(.+?) = (.+);$')


def _literals(text):
    out = {}
    for line in text.splitlines():
        m = _DECL.match(line)
        if m is None:
            out[line] = None
        else:
            out[m.group(1)] = np.array([float(v) for v in m.group(2).strip('{}').split(',')])
    return out


def _codegen_problem():
    """tests/test_codegen.py's vectors problem (l = -inf)."""
    P = sp.diags([11.0, 0.0], format='csc')
    q = np.array([3.0, 4.0])
    A = sp.csc_matrix([[-1, 0], [0, -1], [-1, -3], [2, 5], [3, 4]], dtype=float)
    u = np.array([0.0, 0.0, -15.0, 100.0, 80.0])
    return P, q, A, -np.inf * np.ones(5), u


@pytest.mark.parametrize('parameters', ['vectors', 'matrices'])
def test_codegen_files_match_numpy(parameters, tmp_path):
    """The same emitted files as the numpy algebra's after a solve: every
    file but workspace.c the JAX package's text with the generator's name
    changed, workspace.c's declarations identical and its literals within
    1e-12 of each array's largest."""
    a, b = _pair(_codegen_problem, eps_abs=1e-6, eps_rel=1e-6)
    a.solve(raise_error=False)
    b.solve(raise_error=False)
    kw = dict(parameters=parameters, extension_name='ldl_em')
    want_dir = jdriver.generate(a, str(tmp_path / 'numpy'), **kw)
    got_dir = tdriver.generate(b, str(tmp_path / 'ldl'), **kw)
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        got = open(os.path.join(got_dir, name)).read()
        want = open(os.path.join(want_dir, name)).read()
        if not name.endswith('workspace.c'):
            assert got.replace('osqp_tpu_torch.codegen', 'osqp_tpu.codegen') == want, name
            continue
        g, w = _literals(got), _literals(want)
        assert list(g) == list(w)
        for decl, vals in w.items():
            if vals is not None:
                scale = max(np.abs(vals).max(initial=0.0), 1e-300)
                assert np.abs(g[decl] - vals).max(initial=0.0) <= 1e-12 * scale, decl


def test_derivatives_on_ldl():
    """The derivative API works unchanged on the 'ldl' algebra: the adjoint
    derivatives equal the 'torch' algebra's at the same solution."""
    P, q, A, l, u = problems.basic_qp()
    out = []
    for algebra in ('ldl', 'torch'):
        m = osqp_tpu_torch.OSQP(device='cpu', algebra=algebra)
        m.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-9, eps_rel=1e-9)
        r = m.solve(raise_error=True)
        m.adjoint_derivative_compute(dx=np.ones(2))
        out.append((r.x, m.adjoint_derivative_get_vec()))
    _close(out[0][0], out[1][0], 1e-7)
    for g, w in zip(out[0][1], out[1][1]):
        _close(g, w, 1e-6)


def test_polish_zero_pivot_gives_minus_one(monkeypatch):
    """A zero pivot in the polish's factorization gives status_polish = -1
    and keeps the ADMM solution, with no line-search family (the JAX
    package's numpy algebra factors the reduced KKT matrix with splu, and
    gives -1 where splu fails)."""
    from osqp_tpu_torch import ldl_backend

    b = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
    b.setup(*problems.basic_qp(), verbose=False, polishing=True)

    class ZeroPivot:
        def __init__(self, *args, **kwargs):
            raise ZeroDivisionError('zero pivot at column 0')

    monkeypatch.setattr(ldl_backend.ldl_ops, 'LDLFactor', ZeroPivot)
    r = b.solve(raise_error=False)
    assert r.info.status == 'solved' and r.info.status_polish == -1
    assert r.linesearch is None
    a = osqp_tpu.OSQP(algebra='numpy')
    a.setup(*problems.basic_qp(), verbose=False)
    _close(r.x, a.solve(raise_error=False).x, TOL)
