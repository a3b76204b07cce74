"""The port's derivative API (osqp_tpu_torch.solver.derivatives and the
``OSQP`` methods) against the JAX package's on the CPU in float64.

On tests/test_derivative.py's problems (``get_prob``, the port's copy):

- ``adjoint_derivative`` and ``forward_derivative`` of both packages on
  identical x and y, to 1e-7 relative;
- end to end through the API (``adjoint_derivative_compute``, ``_get_mat``
  in its four forms, ``_get_vec``, ``forward_derivative``) after the port's
  and ``osqp_tpu.OSQP(algebra='jax')``'s own solves, to 1e-7 relative;
- the error paths and ``capabilities()``.
"""

import numpy as np
import numpy.random as npr
import pytest
import scipy.sparse as sp

import osqp_tpu
from osqp_tpu.solver import derivatives as jder

import osqp_tpu_torch
from osqp_tpu_torch.constants import CapabilitiesType
from osqp_tpu_torch.solver import derivatives as tder

RTOL = 1e-7
SOLVE = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=500000, verbose=False)


def get_prob(n=10, m=3, equalities=0, loose=0):
    """tests/test_derivative.py's random QP (numpy's global generator)."""
    L = np.random.randn(n, n - 1)
    P = sp.csc_matrix(L.dot(L.T) + 0.1 * sp.eye(n))
    x_0 = npr.randn(n)
    s_0 = npr.rand(m)
    A = sp.csc_matrix(npr.randn(m, n))
    u = A.dot(x_0) + s_0
    l = A.dot(x_0) - s_0
    if equalities:
        u[:equalities] = l[:equalities]
    if loose:
        l[equalities:equalities + loose] = -1e30
    q = npr.randn(n)
    true_x = npr.randn(n)
    return P, q, A, l, u, true_x


# (seed, n, m, equalities, loose): the cases of tests/test_derivative.py
_CASES = {
    'dq': (1, 8, 5, 0, 0),
    'dbounds': (2, 8, 5, 0, 0),
    'dq_eq': (11, 20, 15, 8, 0),
    'dq_eq_large': (12, 100, 120, 20, 20),
    'dA_eq': (13, 12, 9, 4, 0),
    'dP_dA': (3, 6, 4, 0, 0),
    'default': (4, 10, 3, 0, 0),
}


def _prob(case):
    seed, n, m, eq, loose = _CASES[case]
    npr.seed(seed)
    return get_prob(n=n, m=m, equalities=eq, loose=loose)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1e-300, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize('case', list(_CASES))
def test_functions_match_jax(case):
    """Both packages' adjoint and forward derivatives from the same x and y
    (the port's f64 solve to 1e-9), the same seeds and directions."""
    P, q, A, l, u, true_x = _prob(case)
    s = osqp_tpu_torch.OSQP(device='cpu')
    s.setup(P, q, A, l, u, **SOLVE)
    r = s.solve(raise_error=True)
    n, m = A.shape[1], A.shape[0]
    rng = np.random.default_rng(0)
    dy = rng.standard_normal(m)
    got = tder.adjoint_derivative(P, q, A, l, u, r.x, r.y, r.x - true_x, dy)
    want = jder.adjoint_derivative(P, q, A, l, u, r.x, r.y, r.x - true_x, dy)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])
    dirs = dict(dP=sp.triu(sp.csc_matrix(rng.standard_normal((n, n)))),
                dq=rng.standard_normal(n), dA=sp.csc_matrix(rng.standard_normal((m, n))),
                dl=rng.standard_normal(m), du=rng.standard_normal(m))
    for k in (None, 'dq', 'dl'):  # every direction, then one alone
        kw = dirs if k is None else {k: dirs[k]}
        for g, w in zip(tder.forward_derivative(P, q, A, l, u, r.x, r.y, **kw),
                        jder.forward_derivative(P, q, A, l, u, r.x, r.y, **kw)):
            _close(g, w)


@pytest.mark.parametrize('case', ['default', 'dq_eq_large'])
def test_api_matches_jax(case):
    """The port's ``OSQP`` against ``osqp_tpu.OSQP(algebra='jax')``, each
    after its own solve to 1e-9: the adjoint's matrices (dense and CSC, full
    and upper-triangle dP) and vectors, and a forward derivative."""
    P, q, A, l, u, true_x = _prob(case)
    j = osqp_tpu.OSQP(algebra='jax')
    j.setup(P, q, A, l, u, **SOLVE)
    t = osqp_tpu_torch.OSQP(device='cpu')
    t.setup(P, q, A, l, u, **SOLVE)
    rj, rt = j.solve(raise_error=True), t.solve(raise_error=True)
    assert rt.info.iter == rj.info.iter
    dy = np.linspace(-1, 1, A.shape[0])
    for s, r in ((j, rj), (t, rt)):
        s.adjoint_derivative_compute(dx=r.x - true_x, dy=dy)
    for as_dense in (True, False):
        for triu in (True, False):
            got = t.adjoint_derivative_get_mat(as_dense=as_dense, dP_as_triu=triu)
            want = j.adjoint_derivative_get_mat(as_dense=as_dense, dP_as_triu=triu)
            for g, w in zip(got, want):
                assert sp.issparse(g) == sp.issparse(w) == (not as_dense)
                if not as_dense:
                    assert g.shape == w.shape and g.nnz == w.nnz
                    g, w = g.toarray(), w.toarray()
                _close(g, w)
    for g, w in zip(t.adjoint_derivative_get_vec(), j.adjoint_derivative_get_vec()):
        _close(g, w)
    dq = np.ones(A.shape[1])
    for g, w in zip(t.forward_derivative(dq=dq, du=dy), j.forward_derivative(dq=dq, du=dy)):
        _close(g, w)


def test_errors_and_capabilities():
    """The API refuses before a solve, after an unsolved run, before
    ``adjoint_derivative_compute`` and after an update, with the JAX
    package's errors; ``capabilities()`` reports derivatives."""
    P, q, A, l, u, true_x = _prob('default')
    for s in (osqp_tpu.OSQP(algebra='numpy'), osqp_tpu_torch.OSQP(device='cpu')):
        s.setup(P, q, A, l, u, verbose=False, max_iter=5, eps_abs=1e-12, eps_rel=1e-12)
        with pytest.raises(ValueError, match='has not been solved'):
            s.adjoint_derivative_compute(dx=np.zeros(10))
        assert s.solve(raise_error=False).info.status == 'maximum iterations reached'
        with pytest.raises(ValueError, match='not been solved to optimality'):
            s.adjoint_derivative_compute(dx=np.zeros(10))
        with pytest.raises(ValueError, match='not been solved to optimality'):
            s.forward_derivative(dq=np.ones(10))
        s.update_settings(max_iter=4000, eps_abs=1e-3, eps_rel=1e-3)
        s.solve(raise_error=True)
        with pytest.raises(ValueError, match='adjoint_derivative_compute first'):
            s.adjoint_derivative_get_vec()
        with pytest.raises(ValueError, match='adjoint_derivative_compute first'):
            s.adjoint_derivative_get_mat()
        s.adjoint_derivative_compute()  # no seeds: zeros
        assert not np.any(s.adjoint_derivative_get_vec()[0])
        s.update(q=q)
        with pytest.raises(ValueError, match='has not been solved'):
            s.adjoint_derivative_get_vec()
    t = osqp_tpu_torch.OSQP(device='cpu')
    assert t.capabilities & int(CapabilitiesType.OSQP_CAPABILITY_DERIVATIVES)
    assert t.has_capability('OSQP_CAPABILITY_DERIVATIVES')
    assert osqp_tpu.OSQP(algebra='jax').has_capability('OSQP_CAPABILITY_DERIVATIVES')
