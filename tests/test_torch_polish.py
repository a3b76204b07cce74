"""Solution polishing in the port (osqp_tpu_torch.OSQP, device='cpu', float64)
against osqp_tpu.OSQP(algebra='jax') under x64.

Dense direct and dense indirect polish on the problems of
tests/test_polishing.py with its settings; sparse-mode (DIA) polish, whose
Schur solves run PCG, on the banded family at n = 4096; the rejected polish's
line-search family.  Statuses, ADMM iterations and status_polish must be
identical; polished x, y and the objective within 1e-7, line-search families
within 1e-9.  Each JAX problem is solved once per module.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import osqp_tpu

import osqp_tpu_torch
from osqp_tpu_torch.ops.spmv import DiaMatrix

import problems
from utils import load_high_accuracy

ATOL = 1e-7
LS_ATOL = 1e-9

# tests/test_polishing.py's settings
OPTS = dict(verbose=False, eps_abs=1e-3, eps_rel=1e-3, scaling=10, rho=0.1, alpha=1.6,
            max_iter=2500, polishing=True, polish_refine_iter=4)
# and its tolerance ladder's jax rows: (atol, rtol, decimals) per solver type
LADDER = {'direct': (1e-3, 1e-4, 4), 'indirect': (1e-3, 1e-4, 3)}

NAMES = ('polish_simple', 'polish_unconstrained', 'polish_random')


def _solve_pair(prob, sparse=False, **opts):
    P, q, A, l, u = prob
    out = []
    for s in (osqp_tpu.OSQP(algebra='jax', sparse=sparse),
              osqp_tpu_torch.OSQP(device='cpu', sparse=sparse)):
        s.setup(P=P, q=q, A=A, l=l, u=u, **opts)
        out.append((s, s.solve(raise_error=False)))
    return out


@pytest.fixture(scope='module', params=[(name, st) for name in NAMES
                                        for st in ('direct', 'indirect')],
                ids=lambda p: f'{p[0]}-{p[1]}')
def dense_pair(request):
    name, st = request.param
    (_, rj), (t, rt) = _solve_pair(getattr(problems, name)(), solver_type=st, **OPTS)
    return name, st, rj, t, rt


def _match(rt, rj, atol=ATOL):
    for k in ('status', 'status_val', 'iter', 'rho_updates', 'status_polish'):
        assert getattr(rt.info, k) == getattr(rj.info, k), k
    for k in ('x', 'y'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0, atol=atol)
    for k in ('obj_val', 'prim_res', 'dual_res'):
        np.testing.assert_allclose(getattr(rt.info, k), getattr(rj.info, k), rtol=0, atol=atol)


def test_dense_polish_matches_jax(dense_pair):
    """Same statuses, iterations and status_polish; polished x, y and
    objective within 1e-7; an accepted polish has no line search."""
    name, st, rj, t, rt = dense_pair
    assert t.solver_type == st and rt.info.status == 'solved'
    _match(rt, rj)
    assert rt.info.status_polish == 1
    assert rt.linesearch is None and rj.linesearch is None
    assert rt.info.polish_time > 0
    assert t._solver.polish_cg_iters == 0  # dense polish: Cholesky, no PCG


def test_dense_polish_high_accuracy(dense_pair):
    """x (and y, objective) against the golden fixtures at the JAX tests'
    tolerances (tests/test_polishing.py::_check)."""
    name, st, rj, t, rt = dense_pair
    atol, rtol, decimal = LADDER[st]
    x_sol, y_sol, obj_sol = load_high_accuracy(f'test_{name}')
    np.testing.assert_allclose(rt.x, x_sol, rtol=rtol, atol=atol)
    if name != 'polish_unconstrained' and len(y_sol):
        np.testing.assert_allclose(rt.y, y_sol, rtol=rtol, atol=atol)
    np.testing.assert_almost_equal(rt.info.obj_val, obj_sol, decimal=decimal)


def _banded_qp(n, seed=0):
    """examples/huge_banded_qp.py's family: tridiagonal P, A = I + 0.5 S_{-2}."""
    rng = np.random.default_rng(seed)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.9), np.full(n - 1, -0.9)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = (sp.eye(n) + sp.diags([np.full(n - 2, 0.5)], [-2], shape=(n, n))).tocsc()
    return P, q, A, -1.5 * np.ones(n), 1.5 * np.ones(n)


def test_sparse_polish_matches_jax():
    """Sparse mode (DIA operators) at n = 4096: the Schur solves run PCG on
    the masked operator.  Same status_polish, x and y within 1e-7; the
    polish's PCG steps and host syncs counted (one sync per CG step's test,
    one more per solve that stops early, one for the acceptance test)."""
    refine = 3
    (_, rj), (t, rt) = _solve_pair(_banded_qp(4096), sparse=True, verbose=False,
                                   polishing=True, polish_refine_iter=refine)
    assert isinstance(t._solver._data.A, DiaMatrix)
    assert rt.info.status_polish == 1
    _match(rt, rj)
    cg, syncs = t._solver.polish_cg_iters, t._solver.polish_host_syncs
    assert cg > 100 * (refine + 1)
    assert syncs == cg + (refine + 1) + 1


def test_rejected_polish_linesearch_matches_jax():
    """delta = 1 and no refinement reject the polish: status_polish -1, and
    the line-search family (t, X, Z, Y) equals the JAX package's within 1e-9,
    with t[0] = 0 and X[0] the returned ADMM solution."""
    (_, rj), (_, rt) = _solve_pair(problems.polish_random(),
                                   **dict(OPTS, delta=1.0, polish_refine_iter=0))
    assert rt.info.status_val == 1 and rt.info.status_polish == -1
    _match(rt, rj)
    ls, lj = rt.linesearch, rj.linesearch
    for k in ('t', 'X', 'Z', 'Y'):
        assert getattr(ls, k).shape == getattr(lj, k).shape, k
        np.testing.assert_allclose(getattr(ls, k), getattr(lj, k), rtol=0, atol=LS_ATOL,
                                   err_msg=k)
    assert ls.t[0] == 0.0 and np.isclose(ls.t[-1], 0.002)
    np.testing.assert_allclose(ls.X[0], rt.x, rtol=0, atol=1e-12)
