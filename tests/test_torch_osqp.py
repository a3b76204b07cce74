"""The port's front end (osqp_tpu_torch.OSQP, device='cpu', float64) against
osqp_tpu.OSQP(algebra='jax') on the same problems.

Sparse mode (DIA operators, PCG) on tests/test_spmv.py's MPC-like QP and on
the banded family of examples/huge_banded_qp.py; dense direct and dense
indirect modes on the basic, primal-infeasible, unconstrained and
update-matrices families of tests/problems.py; vector and matrix updates and
warm starts.  Statuses and iteration counts must be identical, x and y within
1e-7.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu

import osqp_tpu_torch
from osqp_tpu_torch.exceptions import OSQPException
from osqp_tpu_torch.ops.spmv import DiaMatrix

import problems

ATOL = 1e-7


def _mpc_like_qp(T=14, seed=0):
    """tests/test_spmv.py's banded MPC-cascade QP."""
    rng = np.random.default_rng(seed)
    n = 2 * T
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.6), np.full(n - 1, -0.6)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = sp.eye(n, format='csc') + sp.diags([np.full(n - 2, 0.3)], [-2], shape=(n, n))
    return P, q, A.tocsc(), -np.ones(n) * 2, np.ones(n) * 2


def _banded_qp(n, seed=0):
    """examples/huge_banded_qp.py's family: tridiagonal P, A = I + 0.5 S_{-2}."""
    rng = np.random.default_rng(seed)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.9), np.full(n - 1, -0.9)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = (sp.eye(n) + sp.diags([np.full(n - 2, 0.5)], [-2], shape=(n, n))).tocsc()
    return P, q, A, -1.5 * np.ones(n), 1.5 * np.ones(n)


def _update_family():
    f = problems.update_matrices_family()
    return f['P'], f['q'], f['A'], f['l'], f['u']


def _pair(prob, sparse, **settings):
    P, q, A, l, u = prob
    kw = dict(verbose=False, polishing=False, **settings)
    j = osqp_tpu.OSQP(algebra='jax', sparse=sparse)
    j.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    t = osqp_tpu_torch.OSQP(device='cpu', sparse=sparse)
    t.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    return j, t


def _match(rt, rj):
    assert rt.info.status == rj.info.status
    assert rt.info.status_val == rj.info.status_val
    assert rt.info.iter == rj.info.iter
    assert rt.info.rho_updates == rj.info.rho_updates
    for k in ('x', 'y'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0, atol=ATOL)
    # the certificates are the last iterate differences, which grow on an
    # infeasible problem: held relative to their size
    for k in ('prim_inf_cert', 'dual_inf_cert'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=1e-6, atol=ATOL)
    for k in ('obj_val', 'dual_obj_val', 'prim_res', 'dual_res'):
        np.testing.assert_allclose(getattr(rt.info, k), getattr(rj.info, k), rtol=1e-6,
                                   atol=ATOL)
    assert set(vars(rt.info)) == set(vars(rj.info)) | {'cg_iters', 'host_syncs'}


def _solve_both(j, t):
    rj, rt = j.solve(raise_error=False), t.solve(raise_error=False)
    _match(rt, rj)
    return rt


def test_sparse_mpc_like_with_updates(monkeypatch):
    """Sparse mode on the MPC-like QP: auto-picked DIA operators, then
    update(q), update(l, u), update(Px, Ax) and warm_start, each followed by
    a solve that matches the JAX package's."""
    monkeypatch.delenv('OSQP_TPU_SPARSE_FORMAT', raising=False)
    P, q, A, l, u = _mpc_like_qp(seed=4)
    j, t = _pair((P, q, A, l, u), True, eps_abs=1e-6, eps_rel=1e-6)
    ts = t._solver
    assert (ts._sparse_fmt_P, ts._sparse_fmt_A) == ('dia', 'dia')
    assert (j._solver._sparse_fmt_P, j._solver._sparse_fmt_A) == ('dia', 'dia')
    assert isinstance(ts._data.P, DiaMatrix) and ts._indirect
    r0 = _solve_both(j, t)
    assert r0.info.status == 'solved' and r0.info.cg_iters > 0 and r0.info.host_syncs > 0

    rng = np.random.default_rng(5)
    q2 = q + 0.25 * rng.standard_normal(q.shape)
    for s in (j, t):
        s.update(q=q2)
    _solve_both(j, t)

    l2, u2 = l + 0.1, u - 0.1
    l2[:3] = u2[:3] = 0.5  # three rows become equalities: retyped, refactored
    for s in (j, t):
        s.update(l=l2, u=u2)
    _solve_both(j, t)

    P_triu = sp.triu(P, format='csc')
    offsets_P = ts._data.P.offsets
    for s in (j, t):
        s.update(Px=1.1 * P_triu.data, Ax=0.9 * A.data)
    r = _solve_both(j, t)
    assert r.info.status == 'solved'
    assert ts._data.P.offsets == offsets_P  # the pinned DIA structure survives

    for s in (j, t):
        s.warm_start(x=r0.x, y=r0.y)
    _solve_both(j, t)


def test_sparse_banded_family():
    """The banded family of examples/huge_banded_qp.py at n = 4096, sparse
    mode, a cold solve and a warm update(q)."""
    P, q, A, l, u = _banded_qp(4096)
    j, t = _pair((P, q, A, l, u), True, eps_abs=1e-5, eps_rel=1e-5)
    assert isinstance(t._solver._data.A, DiaMatrix)
    assert _solve_both(j, t).info.status == 'solved'
    for s in (j, t):
        s.update(q=1.01 * q)
    _solve_both(j, t)


_DENSE = {
    'basic': problems.basic_qp,
    'primal_infeasible': problems.primal_infeasible,
    'unconstrained': problems.unconstrained,
    'update_matrices': _update_family,
}


@pytest.mark.parametrize('solver_type', ['direct', 'indirect'])
@pytest.mark.parametrize('name', list(_DENSE))
def test_dense_modes(name, solver_type):
    """Dense direct (Cholesky) and dense indirect (PCG on dense matvecs)."""
    prob = _DENSE[name]()
    j, t = _pair(prob, False, eps_abs=1e-6, eps_rel=1e-6, solver_type=solver_type)
    assert t.solver_type == solver_type and not t._solver._is_sparse
    r = _solve_both(j, t)
    want = {'primal_infeasible': 'primal infeasible'}.get(name, 'solved')
    assert r.info.status == want
    if name == 'update_matrices':
        f = problems.update_matrices_family()
        for s in (j, t):
            s.update(Px=sp.triu(f['P_new']).tocsc().data, Ax=f['A_new'].data)
        _solve_both(j, t)
    if name == 'basic':  # a cold solve cut short: the post-loop 10x check decides
        for s in (j, t):
            s.update_settings(max_iter=30, warm_starting=False)
        assert _solve_both(j, t).info.status_val in (2, 7)


_FAMILIES = {
    'dual_infeasible_lp': problems.dual_infeasible_lp,
    'dual_infeasible_qp': problems.dual_infeasible_qp,
    'primal_dual_infeasible': problems.primal_dual_infeasible,
    'non_convex': problems.non_convex,
    'feasibility': problems.feasibility,
    'warm_start_big': problems.warm_start_big,
}


@pytest.mark.parametrize('solver_type', ['direct', 'indirect'])
@pytest.mark.parametrize('name', list(_FAMILIES))
def test_more_families(name, solver_type):
    """The infeasible, non-convex, feasibility and warm-start families of
    tests/problems.py, dense, eps 1e-5: statuses and iteration counts equal,
    x and y within 1e-8 where solved; elsewhere the iterates and certificates
    (which grow on these problems: y reaches 1e7 on ``non_convex``) within
    1e-6 relative.  ``non_convex`` direct fails at setup on both
    (error 4, the factorization's inertia check).  ``feasibility`` indirect
    is held to tests/test_feasibility.py's rule, solved or max-iter on both:
    its CG solves run into cg_max_iter and the two drift apart from the
    third iteration, as the JAX package drifts from itself under a 1e-15
    change of u."""
    prob = _FAMILIES[name]()
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, solver_type=solver_type)
    if name == 'non_convex' and solver_type == 'direct':
        P, q, A, l, u = prob
        for s in (osqp_tpu.OSQP(algebra='jax'), osqp_tpu_torch.OSQP(device='cpu')):
            with pytest.raises(Exception) as err:
                s.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, **kw)
            assert err.value == osqp_tpu_torch.SolverError.OSQP_NONCVX_ERROR
        return
    j, t = _pair(prob, False, **kw)
    if name == 'feasibility' and solver_type == 'indirect':
        for s in (j, t):
            assert s.solve(raise_error=False).info.status_val in (
                s.constant('OSQP_MAX_ITER_REACHED'), s.constant('OSQP_SOLVED'))
        return
    rj = j.solve(raise_error=False)
    rt = t.solve(raise_error=False)
    for k in ('status', 'status_val', 'iter', 'rho_updates'):
        assert getattr(rt.info, k) == getattr(rj.info, k), k
    solved = rt.info.status == 'solved'
    for k in ('x', 'y', 'prim_inf_cert', 'dual_inf_cert'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0 if solved else 1e-6,
                                   atol=1e-8 if solved else ATOL)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        osqp_tpu_torch.OSQP()


def test_unported_settings_raise():
    """Polishing, a time limit and verbose printing are accepted at setup and
    through update_settings; code generation (ported since) raises an
    AssertionError on an unknown ``parameters``, the derivative API (ported
    since) a ValueError before its adjoint is computed, and a wrong-length
    update OSQPException."""
    P, q, A, l, u = problems.basic_qp()
    for opt in (dict(polishing=True), dict(time_limit=1.0), dict(verbose=True)):
        s = osqp_tpu_torch.OSQP(device='cpu')
        s.setup(P=P, q=q, A=A, l=l, u=u, **{'verbose': False, **opt})
        assert s.solve(raise_error=True).info.status == 'solved'
    s = osqp_tpu_torch.OSQP(device='cpu')
    s.setup(P=P, q=q, A=A, l=l, u=u, verbose=False)
    s.update_settings(polishing=True, time_limit=1.0)
    assert s.solve(raise_error=True).info.status_polish == 1
    with pytest.raises(AssertionError, match='Unknown parameters'):
        s.codegen('out', parameters='all')
    with pytest.raises(ValueError, match='adjoint_derivative_compute first'):
        s.adjoint_derivative_get_vec()
    with pytest.raises(OSQPException):
        s.update(q=np.ones(3))  # wrong length
