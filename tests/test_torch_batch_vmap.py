"""The port's vmap batch engine (osqp_tpu_torch.solver.core_batched and
BatchedOSQP with per-instance P and A) against the JAX package's on the same
data, on the CPU.

At float64 the two agree in statuses, iteration counts, rho updates and CG
steps exactly, in solutions to 1e-8, in the adapted rho to 1e-6 relative
and in the closing rho estimate to 1e-6 relative (see
``_assert_rho_estimate`` for instances that converged far below their
tolerance).  At float32
statuses are equal, iteration counts within one check epoch and solutions
within 1e-3.  Every test uses one shape, so the JAX programs compile once
per engine mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu.batch import BatchedOSQP as JaxBatchedOSQP
from osqp_tpu.batch import _solve_batch as jax_solve_batch

from osqp_tpu_torch import BatchedOSQP
from osqp_tpu_torch.batch import _setup_batch, _solve_batch
from osqp_tpu_torch.convert import from_jax_batch
from osqp_tpu_torch.settings import OracleSettings, core_settings
from osqp_tpu_torch.solver import core_batched as cb

B, N, M = 6, 6, 9
EPS = 1e-6


def _random_batch(seed, B=B, n=N, m=M):
    """tests/test_batch.py's family: P = 0.1 L L' + 0.1 I per instance, A
    Gaussian, bounds around a feasible point."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n))
    P = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m))
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    l = u - 2 * s0
    return P, q, A, l, u


def _infeasible_batch():
    """tests/test_batch.py:101: instance 2 primal infeasible through two
    contradictory copies of one row."""
    P, q, A, l, u = _random_batch(4)
    A[2, 1] = A[2, 0]
    l[2, 1] = u[2, 0] + 1.0
    u[2, 1] = u[2, 0] + 1.5
    return P, q, A, l, u


def _jax_state(j):
    return tuple(tuple(np.asarray(v) for v in nt)
                 for nt in (j._data, j._scal, j._rho, j._factor, j._iterates))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_rho_estimate(got, want, pri_res):
    """The closing rho estimate, rho * sqrt(pri / dua) of the relative
    residuals at the final iterate, to 1e-6 relative.  An instance whose
    primal residual ended below 1e-8 (far below eps) takes 1e-4: there the
    residual is a difference of O(1) terms that keeps only about 1e-16 /
    pri_res of relative precision, so iterates that agree to 1e-15 move the
    estimate by up to 2e-5 (measured: 1.8e-5 at pri_res 2.5e-10)."""
    got, want = np.asarray(got), np.asarray(want)
    rtol = np.where(np.asarray(pri_res) >= 1e-8, 1e-6, 1e-4)
    assert (np.abs(got - want) <= rtol * np.abs(want)).all(), (got, want, pri_res)


def _assert_result_match(got, want, cg=False):
    """Two SolveResults of the batch (tensors or JAX arrays)."""
    np.testing.assert_array_equal(_np(got.status), np.asarray(want.status))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    np.testing.assert_array_equal(_np(got.rho_updates), np.asarray(want.rho_updates))
    if cg:
        np.testing.assert_array_equal(_np(got.cg_iters), np.asarray(want.cg_iters))
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.y), np.asarray(want.y), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.rho.rho), np.asarray(want.rho.rho), rtol=1e-6)
    _assert_rho_estimate(_np(got.rho_estimate), want.rho_estimate, want.pri_res)


def _assert_info_match(got, want):
    """Two BatchedOSQP.solve() results."""
    np.testing.assert_array_equal(got.info.status_val, want.info.status_val)
    np.testing.assert_array_equal(got.info.iter, want.info.iter)
    np.testing.assert_array_equal(got.info.rho_updates, want.info.rho_updates)
    assert got.info.status == want.info.status
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.y, want.y, rtol=0, atol=1e-8)
    _assert_rho_estimate(got.info.rho_estimate, want.info.rho_estimate, want.info.prim_res)
    np.testing.assert_allclose(got.info.obj_val, want.info.obj_val, rtol=1e-9)
    # residuals near convergence are differences of O(1) terms: held to
    # 1e-6 relative or 1e-4 of the tolerance (EPS) that decides on them
    for k in ('prim_res', 'dual_res'):
        np.testing.assert_allclose(getattr(got.info, k), getattr(want.info, k), rtol=1e-6,
                                   atol=1e-4 * EPS)


@pytest.mark.parametrize('kkt_method, solver_type', [
    ('chol', 'direct'), ('inv', 'direct'), ('chol', 'indirect')])
def test_setup_matches_jax(kkt_method, solver_type):
    """_setup_batch on the same data, float64: scaled data, each instance's
    scaling, rho typing (one loose and one equality row) and factor."""
    P, q, A, l, u = _random_batch(1)
    l[:, 0], u[:, 0] = -1e30, 1e30
    u[:, 1] = l[:, 1]
    j = JaxBatchedOSQP(dtype=jnp.float64, kkt_method=kkt_method)
    j.setup(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS, solver_type=solver_type)
    t = BatchedOSQP(device='cpu', kkt_method=kkt_method)
    t.setup(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS, solver_type=solver_type)
    assert t._engine == j._engine == 'vmap'
    got = (t._data, t._scal, t._rho, t._factor)
    for g_nt, w_nt in zip(got, _jax_state(j)):
        for g, w in zip(g_nt, w_nt):
            if g is None:
                assert w.size == 0
                continue
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-14)
    assert (t._rho.constr_type[:, :2].numpy() == [-1, 1]).all()


@pytest.mark.parametrize('kkt_method, solver_type', [
    ('chol', 'direct'), ('inv', 'direct'), ('chol', 'indirect')])
def test_solve_from_jax_state_f64(kkt_method, solver_type):
    """The loop alone: both packages' _solve_batch from the JAX package's
    setup state (from_jax_batch), float64.  Statuses, iterations, rho
    updates and (indirect) CG steps equal; x and y to 1e-8."""
    P, q, A, l, u = _random_batch(2)
    j = JaxBatchedOSQP(dtype=jnp.float64, kkt_method=kkt_method)
    j.setup(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS, solver_type=solver_type)
    indirect = solver_type == 'indirect'
    want = jax_solve_batch(j._data, j._scal, j._core_settings(), j._rho, j._factor,
                           j._iterates, indirect=indirect, kkt_method=kkt_method)
    data, scal, rho, factor, iterates = from_jax_batch(_jax_state(j), 'cpu', torch.float64)
    stg = core_settings(OracleSettings(eps_abs=EPS, eps_rel=EPS), torch.float64)
    got = _solve_batch(data, scal, stg, rho, factor, iterates, indirect, kkt_method)
    assert (got.status.numpy() == 1).all()
    assert got.rho_updates.numpy().sum() > 0
    _assert_result_match(got, want, cg=indirect)
    if indirect:
        assert (got.cg_iters.numpy() > 0).all()
        # one sync per CG step of the batch plus one per epoch
        assert got.host_syncs > got.cg_iters.numpy().max()
    np.testing.assert_allclose(got.obj_val.numpy(), np.asarray(want.obj_val), rtol=1e-9)
    np.testing.assert_allclose(got.primdual_acc.numpy(), np.asarray(want.primdual_acc),
                               rtol=1e-6)


def test_batched_osqp_vmap_matches_jax():
    """BatchedOSQP(engine='vmap') end to end against osqp_tpu's, float64:
    setup, solve, update(q), update(l, u), warm_start, solve_device; and a
    pair set up with warm_starting=False through two updates."""
    P, q, A, l, u = _random_batch(3)
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False)
    j = JaxBatchedOSQP(dtype=jnp.float64, engine='vmap')
    t = BatchedOSQP(device='cpu', engine='vmap')
    j.setup(P, q, A, l, u, **kw)
    t.setup(P, q, A, l, u, **kw)
    r1 = j.solve()
    _assert_info_match(t.solve(), r1)

    rng = np.random.default_rng(5)
    q2 = q + 0.05 * rng.standard_normal(q.shape)
    for s in (j, t):
        s.update(q=q2)
    _assert_info_match(t.solve(), j.solve())

    l2, u2 = l - 0.1, u + 0.2 * rng.random(u.shape)
    for s in (j, t):
        s.update(l=l2, u=u2)
    _assert_info_match(t.solve(), j.solve())

    for s in (j, t):
        s.warm_start(x=r1.x, y=r1.y)
    _assert_info_match(t.solve(), j.solve())

    # solve_device: from the current state, nothing applied or stored
    for s in (j, t):
        s.update(q=q)
    got, want = t.solve_device(), j.solve_device()
    assert isinstance(got.x, torch.Tensor) and got.x.shape == (B, N)
    _assert_result_match(got, want)
    _assert_info_match(t.solve(), j.solve())

    jc = JaxBatchedOSQP(dtype=jnp.float64, engine='vmap')
    tc = BatchedOSQP(device='cpu', engine='vmap')
    for s in (jc, tc):
        s.setup(P, q, A, l, u, warm_starting=False, **kw)
    _assert_info_match(tc.solve(), jc.solve())
    for s in (jc, tc):
        s.update(q=q2)
    _assert_info_match(tc.solve(), jc.solve())
    for s in (jc, tc):
        s.update(q=q)
    _assert_info_match(tc.solve(), jc.solve())


def test_infeasible_instance_certificate_matches_jax():
    """A batch with one primal-infeasible instance (tests/test_batch.py:101),
    float64: statuses and iterations equal; the certificate to 1e-6
    relative; x NaN there and equal elsewhere."""
    P, q, A, l, u = _infeasible_batch()
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False)
    rj = JaxBatchedOSQP(dtype=jnp.float64).setup(P, q, A, l, u, **kw).solve()
    rt = BatchedOSQP(device='cpu').setup(P, q, A, l, u, **kw).solve()
    st = rt.info.status_val
    assert st[2] == 3 and (np.delete(st, 2) == 1).all()
    np.testing.assert_array_equal(st, rj.info.status_val)
    np.testing.assert_array_equal(rt.info.iter, rj.info.iter)
    np.testing.assert_allclose(rt.prim_inf_cert[2], rj.prim_inf_cert[2], rtol=1e-6,
                               atol=1e-12)
    assert np.isnan(rt.x[2]).all() and np.isnan(rj.x[2]).all()
    np.testing.assert_allclose(np.delete(rt.x, 2, 0), np.delete(rj.x, 2, 0), rtol=0,
                               atol=1e-8)


def test_float32_inv_matches_jax():
    """float32 with kkt_method 'auto' (the explicit inverse): statuses
    equal, iterations within one check epoch, x within 1e-3."""
    P, q, A, l, u = _random_batch(6)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, verbose=False)
    j = JaxBatchedOSQP(dtype=jnp.float32)
    t = BatchedOSQP(dtype=torch.float32, device='cpu')
    j.setup(P, q, A, l, u, **kw)
    t.setup(P, q, A, l, u, **kw)
    assert t._kkt_method == j._kkt_method == 'inv'
    assert t._factor.Minv.dtype == torch.float32
    rj, rt = j.solve(), t.solve()
    np.testing.assert_array_equal(rt.info.status_val, rj.info.status_val)
    assert (rt.info.status_val == 1).all()
    assert np.abs(rt.info.iter - rj.info.iter).max() <= 25
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-3)


@pytest.mark.parametrize('batched', ['P', 'A', 'both', 'neither'])
def test_engine_auto_picks_vmap_for_batched_P_or_A(batched):
    """engine='auto' takes the vmap engine when P or A carries a batch axis,
    as osqp_tpu's does, and the shared engine when neither does; a shared
    matrix broadcast into the vmap engine gives the same solve as passing it
    batched."""
    P, q, A, l, u = _random_batch(7)
    Pa = P if batched in ('P', 'both') else P[0]
    Aa = A if batched in ('A', 'both') else A[0]
    lb, ub = (l, u) if batched == 'both' else (-2 * np.ones((B, M)), 2 * np.ones((B, M)))
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, verbose=False)
    j = JaxBatchedOSQP(dtype=jnp.float64)
    t = BatchedOSQP(device='cpu')
    j.setup(Pa, q, Aa, lb, ub, **kw)
    t.setup(Pa, q, Aa, lb, ub, **kw)
    want = 'shared' if batched == 'neither' else 'vmap'
    assert t._engine == j._engine == want
    if want == 'vmap':
        full = BatchedOSQP(device='cpu', engine='vmap').setup(
            np.broadcast_to(Pa, (B, N, N)), q, np.broadcast_to(Aa, (B, M, N)), lb, ub, **kw)
        got, ref = t.solve(), full.solve()
        np.testing.assert_array_equal(got.info.iter, ref.info.iter)
        np.testing.assert_array_equal(got.x, ref.x)


def test_non_pd_instance_poisons_no_other():
    """An instance whose KKT matrix is not positive definite gets a NaN
    factor of its own; every other instance's factor equals the one set up
    without it, and every other instance solves as it would alone."""
    P, q, A, l, u = _random_batch(8)
    P[1] = -np.eye(N)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=200, verbose=False)
    t = BatchedOSQP(device='cpu').setup(P, q, A, l, u, **kw)
    keep = np.r_[0, 2:B]
    ref = BatchedOSQP(device='cpu').setup(P[keep], q[keep], A[keep], l[keep], u[keep], **kw)
    assert torch.isnan(t._factor.L[1]).all()
    torch.testing.assert_close(t._factor.L[keep], ref._factor.L, rtol=0, atol=0)
    got, want = t.solve(), ref.solve()
    assert got.info.status_val[1] != 1
    np.testing.assert_array_equal(got.info.status_val[keep], want.info.status_val)
    np.testing.assert_array_equal(got.info.iter[keep], want.info.iter)
    np.testing.assert_allclose(got.x[keep], want.x, rtol=0, atol=1e-12)


def test_batched_cholesky_and_pcg_per_instance():
    """cb.cholesky leaves a NaN factor only where the matrix fails, and the
    batched PCG stops each instance on its own test: the step counts equal
    those of one-instance runs."""
    rng = np.random.default_rng(9)
    n = 7
    G = rng.standard_normal((4, n, n))
    Mats = torch.tensor(np.einsum('bij,bkj->bik', G, G) + np.eye(n) * [[[0.1]], [[1]],
                                                                       [[10]], [[100]]])
    Mats[2] = -Mats[2]
    L = cb.cholesky(Mats)
    assert torch.isnan(L[2]).all() and not torch.isnan(L[[0, 1, 3]]).any()
    Pm = Mats.clone()
    Pm[2] = torch.eye(n, dtype=torch.float64)
    A = torch.zeros((4, 0, n), dtype=torch.float64)
    b = torch.tensor(rng.standard_normal((4, n)))
    diag = torch.diagonal(Pm, dim1=-2, dim2=-1)
    tol = torch.full((4,), 1e-10, dtype=torch.float64)
    live = torch.ones(4, dtype=torch.bool)
    counter = cb._Counter()
    x, k = cb.pcg_solve(Pm, A, 0.0, None, diag, b, torch.zeros_like(b), tol, 50, live, counter)
    assert counter.syncs == int(k.max()) + 1
    for i in range(4):
        xi, ki = cb.pcg_solve(Pm[i:i + 1], A[i:i + 1], 0.0, None, diag[i:i + 1], b[i:i + 1],
                              torch.zeros_like(b[i:i + 1]), tol[:1], 50, live[:1],
                              cb._Counter())
        assert int(ki[0]) == int(k[i])
        torch.testing.assert_close(xi[0], x[i], rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.linalg.solve(Pm, b), x, rtol=0, atol=1e-8)
