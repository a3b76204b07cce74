"""The port's dp x mp batch (``osqp_tpu_torch.parallel.dp_mp_solve``) and its
batch shardings on the CPU, in float64, against the float64 oracle
(``osqp_tpu._oracle.solver.ReferenceSolver``) under ``tests/test_sharded.py``'s
own tolerances, and against one ``osqp_tpu.parallel.dp_mp_solve`` call.

A file of its own: the JAX call compiles for over a minute on the CPU, and
``--dist loadfile`` gives this file a worker of its own.
"""

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from osqp_tpu._oracle.solver import ReferenceSolver
from osqp_tpu.parallel.sharded import dp_mp_solve as jax_dp_mp_solve
from osqp_tpu_torch.batch import batch_qp_solve
from osqp_tpu_torch.constants import SolverStatus
from osqp_tpu_torch.parallel import dp_mp_solve, make_batch_shardings, make_mesh
from osqp_tpu_torch.settings import default_core_settings
from test_sharded import _random_batch

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the port's CPU loops issue many tiny
    torch ops, and with the default pool each sparse product or batched
    factorization wakes every core (bigqp: 8x the CPU time of one thread
    for the same wall), which starves the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape):
    return make_mesh(shape, ('dp', 'mp'), device='cpu')


def _oracle(P, q, A, l, u, **settings):
    ref = ReferenceSolver()
    ref.setup(sparse.csc_matrix(P), q, sparse.csc_matrix(A), l, u, verbose=False, **settings)
    return ref.solve()


@pytest.mark.parametrize('mesh_shape', [(2, 2), (4, 1), (1, 4)])
def test_dp_mp_iteration_parity_default_settings(mesh_shape):
    """At default settings (Ruiz, vector and adaptive rho, the duality-gap
    check): the oracle's statuses, iterations and rho updates exactly, x
    rtol 1e-6 atol 1e-7, y 1e-5/1e-6, obj 1e-8 (``tests/test_sharded.py``'s
    family and tolerances)."""
    B, n, m = 4, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=11, bad_scaling=True)
    eps = dict(eps_abs=1e-5, eps_rel=1e-5)
    res = dp_mp_solve(_mesh(mesh_shape), P, q, A, l, u, max_iter=1000, **eps)
    assert res.x.dtype == F64 and res.x.shape == (B, n) and res.y.shape == (B, m)
    assert (res.status == int(SolverStatus.OSQP_SOLVED)).all()
    assert res.host_syncs == int(res.iters.max()) // 25
    for b in range(B):
        sol, info = _oracle(P[b], q[b], A[b], l[b], u[b], max_iter=1000, **eps)
        assert int(res.status[b]) == info.status_val
        assert int(res.iters[b]) == info.iter
        assert int(res.rho_updates[b]) == info.rho_updates
        np.testing.assert_allclose(res.x[b].numpy(), sol.x, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res.y[b].numpy(), sol.y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(res.obj_val[b]), info.obj_val, rtol=1e-8, atol=1e-9)


def test_dp_mp_matches_jax_package():
    """One JAX call at (2, 2), B = 2, n = 8, m = 16: statuses, iterations
    and rho updates equal, x and y within 1e-8."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=3)
    eps = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000)
    jm = JaxMesh(np.array(jax.devices('cpu')[:4]).reshape(2, 2), ('dp', 'mp'))
    with jax.default_device(jax.devices('cpu')[0]):
        want = jax_dp_mp_solve(jm, jnp.asarray(P, jnp.float64), q, A, l, u, **eps)
    got = dp_mp_solve(_mesh((2, 2)), P, q, A, l, u, **eps)
    for name in ('status', 'iters', 'rho_updates'):
        np.testing.assert_array_equal(got._asdict()[name].numpy(), np.asarray(want._asdict()[name]))
    assert (got.status == 1).all()
    for name in ('x', 'y', 'z', 'obj_val', 'dual_obj_val', 'pri_res', 'dua_res'):
        np.testing.assert_allclose(got._asdict()[name].numpy(), np.asarray(want._asdict()[name]),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_dp_mp_primal_infeasible_certificate():
    """A primal-infeasible instance inside the batch: the oracle's statuses,
    NaN rows and a valid unscaled Farkas certificate."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=9)
    A[0, -2] = -A[0, -1]
    l[0, -2:] = [-1e30, -1e30]
    u[0, -2:] = [-1.0, -1.0]
    eps = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000)
    res = dp_mp_solve(_mesh((2, 2)), P, q, A, l, u, **eps)
    status = res.status.numpy()
    assert status[0] in (int(SolverStatus.OSQP_PRIMAL_INFEASIBLE),
                         int(SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE))
    assert status[1] == int(SolverStatus.OSQP_SOLVED)
    assert np.isnan(res.x[0].numpy()).all() and np.isfinite(res.x[1].numpy()).all()
    dy = res.prim_inf_cert[0].numpy()
    norm_dy = np.abs(dy).max()
    assert norm_dy > 0
    lhs = np.minimum(u[0], 1e30) @ np.maximum(dy, 0) + np.maximum(l[0], -1e30) @ np.minimum(dy, 0)
    assert lhs < 0
    assert np.abs(A[0].T @ dy).max() < 1e-3 * norm_dy
    for b in range(B):
        _, info = _oracle(P[b], q[b], A[b], l[b], u[b], **eps)
        assert info.status_val == status[b]
        assert info.iter == int(res.iters[b])


def test_dp_mp_dual_infeasible_certificate():
    """An unbounded LP instance: the oracle's status and a ray certificate."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=12)
    P[0] = 0.0
    u[0] = 1e30
    A[0] = np.abs(A[0])
    q[0] = np.abs(q[0]) + 0.1
    eps = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000)
    res = dp_mp_solve(_mesh((2, 2)), P, q, A, l, u, **eps)
    status = res.status.numpy()
    assert status[0] in (int(SolverStatus.OSQP_DUAL_INFEASIBLE),
                         int(SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE))
    dx = res.dual_inf_cert[0].numpy()
    norm_dx = np.abs(dx).max()
    assert norm_dx > 0 and q[0] @ dx < 0
    assert np.abs(P[0] @ dx).max() < 1e-3 * norm_dx
    for b in range(B):
        _, info = _oracle(P[b], q[b], A[b], l[b], u[b], **eps)
        assert info.status_val == status[b]
        assert info.iter == int(res.iters[b])


def test_dp_mp_warm_start():
    """A warm start at the solution stops at the first check."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=3)
    eps = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000)
    mesh = _mesh((2, 2))
    res = dp_mp_solve(mesh, P, q, A, l, u, **eps)
    assert (res.status == 1).all()
    res2 = dp_mp_solve(mesh, P, q, A, l, u, x0=res.x, y0=res.y, **eps)
    assert (res2.status == 1).all()
    assert (res2.iters <= 25).all() and (res2.iters < res.iters).all()


def test_dp_mp_polish():
    """The distributed polish reaches the oracle's high-accuracy polished
    optimum from a loose solve (``tests/test_sharded.py``'s tolerances)."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=5)
    res = dp_mp_solve(_mesh((2, 2)), P, q, A, l, u, eps_abs=1e-4, eps_rel=1e-4, max_iter=4000,
                      polish=True)
    assert (res.status == 1).all() and (res.status_polish == 1).all()
    for b in range(B):
        sol, _ = _oracle(P[b], q[b], A[b], l[b], u[b], eps_abs=1e-10, eps_rel=1e-10,
                         max_iter=200000, polishing=True)
        np.testing.assert_allclose(res.x[b].numpy(), sol.x, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res.y[b].numpy(), sol.y, rtol=1e-6, atol=1e-8)


def test_dp_mp_max_iter_and_errors():
    """A max-iter stop gives the oracle's status (10x approximate retry);
    B and m must divide by their axes."""
    B, n, m = 2, 8, 16
    P, q, A, l, u = _random_batch(B, n, m, seed=11, bad_scaling=True)
    res = dp_mp_solve(_mesh((2, 2)), P, q, A, l, u, eps_abs=1e-9, eps_rel=1e-9, max_iter=50)
    for b in range(B):
        _, info = _oracle(P[b], q[b], A[b], l[b], u[b], eps_abs=1e-9, eps_rel=1e-9, max_iter=50)
        assert int(res.status[b]) == info.status_val and int(res.iters[b]) == info.iter == 50
    with pytest.raises(ValueError, match='divide'):
        dp_mp_solve(_mesh((2, 2)), P, q, A[:, :15], l[:, :15], u[:, :15])
    with pytest.raises(ValueError, match='divide'):
        dp_mp_solve(_mesh((4, 1)), P, q, A, l, u)


def test_batch_shardings_split_join_batch_qp_solve():
    """dp-shard the port's batch_qp_solve with make_batch_shardings: each
    shard solves its block, the joined results equal the unsharded call's
    (iterations exactly, x within 1e-9)."""
    mesh = make_mesh((4,), ('dp',), device='cpu')
    B, n, m = 16, 8, 12
    P, q, A, l, u = (torch.tensor(a) for a in _random_batch(B, n, m, seed=9))
    rho = torch.full((B,), 0.1, dtype=F64)
    sh = make_batch_shardings(mesh)
    assert set(sh) == {'mat', 'vec', 'scalar'}
    stg = default_core_settings(F64, eps_abs=1e-8, eps_rel=1e-8)
    parts = [batch_qp_solve(*args, stg, r) for *args, r in zip(
        sh['mat'].split(P), sh['vec'].split(q), sh['mat'].split(A), sh['vec'].split(l),
        sh['vec'].split(u), sh['scalar'].split(rho))]
    assert all(p.x.shape == (B // 4, n) for p in parts)
    x = sh['vec'].join([p.x for p in parts])
    iters = sh['scalar'].join([p.iters for p in parts])
    ref = batch_qp_solve(P, q, A, l, u, stg, rho)
    assert (sh['scalar'].join([p.status for p in parts]) == 1).all()
    assert torch.equal(iters, ref.iters)
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), rtol=1e-9, atol=1e-10)
