"""The port's differentiable layers (osqp_tpu_torch.nn.torch.OSQP and
osqp_tpu_torch.nn.layer.make_qp_layer) against the JAX package's on the same
data, on the CPU in float64: x and the gradients of all five inputs within
1e-6 relative to each gradient's max-norm, and the gradients against finite
differences under tests/test_nn.py's tolerances."""

import numpy as np
import pytest
import scipy.sparse as spa
import torch

import jax
import jax.numpy as jnp

from osqp_tpu.nn.layer import make_qp_layer as jax_make_qp_layer
from osqp_tpu.nn.torch import OSQP as JaxTorchOSQP

from osqp_tpu_torch.nn import torch as tnn
from osqp_tpu_torch.nn.layer import QPLayerResult, _adjoint_system, make_qp_layer

_EPS = 1e-10
_FD_H = 1e-6
_FD_TOL = dict(rtol=5e-3, atol=5e-3)
_MAX_ITER = 100000


def _pattern_problem(B, n, m, seed=1):
    """tests/test_nn.py's problem: one sparsity pattern, per-instance q and
    bounds around a feasible point."""
    npr = np.random.RandomState(seed)
    L = npr.randn(n, n)
    P = spa.coo_matrix(np.triu(L @ L.T + 0.5 * np.eye(n)))
    A = spa.coo_matrix(npr.randn(m, n))
    q = npr.randn(B, n)
    x0 = npr.randn(B, n)
    s0 = npr.rand(B, m)
    u = np.einsum('mn,bn->bm', A.toarray(), x0) + s0
    l = u - 2 * s0
    return P, A, q, l, u, npr.randn(B, n)


def _dense_problem(B, n, m, seed=0):
    """tests/test_nn.py's make_qp_layer problem: each instance its own P, A."""
    npr = np.random.RandomState(seed)
    L = npr.randn(B, n, n)
    P = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.2 * np.eye(n)
    q = npr.randn(B, n)
    A = npr.randn(B, m, n)
    x0 = npr.randn(B, n)
    s0 = npr.rand(B, m)
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    return P, q, A, u - 2 * s0, u, npr.randn(B, n)


def _module_run(cls, P, A, vals, target):
    """x and the gradients of 0.5 ||x - target||^2 through an OSQP module."""
    layer = cls((P.row, P.col), P.shape, (A.row, A.col), A.shape, eps_rel=_EPS, eps_abs=_EPS,
                max_iter=_MAX_ITER)
    ts = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in vals]
    x = layer(*ts)
    (0.5 * ((x - torch.tensor(target)) ** 2).sum()).backward()
    return [x.detach().numpy()] + [t.grad.numpy() for t in ts]


def _assert_rel(got, want, tol=1e-6):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-300)
        assert np.abs(g - w).max() <= tol * scale, (np.abs(g - w).max(), scale)


@pytest.mark.parametrize('case', ['batched', 'unbatched', 'shared_matrices'])
def test_torch_layer_matches_jax(case):
    """x and all five gradients equal osqp_tpu.nn.torch.OSQP's: a batch, a
    single QP given as 1-D tensors, and a batch whose P and A values are 1-D
    (shared: their gradients sum over the batch)."""
    B = 1 if case == 'unbatched' else 3
    P, A, q, l, u, target = _pattern_problem(B, 6, 4, seed=2 if case == 'unbatched' else 1)
    if case == 'unbatched':
        vals, target = (P.data, q[0], A.data, l[0], u[0]), target[0]
    elif case == 'shared_matrices':
        vals = (P.data, q, A.data, l, u)
    else:
        vals = (np.tile(P.data, (B, 1)), q, np.tile(A.data, (B, 1)), l, u)
    got = _module_run(tnn.OSQP, P, A, vals, target)
    want = _module_run(JaxTorchOSQP, P, A, vals, target)
    assert got[0].shape == ((6,) if case == 'unbatched' else (B, 6))
    _assert_rel(got, want)


def test_torch_layer_gradients_match_finite_differences():
    """dLoss/dq of the port's module against central differences
    (tests/test_nn.py::test_torch_layer_gradients)."""
    B, n, m = 3, 6, 4
    P, A, q, l, u, target = _pattern_problem(B, n, m)
    layer = tnn.OSQP((P.row, P.col), P.shape, (A.row, A.col), A.shape, eps_rel=_EPS,
                     eps_abs=_EPS, max_iter=_MAX_ITER)
    mats = [torch.tensor(np.tile(M.data, (B, 1))) for M in (P, A)]
    lt, ut, tt = (torch.tensor(v) for v in (l, u, target))
    q_val = torch.tensor(q, requires_grad=True)
    x = layer(mats[0], q_val, mats[1], lt, ut)
    (0.5 * ((x - tt) ** 2).sum()).backward()

    def f(qv):
        with torch.no_grad():
            return float(0.5 * ((layer(mats[0], torch.tensor(qv), mats[1], lt, ut) - tt) ** 2)
                         .sum())

    for b, i in [(0, 1), (1, 2), (2, 4)]:
        qp, qm = q.copy(), q.copy()
        qp[b, i] += _FD_H
        qm[b, i] -= _FD_H
        fd = (f(qp) - f(qm)) / (2 * _FD_H)
        np.testing.assert_allclose(q_val.grad.numpy()[b, i], fd, **_FD_TOL)


def test_make_qp_layer_matches_jax():
    """make_qp_layer's x and the gradients of all five inputs equal
    osqp_tpu.nn.layer.make_qp_layer's, float64."""
    P, q, A, l, u, target = _dense_problem(2, 6, 4)
    jl = jax_make_qp_layer(dtype=jnp.float64, eps_abs=_EPS, eps_rel=_EPS, max_iter=_MAX_ITER)

    def jloss(*args):
        return 0.5 * jnp.sum((jl(*args) - target) ** 2)

    args = [jnp.asarray(v) for v in (P, q, A, l, u)]
    want = [np.asarray(jl(*args))] + [np.asarray(g) for g in
                                      jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*args)]
    tl = make_qp_layer(dtype=torch.float64, eps_abs=_EPS, eps_rel=_EPS, max_iter=_MAX_ITER)
    ts = [torch.tensor(v, requires_grad=True) for v in (P, q, A, l, u)]
    x = tl(*ts)
    (0.5 * ((x - torch.tensor(target)) ** 2).sum()).backward()
    _assert_rel([x.detach().numpy()] + [t.grad.numpy() for t in ts], want)


def test_make_qp_layer_gradients_match_finite_differences():
    """dLoss/dq and dLoss/dl of make_qp_layer against central differences
    (tests/test_nn.py::test_jax_layer_gradients)."""
    P, q, A, l, u, target = _dense_problem(2, 6, 4)
    layer = make_qp_layer(dtype=torch.float64, eps_abs=_EPS, eps_rel=_EPS, max_iter=_MAX_ITER)
    Pt, At, lt, ut, tt = (torch.tensor(v) for v in (P, A, l, u, target))
    qt = torch.tensor(q, requires_grad=True)
    (0.5 * ((layer(Pt, qt, At, lt, ut) - tt) ** 2).sum()).backward()

    def loss(qv):
        with torch.no_grad():
            return float(0.5 * ((layer(Pt, torch.tensor(qv), At, lt, ut) - tt) ** 2).sum())

    b, i = 1, 2
    qp, qm = q.copy(), q.copy()
    qp[b, i] += _FD_H
    qm[b, i] -= _FD_H
    fd = (loss(qp) - loss(qm)) / (2 * _FD_H)
    np.testing.assert_allclose(qt.grad.numpy()[b, i], fd, **_FD_TOL)


def test_adjoint_system_is_per_instance():
    """The batched adjoint of a batch equals the adjoints of its instances
    solved one by one."""
    P, q, A, l, u, target = _dense_problem(3, 5, 4, seed=4)
    layer = make_qp_layer(dtype=torch.float64, eps_abs=_EPS, eps_rel=_EPS, max_iter=_MAX_ITER)
    from osqp_tpu_torch.batch import batch_qp_solve, default_core_settings
    stg = default_core_settings(torch.float64, eps_abs=_EPS, eps_rel=_EPS, max_iter=_MAX_ITER)
    ts = [torch.tensor(v) for v in (P, q, A, l, u)]
    res = batch_qp_solve(*ts, stg, torch.full((3,), 0.1, dtype=torch.float64))
    torch.testing.assert_close(layer(*ts), res.x, rtol=0, atol=0)
    dx = torch.tensor(target)
    full = _adjoint_system(ts[0], ts[2], ts[3], ts[4], res.x, res.y, dx, torch.zeros_like(res.y),
                           1e-9, 4)
    for b in range(3):
        one = _adjoint_system(ts[0][b:b + 1], ts[2][b:b + 1], ts[3][b:b + 1], ts[4][b:b + 1],
                              res.x[b:b + 1], res.y[b:b + 1], dx[b:b + 1],
                              torch.zeros_like(res.y[b:b + 1]), 1e-9, 4)
        for g_full, g_one in zip(full, one):
            torch.testing.assert_close(g_full[b], g_one[0], rtol=1e-12, atol=1e-12)
    assert QPLayerResult._fields == ('x', 'y', 'status', 'iters')


def test_torch_layer_raises_on_unsolved_instance():
    """A batch with a primal-infeasible instance raises RuntimeError naming
    the status, as osqp_tpu's module does."""
    B, n, m = 2, 4, 3
    P, A, q, l, u, _ = _pattern_problem(B, n, m, seed=3)
    A = spa.coo_matrix(np.vstack([A.toarray()[:2], A.toarray()[:1]]))
    l, u = l.copy(), u.copy()
    l[1, 2], u[1, 2] = u[1, 0] + 1.0, u[1, 0] + 2.0
    layer = tnn.OSQP((P.row, P.col), P.shape, (A.row, A.col), A.shape, max_iter=4000)
    with pytest.raises(RuntimeError, match='primal infeasible'):
        layer(torch.tensor(np.tile(P.data, (B, 1))), torch.tensor(q),
              torch.tensor(np.tile(A.data, (B, 1))), torch.tensor(l), torch.tensor(u))


def test_solver_dtype_default_and_override(monkeypatch):
    """float64 by default (native on the CPU and the H100);
    OSQP_TPU_NN_DTYPE=float32 solves in float32, within 1e-3 of float64."""
    monkeypatch.delenv('OSQP_TPU_NN_DTYPE', raising=False)
    assert tnn._solver_dtype() == torch.float64
    P, A, q, l, u, _ = _pattern_problem(3, 6, 4)
    vals = [torch.tensor(v) for v in (np.tile(P.data, (3, 1)), q, np.tile(A.data, (3, 1)),
                                      l, u)]

    def solve():
        return tnn.OSQP((P.row, P.col), P.shape, (A.row, A.col), A.shape, eps_rel=1e-5,
                        eps_abs=1e-5)(*vals)

    x64 = solve()
    monkeypatch.setenv('OSQP_TPU_NN_DTYPE', 'float32')
    assert tnn._solver_dtype() == torch.float32
    x32 = solve()
    assert x32.dtype == torch.float64
    torch.testing.assert_close(x32, x64, rtol=0, atol=1e-3)
