"""The port's pure batched entry points, ``batch_qp_solve`` and
``mpc_rollout``, against the JAX package's on the same data, on the CPU in
float64: statuses and iteration counts equal, solutions to 1e-8."""

import numpy as np
import torch

import jax.numpy as jnp

from osqp_tpu.batch import BatchedOSQP as JaxBatchedOSQP
from osqp_tpu.batch import batch_qp_solve as jax_batch_qp_solve
from osqp_tpu.batch import default_core_settings as jax_default_core_settings
from osqp_tpu.batch import mpc_rollout as jax_mpc_rollout

from osqp_tpu_torch import BatchedOSQP
from osqp_tpu_torch import batch as tb
from osqp_tpu_torch.convert import from_jax_batch

B, N, M = 6, 6, 9
EPS = 1e-6
STEPS = 3


def _random_batch(seed):
    """tests/test_batch.py's family, each instance its own P and A."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, N, N))
    P = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.1 * np.eye(N)
    q = rng.standard_normal((B, N))
    A = rng.standard_normal((B, M, N))
    x0 = rng.standard_normal((B, N))
    s0 = rng.random((B, M))
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    return P, q, A, u - 2 * s0, u


def _q_seq(q, seed):
    noise = np.random.default_rng(seed).standard_normal((STEPS,) + q.shape)
    return q[None] + 0.05 * noise


def test_batch_qp_solve_matches_jax():
    """The fused pure solve: scale, factorize, ADMM from zero iterates."""
    P, q, A, l, u = _random_batch(11)
    jstg = jax_default_core_settings(jnp.float64, eps_abs=EPS, eps_rel=EPS)
    want = jax_batch_qp_solve(*(jnp.asarray(v) for v in (P, q, A, l, u)), jstg,
                              jnp.full((B,), 0.1))
    tstg = tb.default_core_settings(torch.float64, eps_abs=EPS, eps_rel=EPS)
    got = tb.batch_qp_solve(*(torch.tensor(v) for v in (P, q, A, l, u)), tstg,
                            torch.full((B,), 0.1, dtype=torch.float64))
    assert (got.status.numpy() == 1).all()
    for k in ('status', 'iters', 'rho_updates'):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    for k in ('x', 'y'):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.obj_val.numpy(), np.asarray(want.obj_val), rtol=1e-9)


def test_mpc_rollout_matches_jax():
    """A 3-step rollout from the JAX package's setup state: per-step x,
    iterations and statuses, and the final carry's iterates and rho."""
    P, q, A, l, u = _random_batch(12)
    j = JaxBatchedOSQP(dtype=jnp.float64)
    j.setup(P, q, A, l, u, eps_abs=EPS, eps_rel=EPS)
    q_seq = _q_seq(q, 13)
    jcarry, (jx, jit, jst) = jax_mpc_rollout(
        j._data, j._scal, j._core_settings(), j._rho, j._factor, j._iterates,
        jnp.asarray(q_seq))
    state = tuple(tuple(np.asarray(v) for v in nt)
                  for nt in (j._data, j._scal, j._rho, j._factor, j._iterates))
    data, scal, rho, factor, iterates = from_jax_batch(state, 'cpu', torch.float64)
    stg = tb.default_core_settings(torch.float64, eps_abs=EPS, eps_rel=EPS)
    carry, (x, its, st) = tb.mpc_rollout(data, scal, stg, rho, factor, iterates,
                                         torch.tensor(q_seq))
    assert x.shape == (STEPS, B, N) and (st.numpy() == 1).all()
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(its.numpy(), np.asarray(jit))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-8)
    for got, want in zip(carry[3], jcarry[3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry[1].rho.numpy(), np.asarray(jcarry[1].rho), rtol=1e-6)
    np.testing.assert_allclose(carry[0].q.numpy(), np.asarray(jcarry[0].q), rtol=1e-12)


def test_mpc_rollout_equals_step_by_step():
    """The rollout is BatchedOSQP's update(q) + solve loop: the same
    statuses, iterations and solutions, step for step, bit for bit; and
    mpc_rollout_donated is the same entry point."""
    P, q, A, l, u = _random_batch(14)
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False)
    q_seq = _q_seq(q, 15)
    s = BatchedOSQP(device='cpu').setup(P, q, A, l, u, **kw)
    state = (s._data, s._scal, s._rho, s._factor, s._iterates)
    stg = s._core_settings()
    _, (x, its, st) = tb.mpc_rollout_donated(*state[:2], stg, *state[2:],
                                             torch.tensor(q_seq))
    for k in range(STEPS):
        s.update(q=q_seq[k])
        r = s.solve()
        np.testing.assert_array_equal(st[k].numpy(), r.info.status_val)
        np.testing.assert_array_equal(its[k].numpy(), r.info.iter)
        np.testing.assert_array_equal(x[k].numpy(), r.x)
    assert tb.mpc_rollout_donated is tb.mpc_rollout
