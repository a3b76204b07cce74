"""The port's shared-structure engine (osqp_tpu_torch.batch_shared and
BatchedOSQP) against the JAX package on the same data, on the CPU.

At float64 the two must agree in statuses and iteration counts exactly and in
solutions to 1e-8.  At float32 only statuses are held equal and solutions to
1e-3: XLA and torch sum in other orders, which can move a termination check
by one epoch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu._oracle.solver import OracleSettings as JaxOracleSettings
from osqp_tpu.batch import BatchedOSQP as JaxBatchedOSQP
from osqp_tpu.batch import default_core_settings as jax_default_core_settings
from osqp_tpu import batch_shared as jbs

from osqp_tpu_torch import BatchedOSQP
from osqp_tpu_torch import batch_shared as tbs
from osqp_tpu_torch.constants import status_string
from osqp_tpu_torch.convert import from_jax_setup
from osqp_tpu_torch.settings import OracleSettings, default_core_settings


def _problems(B, n, m, seed=0):
    rng = np.random.default_rng(seed)
    Lm = rng.standard_normal((n, n)) / np.sqrt(n)
    P = Lm @ Lm.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m)) + 0.1
    u = x0 @ A.T + s0
    l = u - 2 * s0
    return P, A, q, l, u


def _np(args):
    """numpy copies of shared_setup's outputs, the scaling as a tuple."""
    P_s, A_s, Q, L_t, U_t, scal, rho0, Minv, M, rho_vec = args
    return (*(np.asarray(v) for v in (P_s, A_s, Q, L_t, U_t)),
            tuple(np.asarray(v) for v in scal), np.asarray(rho0),
            *(np.asarray(v) for v in (Minv, M, rho_vec)))


def _both_setups(B, n, m, seed, eps, jdtype, tdtype):
    P, A, q, l, u = _problems(B, n, m, seed=seed)
    jargs = jbs.shared_setup(P, A, q, l, u, JaxOracleSettings(eps_abs=eps, eps_rel=eps),
                             dtype=jdtype)
    zeros = (np.zeros((n, B)), np.zeros((m, B)), np.zeros((m, B)))
    targs = from_jax_setup((*_np(jargs), *zeros), 'cpu', tdtype)
    return (P, A, q, l, u), jargs, targs


def test_shared_setup_matches_jax():
    """Ruiz scaling, scaled data, rho typing and the explicit inverse, f64."""
    B, n, m = 10, 9, 14
    P, A, q, l, u = _problems(B, n, m, seed=2)
    l[:, 0] = -np.inf  # one loose row
    u[:, 1] = l[:, 1]  # one equality row
    jargs = jbs.shared_setup(P, A, q, l, u, JaxOracleSettings(), dtype=jnp.float64)
    targs = tbs.shared_setup(P, A, q, l, u, OracleSettings(), dtype=torch.float64, device='cpu')
    want = _np(jargs)
    for k in (0, 1, 2, 3, 4, 7, 8, 9):
        np.testing.assert_allclose(targs[k].numpy(), want[k], rtol=1e-12, atol=1e-14)
    for got, w in zip(targs[5], want[5]):
        np.testing.assert_allclose(np.asarray(got), w, rtol=1e-12)
    assert float(targs[6]) == float(want[6])


@pytest.mark.parametrize('fused', [True, False])
def test_shared_solve_from_jax_state_f64(fused):
    """shared_solve from identical state, float64: statuses and iteration
    counts identical, solutions to 1e-8.  ``fused`` runs the fused-epoch
    wrapper (its plain version on the CPU) or the unfused torch epoch."""
    B, n, m = 40, 10, 15
    eps = 1e-5
    _, jargs, targs = _both_setups(B, n, m, 21, eps, jnp.float64, torch.float64)
    jstg = jax_default_core_settings(jnp.float64, eps_abs=eps, eps_rel=eps)
    tstg = default_core_settings(torch.float64, eps_abs=eps, eps_rel=eps)
    Z = jnp.zeros
    want = jbs.shared_solve(*jargs[:6], jstg, *jargs[6:], Z((n, B)), Z((m, B)), Z((m, B)))
    got = tbs.shared_solve(*targs[:6], tstg, *targs[6:], fused=fused)
    np.testing.assert_array_equal(got['status'].numpy(), np.asarray(want['status']))
    np.testing.assert_array_equal(got['iters'].numpy(), np.asarray(want['iters']))
    assert got['rho_updates'] == int(want['rho_updates']) > 0
    np.testing.assert_allclose(got['x'].numpy(), np.asarray(want['x']), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got['y'].numpy(), np.asarray(want['y']), rtol=0, atol=1e-8)
    # rho is a ratio of residual norms taken near convergence, where the
    # last-bit differences of the two summation orders are amplified
    np.testing.assert_allclose(float(got['rho']), float(want['rho']), rtol=1e-8)


def test_shared_solve_from_jax_state_f32():
    """The same at float32: statuses identical; x within 1e-3 (summation
    order differs between XLA and torch)."""
    B, n, m = 33, 13, 19
    eps = 1e-4
    _, jargs, targs = _both_setups(B, n, m, 7, eps, jnp.float32, torch.float32)
    jstg = jax_default_core_settings(jnp.float32, eps_abs=eps, eps_rel=eps)
    tstg = default_core_settings(torch.float32, eps_abs=eps, eps_rel=eps)
    Z = jnp.zeros
    f32 = jnp.float32
    want = jbs.shared_solve(*jargs[:6], jstg, *jargs[6:],
                            Z((n, B), f32), Z((m, B), f32), Z((m, B), f32))
    got = tbs.shared_solve(*targs[:6], tstg, *targs[6:])
    np.testing.assert_array_equal(got['status'].numpy(), np.asarray(want['status']))
    assert (got['status'].numpy() == 1).all()
    np.testing.assert_allclose(got['x'].numpy(), np.asarray(want['x']), rtol=0, atol=1e-3)


def _port_solve(P, A, q, l, u, eps, compact, warm=None, dtype=torch.float32):
    n, m, B = P.shape[0], A.shape[0], q.shape[0]
    host = OracleSettings(eps_abs=eps, eps_rel=eps)
    stg = default_core_settings(dtype, eps_abs=eps, eps_rel=eps)
    args = tbs.shared_setup(P, A, q, l, u, host, dtype=dtype, device='cpu')
    if warm is None:
        warm = tuple(torch.zeros((k, B), dtype=dtype) for k in (n, m, m))
    return tbs.shared_solve(*args[:6], stg, *args[6:], *warm, compact=compact)


def _assert_same(got, ref):
    """Statuses and iteration counts identical; values to the tolerances of
    tests/test_shared_batch.py's compaction tests (the matmuls of the narrow
    tail buffer may block their sums differently)."""
    for k in ('status', 'iters'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    for k in ('x', 'y'):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got['rho']), float(ref['rho']), rtol=1e-12)


def test_compaction_matches_full_width():
    """Straggler compaction is exact: B=512 crosses the threshold (tail
    buffer 128) and gives the full-width loop's results."""
    P, A, q, l, u = _problems(512, 6, 8, seed=11)
    ref = _port_solve(P, A, q, l, u, 1e-4, '0')
    got = _port_solve(P, A, q, l, u, 1e-4, 'auto')
    assert (ref['status'].numpy() == 1).all()
    _assert_same(got, ref)


def test_compaction_instance0_straggler():
    """The gather pads the tail buffer with copies of column 0.  When
    instance 0 is itself the last straggler those copies are live and must
    not bias the adaptive-rho median.  Every instance but 0 starts at its
    solution."""
    B, n, m = 512, 6, 8
    P, A, q, l, u = _problems(B, n, m, seed=13)
    base = _port_solve(P, A, q, l, u, 1e-5, '0')
    assert (base['status'].numpy() == 1).all()
    warm = [base[k].clone() for k in ('X', 'Z', 'Y')]
    for w in warm:
        w[:, 0] = 0.0
    ref = _port_solve(P, A, q, l, u, 1e-5, '0', warm=warm)
    got = _port_solve(P, A, q, l, u, 1e-5, 'auto', warm=warm)
    iters = ref['iters'].numpy()
    assert iters[0] >= np.percentile(iters, 97) and iters[0] > np.median(iters)
    _assert_same(got, ref)


def test_mpc_rollout_matches_jax_f64():
    """A 3-step warm rollout against JAX's, float64: per-step statuses and
    iteration counts identical, solutions to 1e-8."""
    B, n, m = 16, 12, 18
    eps = 1e-5
    (P, A, q, l, u), jargs, targs = _both_setups(B, n, m, 1, eps, jnp.float64, torch.float64)
    rng = np.random.default_rng(2)
    q_seq = (q[None] + 0.005 * rng.standard_normal((3, B, n))).transpose(0, 2, 1)
    jstg = jax_default_core_settings(jnp.float64, eps_abs=eps, eps_rel=eps)
    tstg = default_core_settings(torch.float64, eps_abs=eps, eps_rel=eps)
    _, (xj, itj, stj) = jbs.shared_mpc_rollout(*jargs[:6], jstg, *jargs[6:], jnp.asarray(q_seq))
    _, (xt, itt, stt) = tbs.shared_mpc_rollout(*targs[:6], tstg, *targs[6:10],
                                               torch.as_tensor(q_seq))
    np.testing.assert_array_equal(stt.numpy(), np.asarray(stj))
    np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
    assert (stt.numpy() == 1).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-8)


_INFO = ('status_val', 'iter', 'obj_val', 'dual_obj_val', 'duality_gap', 'prim_res',
         'dual_res', 'rho_estimate', 'rho_updates')


def _assert_results_match(rt, rj):
    assert rt.info.status == rj.info.status
    for k in _INFO:
        got, want = np.asarray(getattr(rt.info, k)), np.asarray(getattr(rj.info, k))
        if got.dtype.kind in 'iu':
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    for k in ('x', 'y', 'prim_inf_cert', 'dual_inf_cert'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0, atol=1e-8)
    # the port's own field: the shared engine's host syncs
    assert set(vars(rt.info)) == set(vars(rj.info)) | {'host_syncs'}


def test_batched_osqp_matches_jax():
    """BatchedOSQP(device='cpu', dtype=float64) through setup, solve,
    update(q), solve and warm_start against osqp_tpu's on the same data:
    same statuses, iterations and info fields."""
    B, n, m = 8, 10, 15
    P, A, q, l, u = _problems(B, n, m, seed=3)
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    j = JaxBatchedOSQP()
    j.setup(P, q, A, l, u, **kw)
    t = BatchedOSQP(device='cpu', dtype=torch.float64)
    t.setup(P, q, A, l, u, **kw)
    assert t._engine == j._engine == 'shared'
    r1j, r1t = j.solve(), t.solve()
    _assert_results_match(r1t, r1j)

    q2 = q + 0.01 * np.random.default_rng(4).standard_normal(q.shape)
    j.update(q=q2)
    t.update(q=q2)
    _assert_results_match(t.solve(), j.solve())

    for s in (j, t):
        s.warm_start(x=r1j.x, y=r1j.y)
    _assert_results_match(t.solve(), j.solve())


def test_batched_osqp_infeasible_instances_match_jax():
    """A 64-instance shared batch with 16 primal- and 16 dual-infeasible
    instances, float64, against osqp_tpu's BatchedOSQP: statuses and
    iterations equal, the certificates (growing iterate differences) to 1e-6
    relative, the solved instances' x to 1e-8.  P is singular along x_n,
    which only the box row of x_n bounds: dual-infeasible instances leave it
    unbounded above with q_n < 0.  The last two constraint rows are equal:
    primal-infeasible instances give them disjoint intervals."""
    B, n = 64, 6
    rng = np.random.default_rng(8)
    Lm = rng.standard_normal((n - 1, n - 1))
    P = np.zeros((n, n))
    P[:n - 1, :n - 1] = Lm @ Lm.T / n + 0.1 * np.eye(n - 1)
    R = np.zeros((2, n))
    R[:, :n - 1] = rng.standard_normal(n - 1)
    A = np.vstack([np.eye(n), R])
    q = rng.standard_normal((B, n))
    l = np.tile(np.r_[-np.ones(n), -1.0, -1.0], (B, 1))
    u = np.tile(np.r_[np.ones(n), 1.0, 1.0], (B, 1))
    pinf, dinf = slice(16, 32), slice(32, 48)
    l[pinf, n], u[pinf, n] = 2.0, 3.0
    u[dinf, n - 1] = np.inf
    q[dinf, n - 1] = -1.0 - rng.random(16)
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    rj = JaxBatchedOSQP().setup(P, q, A, l, u, **kw).solve()
    rt = BatchedOSQP(device='cpu', dtype=torch.float64).setup(P, q, A, l, u, **kw).solve()
    st = rt.info.status_val
    assert (st[pinf] == 3).all() and (st[dinf] == 5).all() and (st[:16] == 1).all()
    np.testing.assert_array_equal(st, rj.info.status_val)
    np.testing.assert_array_equal(rt.info.iter, rj.info.iter)
    np.testing.assert_allclose(rt.prim_inf_cert[pinf], rj.prim_inf_cert[pinf], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(rt.dual_inf_cert[dinf], rj.dual_inf_cert[dinf], rtol=1e-6,
                               atol=1e-12)
    solved = st == 1
    np.testing.assert_allclose(rt.x[solved], rj.x[solved], rtol=0, atol=1e-8)


def test_batched_osqp_unported_paths_raise():
    """The shared engine's paths that still raise: a batched P or A forced
    onto it, the indirect solver, the reduced iteration precisions at
    float64 or on the vmap engine, and unknown engine or KKT names."""
    P, A, q, l, u = _problems(4, 3, 5)
    s = BatchedOSQP(device='cpu', engine='shared')
    with pytest.raises(ValueError, match='shared engine requires unbatched'):
        s.setup(np.tile(P, (4, 1, 1)), q, A, l, u)
    with pytest.raises(NotImplementedError, match='indirect'):
        BatchedOSQP(device='cpu').setup(P, q, A, l, u, solver_type='indirect')
    with pytest.raises(ValueError, match='float32 only'):
        BatchedOSQP(device='cpu', iter_prec='high')
    with pytest.raises(ValueError, match="shared engine's"):
        BatchedOSQP(device='cpu', dtype=torch.float32, engine='vmap', iter_prec='high')
    with pytest.raises(ValueError, match="shared engine's"):
        BatchedOSQP(device='cpu', dtype=torch.float32, iter_prec='high').setup(
            np.tile(P, (4, 1, 1)), q, A, l, u)
    with pytest.raises(ValueError, match='engine must be'):
        BatchedOSQP(device='cpu', engine='loop')
    with pytest.raises(ValueError, match='kkt_method must be'):
        BatchedOSQP(device='cpu', kkt_method='lu')


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_update_stages_the_host_clip_bit_for_bit(dtype):
    """``update`` casts into one staging buffer and clips l and u on the
    device after the cast: the pending q, l and u are, bit for bit, the
    float64 clip cast afterwards (``torch.tensor(np.minimum(np.maximum(v,
    -1e30), 1e30), dtype)``), for infinities, NaN, values beyond 1e30 and
    beyond float32's range, and for (dim,) vectors broadcast to the batch."""
    B, n, m = 6, 4, 5
    P, A, q, l, u = _problems(B, n, m, seed=5)
    s = BatchedOSQP(device='cpu', dtype=dtype).setup(P, q, A, l, u)
    special = np.array([np.inf, -np.inf, np.nan, 1e31, -1e31, 1e39, -1e39, 1e30, -1e30,
                        3.4e38, -0.0, 1 / 3])
    rng = np.random.default_rng(6)
    cases = [
        (rng.choice(special, (B, n)), rng.choice(special, (B, m)), rng.choice(special, (B, m))),
        (rng.choice(special, n), rng.choice(special, m), special[rng.integers(0, 12, m)]),
        (q.astype(np.float32), l, u[0]),
    ]
    for qv, lv, uv in cases:
        s.update(q=qv, l=lv, u=uv)
        want = dict(q=np.broadcast_to(np.asarray(qv, np.float64), (B, n)),
                    l=np.maximum(np.broadcast_to(lv, (B, m)), -1e30),
                    u=np.minimum(np.broadcast_to(uv, (B, m)), 1e30))
        for name, w in want.items():
            got = s._pending[name]
            assert got.shape == w.shape and got.dtype == dtype
            assert torch.equal(_bits(got), _bits(torch.tensor(w, dtype=dtype))), name
        s._pending = {}


@pytest.mark.parametrize('engine', ['shared', 'vmap'])
def test_answers_and_staged_inputs_are_owned(engine, monkeypatch):
    """The solver owns what it stages and what it returns: a caller that
    changes its arrays after ``update`` does not change the next solve, the
    arrays solve k returned are unchanged after solve k + 1, and
    ``info.status`` is ``status_string`` of each code, an unknown code
    too."""
    B, n, m = 8, 6, 9
    P, A, q, l, u = _problems(B, n, m, seed=7)
    if engine == 'vmap':
        P = np.tile(P, (B, 1, 1))
    kw = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    s = BatchedOSQP(device='cpu', engine=engine).setup(P, q, A, l, u, **kw)
    twin = BatchedOSQP(device='cpu', engine=engine).setup(P, q, A, l, u, **kw)
    first = s.solve()
    twin.solve()
    kept = {k: np.copy(getattr(first, k)) for k in ('x', 'y', 'prim_inf_cert', 'dual_inf_cert')}
    kept.update({k: np.copy(getattr(first.info, k))
                 for k in ('status_val', 'iter', 'obj_val', 'prim_res', 'dual_res')})
    q2, l2 = q + 0.1, l - 0.1
    s.update(q=q2, l=l2)
    twin.update(q=q2.copy(), l=l2.copy())
    q2 += 5.0
    l2[:] = 0.0
    second, want = s.solve(), twin.solve()
    for k in ('x', 'y'):
        np.testing.assert_array_equal(getattr(second, k), getattr(want, k))
    np.testing.assert_array_equal(second.info.iter, want.info.iter)
    for k, v in kept.items():
        got = getattr(first, k) if hasattr(first, k) else getattr(first.info, k)
        np.testing.assert_array_equal(got, v)
    assert not np.array_equal(second.x, first.x)

    fetch = BatchedOSQP._fetch

    def unknown_codes(self, arrays):
        h = fetch(self, arrays)
        h['status'][:3] = (0, 99, -4)
        return h

    monkeypatch.setattr(BatchedOSQP, '_fetch', unknown_codes)
    r = s.solve()
    assert r.info.status[:3] == ['unknown'] * 3
    assert r.info.status == [status_string(v) for v in r.info.status_val]
    assert r.info.status[3:] == ['solved'] * (B - 3)
