"""time_limit, SIGINT and verbose printing in the port (osqp_tpu_torch.OSQP,
device='cpu', float64), mirroring tests/test_interrupt.py and held against
osqp_tpu.OSQP(algebra='jax') under x64.

Both packages run the ADMM loop in chunks when a time limit is set (or
OSQP_TPU_CHUNKED_SOLVE=1), check the clock between chunks and turn a
KeyboardInterrupt there into OSQP_SIGINT with the last completed chunk's
iterates.  Each package's ``_poll_interrupt`` hook is patched to inject the
interrupt deterministically.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sparse

import osqp_tpu
from osqp_tpu.backends import jax_backend

import osqp_tpu_torch
from osqp_tpu_torch import backend as torch_backend
from osqp_tpu_torch.constants import SolverStatus

import problems


def _slow_qp(n=40, m=60, seed=4):
    """tests/test_interrupt.py's QP: a few hundred iterations at tight eps."""
    rng = np.random.default_rng(seed)
    L = sparse.random(n, n, density=0.4, random_state=rng)
    P = (L @ L.T + 0.05 * sparse.eye(n)).tocsc()
    q = rng.standard_normal(n)
    A = sparse.random(m, n, density=0.4, random_state=rng).tocsc()
    x0 = rng.standard_normal(n)
    s0 = rng.random(m)
    u = A @ x0 + s0
    l = u - 2 * s0 - 0.1
    return P, q, A, l, u


def _setup(pkg, time_limit, **extra):
    P, q, A, l, u = _slow_qp()
    s = osqp_tpu.OSQP(algebra='jax') if pkg == 'jax' else osqp_tpu_torch.OSQP(device='cpu')
    opts = dict(verbose=False, eps_abs=1e-9, eps_rel=1e-9, check_termination=5,
                time_limit=time_limit)
    s.setup(P=P, q=q, A=A, l=l, u=u, **{**opts, **extra})
    return s


def _raise_on_call(k):
    calls = {'n': 0}

    def poll():
        calls['n'] += 1
        if calls['n'] >= k:
            raise KeyboardInterrupt
    return poll


CHUNK = 100  # max(10 * check_termination, 100) at check_termination = 5


def test_time_limit_reached():
    r = _setup('torch', time_limit=1e-9).solve(raise_error=False)
    assert r.info.status_val == int(SolverStatus.OSQP_TIME_LIMIT_REACHED)
    assert r.info.status == 'run time limit reached'
    assert np.isfinite(r.x).all()
    assert r.info.iter == CHUNK  # the clock is read after the first chunk


def test_keyboard_interrupt_matches_jax(monkeypatch):
    """An interrupt at the third poll: OSQP_SIGINT after two chunks, with the
    same iteration count and x as the JAX package under the same patch; a
    later solve without the limit finishes.  Indirect mode, whose chunked
    solve needs three chunks here."""
    out = {}
    for pkg, mod in (('jax', jax_backend), ('torch', torch_backend)):
        monkeypatch.setattr(mod, '_poll_interrupt', _raise_on_call(3))
        s = _setup(pkg, time_limit=1e9, max_iter=100000, solver_type='indirect')
        out[pkg] = (s, s.solve(raise_error=False))
    (_, rj), (t, rt) = out['jax'], out['torch']
    assert rt.info.status_val == int(SolverStatus.OSQP_SIGINT)
    assert rt.info.status == rj.info.status == 'interrupted'
    assert rt.info.iter == rj.info.iter == 2 * CHUNK
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-7)
    assert np.isfinite(rt.x).all()
    t.update_settings(time_limit=0)
    assert t.solve(raise_error=False).info.status_val in (
        int(SolverStatus.OSQP_SOLVED), int(SolverStatus.OSQP_SOLVED_INACCURATE))


def test_interrupt_before_first_chunk_propagates(monkeypatch):
    monkeypatch.setattr(torch_backend, '_poll_interrupt', _raise_on_call(1))
    s = _setup('torch', time_limit=1e9)
    with pytest.raises(KeyboardInterrupt):
        s.solve(raise_error=False)


@pytest.mark.parametrize('solver_type', ['direct', 'indirect'])
def test_armed_not_hit_matches_jax(solver_type):
    """time_limit armed but never hit: the chunked solve gives the JAX
    package's status, iterations, rho updates and x.  In direct mode it also
    gives the unchunked solve's, with one more host sync per extra chunk
    (each chunk ends with a rho estimate).  In indirect mode each chunk
    restarts the CG tolerance at 1e-3, as the JAX package's chunks do, so
    the chunked and unchunked solves differ in both packages."""
    rj = _setup('jax', time_limit=1e9, solver_type=solver_type).solve(raise_error=False)
    rt = _setup('torch', time_limit=1e9, solver_type=solver_type).solve(raise_error=False)
    assert rt.info.status == rj.info.status == 'solved'
    assert rt.info.iter == rj.info.iter
    assert rt.info.rho_updates == rj.info.rho_updates
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-7)
    assert rt.info.iter > CHUNK and rt.info.rho_updates >= 1
    if solver_type == 'indirect':
        assert rt.info.cg_iters > 0
        return
    rp = _setup('torch', time_limit=0, solver_type=solver_type).solve(raise_error=False)
    assert (rp.info.iter, rp.info.rho_updates) == (rt.info.iter, rt.info.rho_updates)
    np.testing.assert_allclose(rp.x, rt.x, rtol=0, atol=1e-12)
    n_chunks = -(-rt.info.iter // CHUNK)
    assert rt.info.host_syncs == rp.info.host_syncs + n_chunks - 1


def test_plain_solve_interruptible_with_chunked_env(monkeypatch):
    """OSQP_TPU_CHUNKED_SOLVE=1 makes a solve without a time limit chunked,
    so an interrupt gives OSQP_SIGINT; without it the same solve is one call
    that never polls."""
    monkeypatch.setattr(torch_backend, '_poll_interrupt', _raise_on_call(2))
    monkeypatch.setenv('OSQP_TPU_CHUNKED_SOLVE', '1')
    r = _setup('torch', time_limit=0, max_iter=100000).solve(raise_error=False)
    assert r.info.status_val == int(SolverStatus.OSQP_SIGINT)
    assert np.isfinite(r.x).all() and r.info.iter == CHUNK
    monkeypatch.delenv('OSQP_TPU_CHUNKED_SOLVE')
    r2 = _setup('torch', time_limit=0, max_iter=100000).solve(raise_error=False)
    assert r2.info.status_val in (int(SolverStatus.OSQP_SOLVED),
                                  int(SolverStatus.OSQP_SOLVED_INACCURATE))


def test_verbose_rows_match_jax(capsys):
    """verbose=True prints the JAX package's console protocol: setup header,
    iteration rows every 200 iterations, footer.  Only the banner's two title
    lines differ, and the footer's run time (a measured time) is held to its
    format."""
    P, q, A, l, u = problems.basic_qp()
    opts = dict(verbose=True, eps_abs=1e-9, eps_rel=1e-9, polishing=True)
    lines = {}
    for pkg in ('jax', 'torch'):
        s = (osqp_tpu.OSQP(algebra='jax') if pkg == 'jax'
             else osqp_tpu_torch.OSQP(device='cpu'))
        s.setup(P=P, q=q, A=A, l=l, u=u, **opts)
        capsys.readouterr()
        r = s.solve(raise_error=False)
        lines[pkg] = (capsys.readouterr().out.splitlines(), r)
    (lj, rj), (lt, rt) = lines['jax'], lines['torch']
    assert rt.info.iter == rj.info.iter >= 200
    assert len(lt) == len(lj)
    assert 'osqp_tpu_torch' in lt[1] and 'algebra = torch (cpu)' in lt[2]
    rows = [x for x in lt if re.match(r'^ *\d+  ', x)]
    assert len(rows) == rt.info.iter // 200
    for a, b in zip(lt[3:], lj[3:]):
        if a.startswith('run time:'):
            assert re.fullmatch(r'run time: +\d\.\d\de[+-]\d\ds', a) and b.startswith('run time:')
        else:
            assert a == b
    assert 'solution polish:      successful' in lt
