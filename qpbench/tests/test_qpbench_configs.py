"""The configurations' QPs against their published construction."""

import json
from pathlib import Path

import numpy as np
import pytest

from qpbench.configs import portfolio_10k, quadcopter_mpc

CONFIGS = Path(__file__).resolve().parents[1] / 'configs'


@pytest.fixture(scope='module')
def quad():
    return json.loads((CONFIGS / 'quadcopter_mpc.json').read_text())


def test_quadcopter_sizes(quad):
    P, A, l, u = quadcopter_mpc.qp(quad)
    N, nx, nu = quad['N'], quad['nx'], quad['nu']
    assert (quad['n'], quad['m']) == ((N + 1) * nx + N * nu, 2 * (N + 1) * nx + N * nu)
    assert P.shape == (172, 172) and A.shape == (304, 172)
    assert l.shape == u.shape == (304,)


def test_quadcopter_blocks(quad):
    P, A, l, u = quadcopter_mpc.qp(quad)
    N, nx, nu = quad['N'], quad['nx'], quad['nu']
    Ad, Bd = np.array(quad['Ad']), np.array(quad['Bd'])
    Q, R = np.diag(quad['Q_diag']), np.diag(quad['R_diag'])
    nX = (N + 1) * nx
    for k in range(N):
        np.testing.assert_array_equal(P[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx], Q)
        np.testing.assert_array_equal(P[nX + k * nu:nX + (k + 1) * nu,
                                        nX + k * nu:nX + (k + 1) * nu], R)
    np.testing.assert_array_equal(P[N * nx:nX, N * nx:nX], np.diag(quad['QN_diag']))
    assert np.count_nonzero(P - np.diag(np.diag(P))) == 0
    # dynamics: -x(k+1) + Ad x(k) + Bd u(k) = 0 in rows (k+1) nx, and -x(0) = -x0
    np.testing.assert_array_equal(A[:nx, :nx], -np.eye(nx))
    for k in range(N):
        r = slice((k + 1) * nx, (k + 2) * nx)
        np.testing.assert_array_equal(A[r, k * nx:(k + 1) * nx], Ad)
        np.testing.assert_array_equal(A[r, (k + 1) * nx:(k + 2) * nx], -np.eye(nx))
        np.testing.assert_array_equal(A[r, nX + k * nu:nX + (k + 1) * nu], Bd)
    assert np.count_nonzero(A[:nx, nX:]) == 0
    np.testing.assert_array_equal(A[nX:], np.eye(nX + N * nu))
    np.testing.assert_array_equal(l[:nX], 0)
    np.testing.assert_array_equal(u[:nX], 0)
    u0 = quad['u0']
    np.testing.assert_allclose(l[-nu:], 9.6 - u0)
    np.testing.assert_allclose(u[-nu:], 13 - u0)
    np.testing.assert_allclose(u[nX:nX + 2], np.pi / 6)
    assert l[nX + 5] == -1 and np.isinf(l[nX + 2]) and np.isinf(u[nX + 5])


def test_quadcopter_client_inputs(quad):
    traffic = dict(batch=6, x0_std=0.1, target_low=0.5, target_high=1.5, target_period=3,
                   w_std=0.01)
    c = quadcopter_mpc.Client(quad, traffic, 2**31 + 7)
    inp = c.inputs()
    rec = c.record()
    q, l, u = c.expand(rec)
    np.testing.assert_array_equal(q, inp['q'])
    np.testing.assert_array_equal(l, inp['l'])
    np.testing.assert_array_equal(u, inp['u'])
    # q = [1_N (x) -Q xr; -QN xr; 0] with xr = e3 * target
    Q = np.array(quad['Q_diag'], float)
    xr = np.zeros(12)
    xr[2] = c.target[0]
    want = np.hstack([np.tile(-Q * xr, quad['N']), -Q * xr, np.zeros(40)])
    np.testing.assert_allclose(q[0], want)
    np.testing.assert_array_equal(l[:, :12], -rec['x'])
    before = c.target.copy()
    c.advance(np.zeros((6, 172)))
    changed = np.flatnonzero(c.target != before)
    assert set(changed) <= {i for i in range(6) if i % 3 == 1}
    np.testing.assert_array_equal(c.inputs()['q'], c.expand(c.record())[0])
    again = quadcopter_mpc.Client(quad, traffic, 2**31 + 7)
    np.testing.assert_array_equal(again.x, rec['x'])


def test_portfolio_definition():
    n, k = 300, 3
    P, q, A, l, u = portfolio_10k.portfolio(n, k, 0.5, seed=11)
    assert P.shape == (n + k, n + k) and A.shape == (1 + k + n, n + k)
    d = P.diagonal()
    assert np.all(d[:n] >= 0) and np.all(d[:n] <= 2 * np.sqrt(k))
    np.testing.assert_array_equal(d[n:], 2.0)
    assert P.nnz == n + k
    Ad = A.toarray()
    np.testing.assert_array_equal(Ad[0], np.r_[np.ones(n), np.zeros(k)])
    F = Ad[1:k + 1, :n].T
    assert 0.4 < np.count_nonzero(F) / F.size < 0.6
    np.testing.assert_array_equal(Ad[1:k + 1, n:], -np.eye(k))
    np.testing.assert_array_equal(Ad[k + 1:], np.c_[np.eye(n), np.zeros((n, k))])
    np.testing.assert_array_equal(l, np.r_[1.0, np.zeros(k + n)])
    np.testing.assert_array_equal(u, np.r_[1.0, np.zeros(k), np.ones(n)])
    np.testing.assert_array_equal(q[n:], 0.0)
    P2, q2, A2, _, _ = portfolio_10k.portfolio(n, k, 0.5, seed=11)
    assert (P2 != P).nnz == 0 and (A2 != A).nnz == 0 and np.array_equal(q2, q)


def test_portfolio_client():
    cfg = json.loads((CONFIGS / 'portfolio_10k.json').read_text())
    assert (cfg['n_assets'], cfg['n_factors']) == (10000, 100)
    c = portfolio_10k.Client(cfg, dict(mu_step=0.01, mu_reversion=0.5), 5, n_assets=200, n_factors=2)
    q0 = c.inputs()['q']
    rec = c.record()
    c.advance(None)
    q1 = c.inputs()['q']
    assert 0 < np.abs(q1 - q0).max() < 0.1
    q, l, u = c.expand(rec)
    np.testing.assert_array_equal(q[0], q0)
    assert q.shape == (1, 202) and l.shape == u.shape == (1, 203)
