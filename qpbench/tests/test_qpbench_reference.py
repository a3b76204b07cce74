"""The plain reference against closed-form QPs, and its lower precisions."""

import numpy as np
import torch

from qpbench.reference import ipm


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_box_qp_closed_form():
    # minimize 1/2 ||x||^2 - c'x subject to lo <= x <= hi: x = clip(c), y = c - x
    rng = np.random.default_rng(0)
    B, n = 5, 7
    c = rng.normal(0, 2, (B, n))
    lo, hi = np.full((B, n), -1.0), np.full((B, n), 1.5)
    r = ipm.solve(t(np.eye(n)), t(np.eye(n)), t(-c), t(lo), t(hi))
    assert (r.status == ipm.SOLVED).all()
    x = np.clip(c, lo, hi)
    np.testing.assert_allclose(r.x.numpy(), x, atol=1e-6)
    np.testing.assert_allclose(r.y.numpy(), c - x, atol=1e-6)
    assert float(r.dual_res.max()) < 1e-8


def test_equality_and_infinite_bounds():
    # minimize 1/2 ||x||^2 subject to 1'x = 1, x_0 <= 0.1, x_1 free: x = ...
    n = 4
    A = np.vstack([np.ones(n), np.eye(n)])
    l = np.r_[1.0, -np.inf, -np.inf, -np.inf, -np.inf][None]
    u = np.r_[1.0, 0.1, np.inf, np.inf, np.inf][None]
    r = ipm.solve(t(np.eye(n)), t(A), t(np.zeros((1, n))), t(l), t(u))
    assert int(r.status[0]) == ipm.SOLVED
    np.testing.assert_allclose(r.x[0].numpy(), [0.1, 0.3, 0.3, 0.3], atol=1e-8)
    # stationarity x + A'y = 0: y_eq = -0.3, y_upper(x0) = 0.2
    np.testing.assert_allclose(r.y[0].numpy(), [-0.3, 0.2, 0, 0, 0], atol=1e-8)


def test_tf32_round():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 0.1, -3.3])
    r = ipm.tf32_round(v)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie goes to even
    assert r[2] == 1.0 + 2.0 ** -9
    assert torch.all((r - v).abs() <= v.abs() * 2.0 ** -11)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def test_lower_precision_reads_its_precision():
    rng = np.random.default_rng(1)
    B, n = 3, 6
    L = rng.normal(size=(n, n))
    P = L @ L.T + np.eye(n)
    c = rng.normal(size=(B, n))
    lo, hi = -np.ones((B, n)), np.ones((B, n))
    exact = ipm.solve(t(P), t(np.eye(n)), t(c), t(lo), t(hi))
    low = ipm.solve(t(P), t(np.eye(n)), t(c), t(lo), t(hi), prec=ipm.Precision('tf32'))
    assert low.x.dtype == torch.float32
    gap = (low.x.double() - exact.x).abs().max()
    assert 1e-6 < float(gap) < 1e-1
