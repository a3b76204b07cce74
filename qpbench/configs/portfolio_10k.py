"""The OSQP benchmark suite's Portfolio class, re-optimised as forecasts move.

``portfolio(n, k, density, seed)`` is the suite's generator (a frozen copy of
the repository's own, ``chip_smoke.portfolio_family``, kept here so that the
yardstick does not move with it).  ``Client`` is the fund's loop: one QP,
whose expected returns mu move before each rebalance, reverting to the
model's mu0: mu <- mu0 + r (mu - mu0) + N(0, s^2) an asset (``mu_reversion``
r and ``mu_step`` s in the traffic file).  The forecasts stay near mu0, so
every seed asks for work of the same kind (a random walk would drift, and the
iterations a step needs with it).  The step's q = [-mu; 0] is the only input
that changes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse


def portfolio(n, k, density=0.5, seed=0):
    """The Portfolio problem of the OSQP benchmark suite: minimize x'Dx + y'y
    - mu'x over (x, y) subject to y = F'x, 1'x = 1, 0 <= x <= 1; F (n, k)
    of the given density with N(0, 1) values, D_ii ~ U[0, sqrt(k)], mu ~
    N(0, 1).  Returns ``(P, q, A, l, u)`` with P and A in scipy CSC."""
    rng = np.random.default_rng(seed)
    fr, fc = np.nonzero(rng.random((k, n)) < density)  # F' pattern
    fv = rng.standard_normal(fr.size)
    D = rng.random(n) * np.sqrt(k)
    mu = rng.standard_normal(n)
    P = sparse.diags(np.concatenate([2 * D, 2 * np.ones(k)])).tocsc()
    q = np.concatenate([-mu, np.zeros(k)])
    rows = np.concatenate([np.zeros(n, np.int64), fr + 1, np.arange(1, k + 1),
                           np.arange(k + 1, k + 1 + n)])
    cols = np.concatenate([np.arange(n), fc, n + np.arange(k), np.arange(n)])
    vals = np.concatenate([np.ones(n), fv, -np.ones(k), np.ones(n)])
    A = sparse.coo_matrix((vals, (rows, cols)), shape=(1 + k + n, n + k)).tocsc()
    l = np.concatenate([[1.0], np.zeros(k + n)])
    u = np.concatenate([[1.0], np.zeros(k), np.ones(n)])
    return P, q, A, l, u


class Client:
    """The rebalancing loop.  ``inputs()`` gives the current step's (q, l,
    u) (l and u never change), ``record()`` a compact copy that ``expand``
    turns back into the same arrays, each with a leading batch axis of 1,
    and ``advance(x)`` moves the forecasts to the next step."""

    def __init__(self, cfg, traffic, seed, n_assets=None, n_factors=None):
        self.n = int(n_assets or cfg['n_assets'])
        self.k = int(n_factors or cfg['n_factors'])
        self.P, q, self.A, self.l, self.u = portfolio(self.n, self.k, cfg['factor_density'],
                                                      cfg['data_seed'])
        self.mu0 = -q[:self.n]
        self.mu = self.mu0.copy()
        self.t = traffic
        self.rng = np.random.default_rng(seed)

    def _q(self, mu):
        return np.concatenate([-mu, np.zeros(self.k)])

    def inputs(self):
        return dict(q=self._q(self.mu))

    def setup_inputs(self):
        return dict(q=self._q(self.mu), l=self.l, u=self.u)

    def record(self):
        return dict(mu=self.mu.copy())

    def expand(self, rec, rows=None):
        return self._q(rec['mu'])[None], self.l[None], self.u[None]

    def advance(self, sol_x):
        self.mu = (self.mu0 + self.t['mu_reversion'] * (self.mu - self.mu0)
                   + self.rng.normal(0.0, self.t['mu_step'], self.n))
