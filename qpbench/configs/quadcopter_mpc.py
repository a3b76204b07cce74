"""The OSQP documentation's quadcopter MPC example, as a fleet of vehicles.

``qp(cfg)`` builds the example's QP exactly as its script does (P, A and the
bound rows; see ``transcription`` in ``quadcopter_mpc.json``).  ``Client`` is
the closed loop around the solver: a fleet of ``batch`` vehicles, each with
its own measured state (the first nx rows of l and u) and its own target (q),
stepped together.  Each step takes every vehicle's first input from the
solution, advances its state by the plant with a disturbance, and redraws
the targets of the vehicles whose turn it is.  The traffic file sets the
fleet and the draws; everything is drawn from the seed, never from the
solutions, so a seed gives the same draws whatever the solver returns.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _vec(values):
    return np.array([float(v) for v in values])


def qp(cfg):
    """``(P, A, l_base, u_base)``: dense P (n, n) and A (m, n), and the bound
    vectors with the measured-state rows at 0."""
    N, nx, nu = cfg['N'], cfg['nx'], cfg['nu']
    Ad, Bd = np.array(cfg['Ad'], float), np.array(cfg['Bd'], float)
    Q, QN, R = (sp.diags(_vec(cfg[k])) for k in ('Q_diag', 'QN_diag', 'R_diag'))
    P = sp.block_diag([sp.kron(sp.eye(N), Q), QN, sp.kron(sp.eye(N), R)])
    Ax = sp.kron(sp.eye(N + 1), -sp.eye(nx)) + sp.kron(sp.eye(N + 1, k=-1), Ad)
    Bu = sp.kron(sp.vstack([sp.csc_matrix((1, N)), sp.eye(N)]), Bd)
    A = sp.vstack([sp.hstack([Ax, Bu]), sp.eye((N + 1) * nx + N * nu)])
    u0 = cfg['u0']
    umin = np.full(nu, cfg['umin_abs'] - u0)
    umax = np.full(nu, cfg['umax_abs'] - u0)
    xmin, xmax = _vec(cfg['xmin']), _vec(cfg['xmax'])
    zeros = np.zeros((N + 1) * nx)
    l_base = np.hstack([zeros, np.kron(np.ones(N + 1), xmin), np.kron(np.ones(N), umin)])
    u_base = np.hstack([zeros, np.kron(np.ones(N + 1), xmax), np.kron(np.ones(N), umax)])
    return P.toarray(), A.toarray(), l_base, u_base


class Client:
    """The fleet's closed loop.  ``inputs()`` gives the (q, l, u) of the
    current step, ``record()`` a compact copy of them that ``expand`` turns
    back into the same arrays, and ``advance(x)`` applies the step's
    solution (B, n) and moves to the next step."""

    def __init__(self, cfg, traffic, seed, batch=None):
        self.N, self.nx, self.nu = cfg['N'], cfg['nx'], cfg['nu']
        self.B = int(batch or traffic['batch'])
        self.P, self.A, self.l_base, self.u_base = qp(cfg)
        self.Ad = np.array(cfg['Ad'], float)
        self.Bd = np.array(cfg['Bd'], float)
        self.xmin, self.xmax = _vec(cfg['xmin']), _vec(cfg['xmax'])
        self.Q = _vec(cfg['Q_diag'])
        self.QN = _vec(cfg['QN_diag'])
        self.xr = _vec(cfg['xr'])
        self.t = traffic
        self.rng = np.random.default_rng(seed)
        self.step = 0
        self.x = np.clip(self.rng.normal(0.0, traffic['x0_std'], (self.B, self.nx)),
                         self.xmin, self.xmax)
        self.target = self.rng.uniform(traffic['target_low'], traffic['target_high'], self.B)
        self._l = np.tile(self.l_base, (self.B, 1))
        self._u = np.tile(self.u_base, (self.B, 1))
        self._qs = self._q(self.target)  # rows change only where a target does

    def _q(self, target):
        xr = np.tile(self.xr, (len(target), 1))
        xr[:, 2] = target
        qx = -(xr * self.Q)
        qN = -(xr * self.QN)
        return np.hstack([np.tile(qx, self.N), qN, np.zeros((len(target), self.N * self.nu))])

    def inputs(self):
        self._l[:, :self.nx] = -self.x
        self._u[:, :self.nx] = -self.x
        return dict(q=self._qs, l=self._l, u=self._u)

    setup_inputs = inputs

    def record(self):
        return dict(x=self.x.copy(), target=self.target.copy())

    def expand(self, rec, rows=None):
        """The (q, l, u) of a recorded step, for the instances ``rows``."""
        x = rec['x'] if rows is None else rec['x'][rows]
        target = rec['target'] if rows is None else rec['target'][rows]
        l = np.tile(self.l_base, (len(x), 1))
        u = np.tile(self.u_base, (len(x), 1))
        l[:, :self.nx] = -x
        u[:, :self.nx] = -x
        return self._q(target), l, u

    def advance(self, sol_x):
        first = (self.N + 1) * self.nx
        # a vehicle without a solution holds the hover thrust (input deviation 0)
        ctrl = np.nan_to_num(np.asarray(sol_x[:, first:first + self.nu], np.float64))
        w = self.rng.normal(0.0, self.t['w_std'], (self.B, self.nx))
        self.x = self.x @ self.Ad.T + ctrl @ self.Bd.T + w
        self.step += 1
        turn = np.flatnonzero(np.arange(self.B) % self.t['target_period']
                              == self.step % self.t['target_period'])
        self.target[turn] = self.rng.uniform(self.t['target_low'], self.t['target_high'],
                                             len(turn))
        self._qs[turn] = self._q(self.target[turn])
