"""The port's single-QP core (osqp_tpu_torch.solver.core) against the JAX
package's (osqp_tpu.solver.core) from identical state, on the CPU at float64.

Both loops start from the JAX backend's setup state, carried into the port
by ``convert.from_jax_solver``, so these tests hold the loop apart from
setup: PCG must take the same number of steps and reach the same x to 1e-12;
``solve_scaled`` must give the same status, iteration count, rho updates and
CG steps, and x and y to 1e-8.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu.backends.jax_backend import Solver as JaxSolver
from osqp_tpu.ops import spmv as jspmv
from osqp_tpu.solver import core as jcore

from osqp_tpu_torch.convert import from_jax_solver
from osqp_tpu_torch.ops.spmv import DiaMatrix
from osqp_tpu_torch.settings import OracleSettings, core_settings
from osqp_tpu_torch.solver import core as tcore

import problems


def _mpc_like_qp(T=14, seed=0):
    """tests/test_spmv.py's banded MPC-cascade QP (the DIA showcase)."""
    rng = np.random.default_rng(seed)
    n = 2 * T
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.6), np.full(n - 1, -0.6)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = sp.eye(n, format='csc') + sp.diags([np.full(n - 2, 0.3)], [-2], shape=(n, n))
    return P, q, A.tocsc(), -np.ones(n) * 2, np.ones(n) * 2


def _np_op(M):
    if isinstance(M, jspmv.DiaMatrix):
        return dict(bands=np.asarray(M.bands), offsets=M.offsets,
                    bands_t=np.asarray(M.bands_t), offsets_t=M.offsets_t, shape=M.shape)
    return np.asarray(M)


def _jax_state(js):
    """The JAX Solver's state after setup, as numpy arrays."""
    d, r = js._data, js._rho
    return dict(
        P=_np_op(d.P), A=_np_op(d.A), q=np.asarray(d.q), l=np.asarray(d.l), u=np.asarray(d.u),
        scal=tuple(np.asarray(v) for v in js._scal),
        rho=(np.asarray(r.rho), np.asarray(r.rho_vec), np.asarray(r.rho_inv_vec),
             np.asarray(r.constr_type)),
        factor=(np.asarray(js._factor.L), np.asarray(js._factor.diag)),
        iterates=tuple(np.asarray(v) for v in js._iterates),
    )


def _both(prob, sparse, **settings):
    P, q, A, l, u = prob
    js = JaxSolver(sparse=sparse)
    js.setup(P, q, A, l, u, **settings)
    port = from_jax_solver(_jax_state(js), 'cpu', torch.float64)
    return js, port


@pytest.mark.parametrize('sparse', [True, False])
def test_pcg_matches_jax(sparse):
    """PCG on M(rho) from the same rhs and warm start: the same number of
    steps, x to 1e-12 (DIA operators in sparse mode, dense ones otherwise)."""
    prob = _mpc_like_qp() if sparse else problems.basic_qp()
    js, (data, _, rho, factor, _) = _both(prob, sparse, linsys_solver=1)
    if sparse:
        assert isinstance(data.P, DiaMatrix) and isinstance(data.A, DiaMatrix)
    n = data.q.shape[0]
    rng = np.random.default_rng(1)
    b, x0 = rng.standard_normal(n), 0.1 * rng.standard_normal(n)
    sigma = np.float64(1e-6)
    for rel_tol, max_iter in ((1e-10, 200), (1e-3, 200), (1e-12, 3)):
        xj, kj = jcore.pcg_solve(js._data.P, js._data.A, sigma, js._rho.rho_vec,
                                 js._factor.diag, b, x0, rel_tol, max_iter)
        xt, kt, syncs = tcore.pcg_solve(data.P, data.A, sigma, rho.rho_vec, factor.diag,
                                        torch.as_tensor(b), torch.as_tensor(x0),
                                        np.float64(rel_tol), max_iter)
        assert kt == int(kj) > 0
        assert syncs == kt + (kt < max_iter)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)


_CASES = {
    # indirect on DIA operators; rho far from its estimate so adaptive rho
    # rebuilds the preconditioner, and tight eps so the CG tolerance
    # schedule (and its stall cut) runs many checks
    'dia_indirect': (lambda: _mpc_like_qp(seed=8), True,
                     dict(linsys_solver=1, rho=5.0, eps_abs=1e-7, eps_rel=1e-7)),
    # an iteration cap off the check grid: the last epoch has no check, and
    # the post-loop exact and 10x checks decide
    'dia_indirect_capped': (lambda: _mpc_like_qp(seed=8), True,
                            dict(linsys_solver=1, eps_abs=1e-9, eps_rel=1e-9, max_iter=60)),
    'dense_direct': (problems.basic_qp, False,
                     dict(linsys_solver=0, rho=10.0, eps_abs=1e-7, eps_rel=1e-7)),
    'dense_indirect': (problems.basic_qp, False,
                       dict(linsys_solver=1, eps_abs=1e-7, eps_rel=1e-7)),
}


@pytest.mark.parametrize('case', list(_CASES))
def test_solve_scaled_matches_jax(case):
    build, sparse, settings = _CASES[case]
    settings = dict(settings, verbose=False)
    js, (data, scal, rho, factor, it) = _both(build(), sparse, **settings)
    indirect = settings['linsys_solver'] == 1
    want = jcore.solve_scaled(js._data, js._scal, js._core_settings(), js._rho, js._factor,
                              js._iterates, indirect=indirect)
    stg = core_settings(OracleSettings(**settings), torch.float64)
    got = tcore.solve_scaled(data, scal, stg, rho, factor, it, indirect=indirect)
    assert got.status == int(want.status)
    assert got.iters == int(want.iters)
    assert got.rho_updates == int(want.rho_updates)
    assert got.cg_iters == int(want.cg_iters)
    if case == 'dia_indirect':
        assert got.rho_updates > 0 and got.cg_iters > 0
    if case == 'dense_direct':
        assert got.rho_updates > 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0, atol=1e-8)
    # (the rho estimate is left out: a ratio of residual norms near
    # convergence, where the two summation orders' last bits are amplified)
    for k in ('pri_res', 'dua_res', 'obj_val'):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=1e-6, atol=1e-12)
    assert got.host_syncs > 0
