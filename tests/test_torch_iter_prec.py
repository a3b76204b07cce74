"""The shared engine's reduced iteration precisions (iter_prec 'high' and
'default') through the port's entry points on the CPU, where the fused epoch
runs its plain version.

The JAX package's own CPU runs cannot give a reference for whole solves in
these modes (XLA on the CPU computes Precision.DEFAULT and HIGH in full
float32), so these tests hold the port to the modes' contract instead: the
fused and unfused epochs agree, no instance is accepted unconverged, and
'high' converges like 'highest'.  The product itself is held against the
JAX kernel in tests/test_torch_shared_epoch.py."""

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedOSQP
from osqp_tpu_torch import batch_shared as tbs
from osqp_tpu_torch.ops import shared_epoch as tse
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


@pytest.mark.parametrize('iter_prec', ['highest', 'high', 'default'])
def test_fused_matches_unfused(iter_prec):
    """shared_solve with the fused epoch (its plain version on the CPU)
    against the unfused torch epoch in the same mode, float32: statuses and
    iteration counts equal, the iterates to 1e-6.  Both run the same
    iteration product; only the check's sums are grouped otherwise.
    'default' stops at max_iter 300 (it converges slowly)."""
    B, n, m = 40, 10, 15
    P, A, q, l, u = _problems(B, n, m, seed=21)
    over = dict(max_iter=300) if iter_prec == 'default' else {}
    host = OracleSettings(eps_abs=1e-3, eps_rel=1e-3, **over)
    stg = default_core_settings(torch.float32, eps_abs=1e-3, eps_rel=1e-3, **over)
    args = tbs.shared_setup(P, A, q, l, u, host, dtype=torch.float32, device='cpu')
    zeros = tuple(torch.zeros((k, B)) for k in (n, m, m))
    got = {fused: tbs.shared_solve(*args[:6], stg, *args[6:], *zeros, fused=fused,
                                   iter_prec=iter_prec) for fused in (True, False)}
    for k in ('status', 'iters'):
        np.testing.assert_array_equal(got[True][k].numpy(), got[False][k].numpy())
    for k in ('X', 'Z', 'Y', 'x', 'y'):
        np.testing.assert_allclose(got[True][k].numpy(), got[False][k].numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('iter_prec, max_iter', [('high', 4000), ('default', 500)])
def test_iter_precision_never_false_positive(iter_prec, max_iter):
    """The port of tests/test_shared_batch.py's safety contract through
    BatchedOSQP(device='cpu', dtype=float32): the check runs at full
    precision in every mode, so a reduced iteration precision may cost
    iterations or fail to converge but never labels an unconverged instance
    solved.  Outcomes only SOLVED, SOLVED_INACCURATE or MAX_ITER; every
    solved instance with residuals below 1e-2 and x within rtol 0.05 / atol
    0.02 of the 'highest' solve."""
    B, n, m = 33, 13, 19
    P, A, q, l, u = _problems(B, n, m, seed=17)
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, max_iter=max_iter)
    runs = {}
    for prec in ('highest', iter_prec):
        s = BatchedOSQP(device='cpu', dtype=torch.float32, iter_prec=prec)
        runs[prec] = s.setup(P, q, A, l, u, **kw).solve()
    ref, got = runs['highest'], runs[iter_prec]
    assert (ref.info.status_val == 1).all()
    st = got.info.status_val
    assert np.isin(st, (1, 2, 7)).all(), st
    solved = st == 1
    if solved.any():
        assert float(got.info.prim_res[solved].max()) < 1e-2
        assert float(got.info.dual_res[solved].max()) < 1e-2
        np.testing.assert_allclose(got.x[solved], ref.x[solved], rtol=0.05, atol=0.02)


def test_iter_precision_high_bench_family():
    """'high' on the bench family (B=64, n=32, m=48, eps 1e-3, float32)
    solves every instance, with mean iterations within 5% of 'highest': the
    port's counterpart of test_iter_precision_high_matches_highest_tpu,
    which runs on the TPU only."""
    B, n, m = 64, 32, 48
    P, A, q, l, u = _problems(B, n, m, seed=0)
    iters = {}
    for prec in ('highest', 'high'):
        s = BatchedOSQP(device='cpu', dtype=torch.float32, iter_prec=prec)
        r = s.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3).solve()
        assert (r.info.status_val == 1).all(), prec
        iters[prec] = float(r.info.iter.mean())
    assert abs(iters['high'] - iters['highest']) <= 0.05 * iters['highest'], iters


@pytest.mark.parametrize('iter_prec, dtype, match', [
    ('high', torch.float64, 'float32 only'),
    ('default', torch.float64, 'float32 only'),
    ('bf16', torch.float32, 'must be one of'),
    ('HIGH', torch.float64, 'must be one of'),
])
def test_iter_prec_rejected(iter_prec, dtype, match):
    """An unknown mode, or a reduced mode in float64, raises ValueError at
    every entry: BatchedOSQP, shared_solve, the epoch and its iterations."""
    with pytest.raises(ValueError, match=match):
        BatchedOSQP(device='cpu', dtype=dtype, iter_prec=iter_prec)
    B, n, m = 4, 3, 5
    P, A, q, l, u = _problems(B, n, m)
    args = tbs.shared_setup(P, A, q, l, u, OracleSettings(), dtype=dtype, device='cpu')
    stg = default_core_settings(dtype)
    zeros = tuple(torch.zeros((k, B), dtype=dtype) for k in (n, m, m))
    with pytest.raises(ValueError, match=match):
        tbs.shared_solve(*args[:6], stg, *args[6:], *zeros, iter_prec=iter_prec)
    F = torch.zeros((n + m, n + 2 * m), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tse.affine_iterations(F, F[:, :B], args[9], args[9], args[3], args[4],
                              torch.zeros((n + 2 * m, B), dtype=dtype), *zeros[:2], 1.6, 1,
                              iter_prec)


@pytest.mark.parametrize('iter_prec', ['high', 'default'])
def test_wrapper_reduced_mode_runs_plain_on_cpu(iter_prec):
    """On CPU tensors the fused-epoch wrapper returns the plain version's
    result in the reduced modes too, and launches nothing; the result
    differs from 'highest' (the mode reaches the product)."""
    B, n, m = 9, 5, 7
    P, A, q, l, u = _problems(B, n, m, seed=2)
    stg = default_core_settings(torch.float32)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = tbs.shared_setup(
        P, A, q, l, u, OracleSettings(), dtype=torch.float32, device='cpu')
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    S = torch.zeros((n + 2 * m, B))
    st = (S, S[:n], S[:m], S, S[:n], S[:m], torch.full((B,), 11, dtype=torch.int32))
    inputs = (F, torch.cat([P_s, A_s]), A_s.T.contiguous(), rvec, rinv, scal.D, scal.Dinv,
              scal.E, scal.Einv, c0, Q, L, U)
    sc = tse.epoch_scalars(stg, scal.c, scal.cinv, 25, iter_prec)
    first = tse.shared_epoch_plain(*inputs, *st, sc._replace(iter_prec='highest'))[:7]
    before = tse.launches
    got = tse.shared_epoch(*inputs, *first, sc)
    want = tse.shared_epoch_plain(*inputs, *first, sc)
    highest = tse.shared_epoch_plain(*inputs, *first, sc._replace(iter_prec='highest'))
    assert tse.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert not torch.equal(got[0], highest[0])


def test_high_amplifies_ulp_differences():
    """Why 'high' is compared more loosely than 'highest' over an epoch: a
    one-ulp change in S can move S_lo's bfloat16 rounding, by 2^-17 of S, so
    an ulp-level difference grows faster over 25 iterations than in the
    exact product.  From the state after one epoch (B=33, n=13, m=19, f32),
    half its entries moved by one ulp, 25 more iterations move the state by
    5.4e-6 in 'high' and 9.5e-7 in 'highest' (this computation)."""
    B, n, m = 33, 13, 19
    P, A, q, l, u = _problems(B, n, m, seed=7)
    host = OracleSettings(eps_abs=1e-3, eps_rel=1e-3)
    stg = default_core_settings(torch.float32, eps_abs=1e-3, eps_rel=1e-3)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = tbs.shared_setup(
        P, A, q, l, u, host, dtype=torch.float32, device='cpu')
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    S0 = torch.zeros((n + 2 * m, B))
    moved = {}
    for prec in ('highest', 'high'):
        def run(S):
            return tse.affine_iterations(F, c0, rvec, rinv, L, U, S, S[:n], S[:m],
                                         stg.alpha, 25, prec)[0]
        S1 = run(S0)
        up = torch.nextafter(S1, torch.full_like(S1, np.inf))
        half = torch.rand(S1.shape, generator=torch.Generator().manual_seed(0)) < 0.5
        moved[prec] = float((run(S1) - run(torch.where(half, up, S1))).abs().max())
    assert 2 * moved['highest'] < moved['high'] < 1e-4, moved
