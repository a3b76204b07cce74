"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
neither JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from osqp_tpu_torch import OSQP, BatchedOSQP
from osqp_tpu_torch import batch_shared as tbs
from osqp_tpu_torch.ops import bsr_matvec as tbm
from osqp_tpu_torch.ops import dia_matvec as tdm
from osqp_tpu_torch.ops import ell_matvec as tem
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version on the card, one epoch from
    a state with converged and active columns, at a ragged shape in both
    dtypes.  Statuses equal; f64 values to 1e-9 and f32 values to 1e-4
    relative (FMA contraction and summation order differ)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        B, n, m = 333, 13, 19
        P, A, q, l, u = _problems(B, n, m, seed=4)
        host = OracleSettings(eps_abs=1e-3, eps_rel=1e-3)
        stg = default_core_settings(dtype, eps_abs=1e-3, eps_rel=1e-3)
        P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = tbs.shared_setup(
            P, A, q, l, u, host, dtype=dtype, device='cuda')
        rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
        F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
        CH, At = torch.cat([P_s, A_s]), A_s.T.contiguous()
        sc = tse.epoch_scalars(stg, scal.c, scal.cinv, 25)
        S = torch.zeros((n + 2 * m, B), dtype=dtype, device='cuda')
        st = (S, S[:n].clone(), S[:m].clone(), S.clone(), S[:n].clone(), S[:m].clone(),
              torch.full((B,), 11, dtype=torch.int32, device='cuda'))
        fixed = (F, CH, At, rvec, rinv, scal.D, scal.Dinv, scal.E, scal.Einv, c0, Q, L, U)
        for _ in range(3):
            st = tse.shared_epoch_plain(*fixed, *st, sc)[:7]
        got = tse.shared_epoch(*fixed, *st, sc)
        torch.cuda.synchronize()
        want = tse.shared_epoch_plain(*fixed, *st, sc)
        assert torch.equal(got[6], want[6])
        for k in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10):
            scale = want[k].abs().nan_to_num(0, 0, 0).max().clamp(min=1.0)
            torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol * float(scale),
                                       equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize('B, n, m, dtype, tol, resident', [
    (4096, 32, 48, torch.float32, 2e-4, True),
    (333, 128, 192, torch.float64, 1e-9, False),
])
def test_kernel_plans_match_plain_on_cuda(B, n, m, dtype, tol, resident):
    """The kernel against its plain version at the headline shape in f32 (F
    resident in shared memory) and at a ragged n=128, m=192 batch in f64 (F
    streamed in slabs), one epoch from a state three plain epochs from a cold
    start.  Statuses identical; values within ``tol`` of the state's scale
    (f32 sums run in another order and with FMA contraction; 25 iterations
    of a nonexpansive map keep that to a few 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    P, A, q, l, u = _problems(B, n, m, seed=0)
    host = OracleSettings(eps_abs=1e-3, eps_rel=1e-3)
    stg = default_core_settings(dtype, eps_abs=1e-3, eps_rel=1e-3)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = tbs.shared_setup(
        P, A, q, l, u, host, dtype=dtype, device='cuda')
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    fixed = (F, torch.cat([P_s, A_s]), A_s.T.contiguous(), rvec, rinv, scal.D, scal.Dinv,
             scal.E, scal.Einv, c0, Q, L, U)
    sc = tse.epoch_scalars(stg, scal.c, scal.cinv, 25)
    S = torch.zeros((n + 2 * m, B), dtype=dtype, device='cuda')
    st = (S, S[:n].clone(), S[:m].clone(), S.clone(), S[:n].clone(), S[:m].clone(),
          torch.full((B,), 11, dtype=torch.int32, device='cuda'))
    for _ in range(3):
        st = tse.shared_epoch_plain(*fixed, *st, sc)[:7]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert (tse.plan_tile(n, m, B, S.element_size(), n_sm).ks == n + 2 * m) == resident
    before = tse.launches
    got = tse.shared_epoch(*fixed, *st, sc)
    torch.cuda.synchronize()
    assert tse.launches == before + 1
    want = tse.shared_epoch_plain(*fixed, *st, sc)
    assert torch.equal(got[6], want[6])
    scale = max(1.0, float(want[0].abs().max()))
    for k in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol * scale, equal_nan=True)


def _epoch_case(B, n, m, dtype, seed=0):
    """The fused epoch's inputs on the card at a state three plain epochs
    from a cold start (converged and active columns both present)."""
    P, A, q, l, u = _problems(B, n, m, seed=seed)
    host = OracleSettings(eps_abs=1e-3, eps_rel=1e-3)
    stg = default_core_settings(dtype, eps_abs=1e-3, eps_rel=1e-3)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = tbs.shared_setup(
        P, A, q, l, u, host, dtype=dtype, device='cuda')
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    fixed = (F, torch.cat([P_s, A_s]), A_s.T.contiguous(), rvec, rinv, scal.D, scal.Dinv,
             scal.E, scal.Einv, c0, Q, L, U)
    sc = tse.epoch_scalars(stg, scal.c, scal.cinv, 25)
    S = torch.zeros((n + 2 * m, B), dtype=dtype, device='cuda')
    st = (S, S[:n].clone(), S[:m].clone(), S.clone(), S[:n].clone(), S[:m].clone(),
          torch.full((B,), 11, dtype=torch.int32, device='cuda'))
    for _ in range(3):
        st = tse.shared_epoch_plain(*fixed, *st, sc)[:7]
    return fixed, st, sc


@pytest.mark.cuda
@pytest.mark.parametrize('iter_prec', ['high', 'default'])
@pytest.mark.parametrize('B, n, m', [(4096, 32, 48), (1024, 128, 192), (333, 13, 19)])
def test_kernel_reduced_modes_match_plain_on_cuda(B, n, m, iter_prec):
    """The kernel's tensor-core iteration product (iter_prec 'high' and
    'default', float32) against the plain version on the card, at the
    headline shape (F resident), at n=128, m=192 (F's halves streamed in
    slabs) and at a ragged n=13, m=19 (16-row tiles straddle x and z).  One
    iteration (K=1): statuses equal, values within 1e-5 of the state's scale
    (the two sum in other orders).  One epoch (K=25): the iterates drift
    apart by more than an ulp, so a column at the edge of its termination
    test may stop an epoch apart; statuses equal in 99.9% ('high') or 99%
    ('default') of the columns, and every status is the plain check's of
    the kernel's own iterates.  'high' values within 2e-4 of the scale, as
    'highest' (its lo halves absorb a one-ulp difference in S to 2^-17),
    where the statuses agree; 'default' the state within 5e-2 (one bfloat16
    pass turns a one-ulp difference in S into 2^-8 of the element).  Each
    call launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    fixed, st, sc = _epoch_case(B, n, m, torch.float32)
    scale = max(1.0, float(st[0].abs().max()))
    for K in (1, 25):
        sck = sc._replace(K=K, iter_prec=iter_prec)
        before = tse.launches
        got = tse.shared_epoch(*fixed, *st, sck)
        torch.cuda.synchronize()
        assert tse.launches == before + 1
        want = tse.shared_epoch_plain(*fixed, *st, sck)
        same = got[6] == want[6]
        loose = K == 25 and iter_prec == 'default'
        share = 1.0 if K == 1 else (0.99 if loose else 0.999)
        assert int((~same).sum()) <= (1 - share) * B
        own = tse.shared_epoch_plain(*fixed, *got[:3], *st[3:], sck._replace(K=0))
        assert torch.equal(own[6], got[6])
        tol = 1e-5 if K == 1 else (5e-2 if loose else 2e-4)
        for k in range(3):  # S, dX, dY
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol * scale)
        if not loose:  # per-column results where the statuses agree
            for k in (3, 4, 5):
                torch.testing.assert_close(got[k][:, same], want[k][:, same], rtol=0,
                                           atol=tol * scale)
            for k in (7, 8, 9, 10):
                torch.testing.assert_close(got[k][same], want[k][same], rtol=0,
                                           atol=tol * scale, equal_nan=True)


def _same(a, b):
    """Equal bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(),
                                                                       b.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize('iter_prec', ['high', 'default'])
@pytest.mark.parametrize('B, n, m', [(333, 13, 19), (332, 13, 19), (4096 + 17, 32, 48),
                                     (4096 + 4, 32, 48), (8192 + 4, 32, 48)])
def test_kernel_wgmma_design_on_cuda(B, n, m, iter_prec, monkeypatch):
    """The reduced modes' register-resident wgmma design at ragged edges of
    its 32-column blocks, n=13, m=19 padded to 32 and 48 features.  Where B
    is odd the tiles arrive by cp.async and the captures copy one element at
    a time; where B is a multiple of 4 (332, 4100, 8196: rows 16-byte
    aligned, the last block partial) by cp.async.bulk with the partial
    block's pad columns zeroed, and the captures copy 16 bytes at a time;
    8196 takes more than one wave of blocks.  The plain epoch here sums
    the products as the tensor cores do (``tc_iteration_product``, the
    kernel's k order): with the float32 sums of ``iteration_product`` the
    iterates part in the last bit, and at B=4100 'high' a column at the
    edge of its duality-gap test takes another status at K=1 (that bound
    is ``test_kernel_reduced_modes_match_plain_on_cuda``'s).  K=1:
    statuses equal, values within 1e-5 of the state's scale.  K=25: every
    status is the plain
    check's of the kernel's own iterates and the state lies within 2e-4
    ('high') or 5e-2 ('default') of the plain version's, as for the
    streamed design; at n=32, m=48, where the internal order keeps the k
    steps of 16 in place, the epoch equals the streamed mma.sync design's
    bit for bit (the same bfloat16 products, summed in the same order by
    the tensor cores).  Each call launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    fixed, st, sc = _epoch_case(B, n, m, torch.float32)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tse.plan_tile(n, m, B, 4, n_sm, tse.ITER_PRECS[iter_prec])
    assert plan.design == 'wgmma' and plan.tb == 32
    scale = max(1.0, float(st[0].abs().max()))
    for K in (1, 25):
        sck = sc._replace(K=K, iter_prec=iter_prec)
        before = tse.launches
        got = tse.shared_epoch(*fixed, *st, sck)
        torch.cuda.synchronize()
        assert tse.launches == before + 1
        with monkeypatch.context() as mp:  # the plain epoch with the tensor cores' sums
            mp.setattr(tse, 'iteration_product', tse.tc_iteration_product)
            want = tse.shared_epoch_plain(*fixed, *st, sck)
        own = tse.shared_epoch_plain(*fixed, *got[:3], *st[3:], sck._replace(K=0))
        assert torch.equal(own[6], got[6])
        if K == 1:
            assert torch.equal(got[6], want[6])
            for k in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5 * scale,
                                           equal_nan=True)
        else:
            tol = 2e-4 if iter_prec == 'high' else 5e-2
            for k in range(3):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol * scale)
    if n == 32:
        monkeypatch.setattr(tse, 'plan_tile', tse.block_plan)
        streamed = tse.shared_epoch(*fixed, *st, sck)
        torch.cuda.synchronize()
        assert all(_same(g, s) for g, s in zip(got, streamed))


@pytest.mark.cuda
@pytest.mark.parametrize('iter_prec', ['high', 'default'])
@pytest.mark.parametrize('B, n, m', [(4096, 32, 48), (333, 13, 19), (1024, 128, 192)])
def test_tc_iteration_product_is_the_kernels_on_cuda(B, n, m, iter_prec):
    """The model of the tensor cores' accumulation (``tc_iteration_product``,
    in the kernel's k order) equals the kernel's reduced-mode product, bit
    for bit, in the wgmma design (n = 32,
    m = 48 and the padded n = 13, m = 19) and the streamed mma.sync one
    (n = 128, m = 192): one iteration with alpha = 1 and c0 = 0 leaves the
    product's x rows in the state."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    fixed, st, sc = _epoch_case(B, n, m, torch.float32)
    fixed = (*fixed[:9], torch.zeros_like(fixed[9]), *fixed[10:])
    st = (*st[:6], torch.full_like(st[6], tse.UNSOLVED))
    sck = sc._replace(K=1, iter_prec=iter_prec, alpha=type(sc.alpha)(1.0))
    got = tse.shared_epoch(*fixed, *st, sck)
    torch.cuda.synchronize()
    want = tse.tc_iteration_product(fixed[0], iter_prec)(st[0])[:n]
    assert torch.equal(got[0][:n], want)


@pytest.mark.cuda
@pytest.mark.parametrize('iter_prec', ['high', 'default'])
def test_kernel_wgmma_terminated_block_and_k0_on_cuda(iter_prec):
    """The wgmma design at the headline shape.  A block whose columns have
    all terminated (its statuses set to solved) runs no iteration: its
    state, deltas, captures and statuses come back bit for bit, and its
    check results equal a K=0 launch's.  At K=0 every output equals the
    'highest' design's K=0 outputs bit for bit (the same check on the same
    state)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    B, n, m = 4096, 32, 48
    fixed, st, sc = _epoch_case(B, n, m, torch.float32)
    sck = sc._replace(iter_prec=iter_prec)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tb = tse.plan_tile(n, m, B, 4, n_sm, tse.ITER_PRECS[iter_prec]).tb
    status = st[6].clone()
    status[:tb] = tse.SOLVED
    st = (*st[:6], status)
    got = tse.shared_epoch(*fixed, *st, sck)
    k0 = tse.shared_epoch(*fixed, *st, sck._replace(K=0))
    highest = tse.shared_epoch(*fixed, *st, sc._replace(K=0))
    torch.cuda.synchronize()
    for k in range(7):
        assert torch.equal(got[k][..., :tb], st[k][..., :tb])
    for k in range(7, 11):
        assert _same(got[k][:tb], k0[k][:tb])
    assert all(_same(a, b) for a, b in zip(k0, highest))


@pytest.mark.cuda
def test_reduced_mode_rejected_in_f64_on_cuda():
    """A reduced mode on float64 tensors raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    fixed, st, sc = _epoch_case(64, 5, 7, torch.float64)
    before = tse.launches
    with pytest.raises(ValueError, match='float32 only'):
        tse.shared_epoch(*fixed, *st, sc._replace(iter_prec='high'))
    assert tse.launches == before


@pytest.mark.cuda
def test_batched_osqp_on_cuda_matches_cpu_f64():
    """BatchedOSQP on the card (one kernel launch per epoch) against the same
    solve on the CPU (plain epoch), float64, through a cold solve and a warm
    update: statuses and iteration counts identical, x to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    B, n, m = 600, 12, 18
    P, A, q, l, u = _problems(B, n, m, seed=9)
    q2 = q + 0.01 * np.random.default_rng(10).standard_normal(q.shape)
    runs, launched = {}, {}
    for dev in ('cuda', 'cpu'):
        before = tse.launches
        s = BatchedOSQP(dtype=torch.float64, device=dev)
        s.setup(P, q, A, l, u, eps_abs=1e-5, eps_rel=1e-5)
        r1 = s.solve()
        s.update(q=q2)
        runs[dev] = (r1, s.solve())
        launched[dev] = tse.launches - before
    assert launched['cuda'] > 0 and launched['cpu'] == 0
    for got, want in zip(runs['cuda'], runs['cpu']):
        np.testing.assert_array_equal(got.info.status_val, want.info.status_val)
        np.testing.assert_array_equal(got.info.iter, want.info.iter)
        np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_dia_matvec_matches_plain_on_cuda():
    """The DIA kernel against its plain version on the card: m_out != n_in,
    more than 64 bands, offsets beyond both ends, both dtypes, and D = 0.
    The kernel rounds each product and sum on its own in offset order, as
    the plain version's separate kernels do, so the two agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    rng = np.random.default_rng(0)
    m_out, n_in = 5003, 4001
    offs = np.unique(np.concatenate([[0, -5002, 4000], rng.integers(-300, 300, 80)]))
    assert offs.size > 64
    for dtype in (torch.float32, torch.float64):
        bands = torch.as_tensor(rng.standard_normal((offs.size, m_out)), dtype=dtype,
                                device='cuda')
        v = torch.as_tensor(rng.standard_normal(n_in), dtype=dtype, device='cuda')
        off_t = torch.as_tensor(offs, dtype=torch.int32, device='cuda')
        before = tdm.launches
        got = tdm.dia_matvec(bands, off_t, v)
        torch.cuda.synchronize()
        assert tdm.launches == before + 1
        want = tdm.dia_matvec_plain(bands, offs.tolist(), v)
        assert torch.equal(got, want)
    z = tdm.dia_matvec(torch.zeros((0, 7), device='cuda'),
                       torch.zeros((0,), dtype=torch.int32, device='cuda'),
                       torch.ones(5, device='cuda'))
    assert z.shape == (7,) and not bool(z.any())
    with pytest.raises(ValueError, match='int32'):
        tdm.dia_matvec(bands, off_t.long(), v)


@pytest.mark.cuda
def test_sparse_osqp_on_cuda_matches_cpu_f64():
    """OSQP in sparse mode on the card (DIA kernel) against the same solve on
    the CPU (plain matvec), float64, cold and one warm step: statuses,
    iteration counts and CG steps identical, x to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    import scipy.sparse as sp

    n = 3000
    rng = np.random.default_rng(2)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.9), np.full(n - 1, -0.9)],
                 [0, 1, -1]).tocsc()
    A = (sp.eye(n) + sp.diags([np.full(n - 2, 0.5)], [-2], shape=(n, n))).tocsc()
    q = rng.standard_normal(n)
    runs, launched = {}, {}
    for dev in ('cuda', 'cpu'):
        before = tdm.launches
        s = OSQP(dtype=torch.float64, device=dev, sparse=True)
        s.setup(P=P, q=q, A=A, l=-1.5 * np.ones(n), u=1.5 * np.ones(n), verbose=False,
                eps_abs=1e-6, eps_rel=1e-6)
        r1 = s.solve(raise_error=True)
        s.update(q=1.01 * q)
        runs[dev] = (r1, s.solve(raise_error=True))
        launched[dev] = tdm.launches - before
    assert launched['cuda'] > 0 and launched['cpu'] == 0
    for got, want in zip(runs['cuda'], runs['cpu']):
        assert got.info.status == want.info.status == 'solved'
        assert got.info.iter == want.info.iter
        assert got.info.cg_iters == want.info.cg_iters
        np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-9)


def _rel_err(got, want, scale):
    """max |got - want| relative to each row's sum of |a| |v| (0 for no rows)."""
    if got.numel() == 0:
        return 0.0
    return float(((got - want).abs() / scale.clamp(min=torch.finfo(scale.dtype).tiny)).max())


@pytest.mark.cuda
@pytest.mark.parametrize('m, n, K', [(5003, 4001, 3), (4001, 5003, 13), (777, 900, 40),
                                     (1000, 1000, 1)])
def test_ell_matvec_matches_plain_on_cuda(m, n, K):
    """K3 against its plain version on the card at m != n, K = 3, 13, 40
    (over one warp) and 1, with pads at column 0, both dtypes, at the lanes
    per row the operator would take: each row within 1e-5 (f32) or 1e-12
    (f64) of its sum of |a| |v| (the kernel sums in another order, with FMA);
    a non-finite v[0] reaches the padded rows as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    rng = np.random.default_rng(K)
    cols_h = rng.integers(1, n, (m, K)).astype(np.int32)
    pad = rng.random((m, K)) < 0.2
    data_h = rng.standard_normal((m, K))
    data_h[pad], cols_h[pad] = 0.0, 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        data = torch.as_tensor(data_h, dtype=dtype, device='cuda')
        cols = torch.as_tensor(cols_h, device='cuda')
        lens = tem.row_lens(data, cols)
        log2g = tem.lanes_log2(lens)
        v = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device='cuda')
        before = tem.launches
        got = tem.ell_matvec(data, cols, v, lens, log2g)
        torch.cuda.synchronize()
        assert tem.launches == before + 1
        want = tem.ell_matvec_plain(data, cols, v)
        assert _rel_err(got, want, tem.ell_matvec_plain(data.abs(), cols, v.abs())) <= tol
        v[0] = float('inf')
        got = tem.ell_matvec(data, cols, v, lens, log2g)
        assert torch.equal(got.isnan(), tem.ell_matvec_plain(data, cols, v).isnan())
    with pytest.raises(ValueError, match='int32'):
        tem.ell_matvec(data, cols.long(), v, lens, log2g)
    with pytest.raises(ValueError, match='lens'):
        tem.ell_matvec(data, cols, v, lens.long(), log2g)
    with pytest.raises(ValueError, match='lens'):
        tem.ell_matvec(data, cols, v, lens[1:], log2g)
    with pytest.raises(ValueError, match='lens'):
        tem.ell_matvec(data, cols, v, lens.cpu(), log2g)


def _ell_pads(m, n, K, seed):
    """ELL arrays with rows of every length 0..K (row 0 full, every 7th row
    pads only), trailing pads, and interior pads (zero data at column 0)
    before the last entry; with each row's count of slots before its
    trailing pads."""
    rng = np.random.default_rng(seed)
    want = rng.integers(0, K + 1, m)
    want[0], want[7::7] = K, 0
    slot = np.arange(K)[None, :]
    keep = slot < want[:, None]
    data = np.where(keep, rng.standard_normal((m, K)), 0.0)
    cols = np.where(keep, rng.integers(1, n, (m, K)), 0).astype(np.int32)
    inner = keep & (slot < want[:, None] - 1) & (rng.random((m, K)) < 0.15)
    data[inner], cols[inner] = 0.0, 0
    return data, cols, want


@pytest.mark.cuda
@pytest.mark.parametrize('log2g', [2, 3, 4, 5])
def test_ell_matvec_pads_and_widths_on_cuda(log2g):
    """K3 at each width G = 4, 8, 16 and 32 lanes per row on rows of every
    length up to K = 40 (trailing pads, interior pads, rows of pads only, a
    row at full K) with m = 1001 a multiple of no block's rows, both
    dtypes: each row within 1e-5 (f32) or 1e-12 (f64) of its sum of |a| |v|
    (another summation order, with FMA), and NaN exactly where the plain
    version has it for v[0] = inf, v[0] = nan and v[9] = nan."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    m, n, K = 1001, 700, 40
    data_h, cols_h, want_lens = _ell_pads(m, n, K, seed=log2g)
    rng = np.random.default_rng(100 + log2g)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        data = torch.as_tensor(data_h, dtype=dtype, device='cuda')
        cols = torch.as_tensor(cols_h, device='cuda')
        lens = tem.row_lens(data, cols)
        np.testing.assert_array_equal(lens.cpu().numpy(), want_lens)
        v = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device='cuda')
        before = tem.launches
        got = tem.ell_matvec(data, cols, v, lens, log2g)
        torch.cuda.synchronize()
        assert tem.launches == before + 1
        want = tem.ell_matvec_plain(data, cols, v)
        assert _rel_err(got, want, tem.ell_matvec_plain(data.abs(), cols, v.abs())) <= tol
        for i, bad in ((0, float('inf')), (0, float('nan')), (9, float('nan'))):
            w = v.clone()
            w[i] = bad
            got = tem.ell_matvec(data, cols, w, lens, log2g)
            want = tem.ell_matvec_plain(data, cols, w)
            assert torch.equal(got.isnan(), want.isnan())
            assert bool(got.isnan().any())
            fin = ~want.isnan()
            assert _rel_err(got[fin], want[fin],
                            tem.ell_matvec_plain(data.abs(), cols, v.abs())[fin]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('m, n, density', [(1000, 1000, 0.02), (4096, 640, 0.05),
                                           (61, 1001, 0.3)])
def test_bsr_matvec_matches_plain_on_cuda(m, n, density):
    """K4 against its plain version on the card, m and n multiples of
    neither 8 nor 128 (a partial last block-row and block-column, v not
    padded), both dtypes, v aligned and not: each row within 1e-5 (f32) or
    1e-12 (f64) of its sum of |a| |v|."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    import scipy.sparse as sp

    from osqp_tpu_torch.ops import spmv

    S = sp.random(m, n, density=density, random_state=np.random.default_rng(m), format='csc')
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        M = spmv.bsr_from_scipy(S, dtype, 'cuda')
        buf = torch.as_tensor(np.random.default_rng(1).standard_normal(n + 1), dtype=dtype,
                              device='cuda')
        for v in (buf[:n], buf[1:]):  # 16-byte aligned, then not
            for blocks, bcols, nblk, x, rows in ((M.blocks, M.bcols, M.nblk, v, m),
                                                 (M.blocks_t, M.bcols_t, M.nblk_t,
                                                  v.new_ones(m), n)):
                x = x.contiguous()
                before = tbm.launches
                got = tbm.bsr_matvec(blocks, bcols, x, rows, nblk)
                torch.cuda.synchronize()
                assert tbm.launches == before + 1 and got.shape == (rows,)
                want = tbm.bsr_matvec_plain(blocks, bcols, x, rows)
                scale = tbm.bsr_matvec_plain(blocks.abs(), bcols, x.abs(), rows)
                assert _rel_err(got, want, scale) <= tol
    with pytest.raises(ValueError, match='int32'):
        tbm.bsr_matvec(M.blocks, M.bcols.long(), v.contiguous(), m, M.nblk)
    with pytest.raises(ValueError, match='nblk'):
        tbm.bsr_matvec(M.blocks, M.bcols, v.contiguous(), m, M.nblk.long())
    with pytest.raises(ValueError, match='nblk'):
        tbm.bsr_matvec(M.blocks, M.bcols, v.contiguous(), m, M.nblk[1:])
    with pytest.raises(ValueError, match='nblk'):
        tbm.bsr_matvec(M.blocks, M.bcols, v.contiguous(), m, M.nblk.cpu())


@pytest.mark.cuda
def test_bsr_matvec_padding_and_nan_on_cuda():
    """K4 on block-rows that hold 0 to Kb = 6 stored blocks (interior
    block-column 0 blocks and zero blocks included), m = 8 nbr - 3 and
    n = 1000 (a partial last block-column), both dtypes, v 16-byte aligned
    and not: each row within 1e-5 (f32) or 1e-12 (f64) of its sum of |a| |v|,
    and NaN exactly where the plain version has it for a NaN at v[5], at
    v[127] (both in block-column 0, which every padding block multiplies)
    and at v[200] (block-column 1: only the block-rows that store it)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernel has no CPU mode')
    rng = np.random.default_rng(8)
    Kb, nbr, n = 6, 35, 1000
    m = 8 * nbr - 3
    counts = np.arange(nbr) % (Kb + 1)
    blocks_h = np.zeros((nbr, Kb, 8, 128))
    bcols_h = np.zeros((nbr, Kb), np.int32)
    for b, c in enumerate(counts):
        bcols_h[b, :c] = rng.choice(8, c, replace=False)
        blocks_h[b, :c] = rng.standard_normal((c, 8, 128)) * (rng.random((c, 8, 128)) < 0.3)
    blocks_h[3, 0] = 0.0  # a zero block before the last stored one
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        blocks = torch.as_tensor(blocks_h, dtype=dtype, device='cuda')
        bcols = torch.as_tensor(bcols_h, device='cuda')
        nblk = tbm.block_counts(blocks, bcols)
        np.testing.assert_array_equal(nblk.cpu().numpy(), counts)
        buf = torch.as_tensor(rng.standard_normal(n + 1), dtype=dtype, device='cuda')
        for v, aligned in ((buf[:n], True), (buf[1:], False)):
            assert (v.data_ptr() % 16 == 0) == aligned
            before = tbm.launches
            got = tbm.bsr_matvec(blocks, bcols, v, m, nblk)
            torch.cuda.synchronize()
            assert tbm.launches == before + 1
            want = tbm.bsr_matvec_plain(blocks, bcols, v, m)
            scale = tbm.bsr_matvec_plain(blocks.abs(), bcols, v.abs(), m)
            assert _rel_err(got, want, scale) <= tol
            for i in (5, 127, 200):
                w = v.clone()
                w[i] = float('nan')
                got = tbm.bsr_matvec(blocks, bcols, w, m, nblk)
                want = tbm.bsr_matvec_plain(blocks, bcols, w, m)
                assert torch.equal(got.isnan(), want.isnan())
                assert bool(got.isnan().any()) and not bool(got.isnan().all())
                fin = ~want.isnan()
                assert _rel_err(got[fin], want[fin], scale[fin]) <= tol
