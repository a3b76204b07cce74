"""The port's fused shared epoch (osqp_tpu_torch.ops.shared_epoch) and the
batch algebra around it, held against the JAX package on the same inputs.

The plain version runs on the CPU; the CUDA kernel is checked against it on
the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osqp_tpu._oracle.solver import OracleSettings as JaxOracleSettings
from osqp_tpu.batch import default_core_settings as jax_default_core_settings
from osqp_tpu import batch_shared as jbs
from osqp_tpu.ops.shared_epoch import shared_body_pallas

from osqp_tpu_torch import batch_shared as tbs
from osqp_tpu_torch.convert import from_jax_setup
from osqp_tpu_torch.ops import shared_epoch as tse
from osqp_tpu_torch.settings import default_core_settings


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


def _jax_setup(B, n, m, seed, dtype, eps):
    P, A, q, l, u = _problems(B, n, m, seed=seed)
    host = JaxOracleSettings(eps_abs=eps, eps_rel=eps)
    return jbs.shared_setup(P, A, q, l, u, host, dtype=dtype)


def _plain_vs_pallas_interpret(iter_mode, K, epochs, rtol, atol):
    """shared_epoch_plain against the Pallas kernel in interpret mode, f32,
    for ``epochs`` epochs of ``K`` iterations from a cold start at a ragged
    shape (B=33, n=13, m=19), both in ``iter_mode``.  The JAX inputs are
    padded as batch_shared pads them (features to 8, batch to 128) and the
    results sliced back; the port takes the unpadded slices of the same
    arrays, and each epoch starts both from the JAX kernel's state.  The
    state to ``rtol`` / ``atol``, pri and dua to rtol 1e-4 and the larger of
    ``atol`` and 1e-5, statuses equal.  Returns the number of columns solved
    after the last epoch."""
    B0, n0, m0 = 33, 13, 19
    f32 = jnp.float32
    eps = 1e-3
    args = _jax_setup(B0, n0, m0, 7, f32, eps)
    P_s, A_s, Q, L_t, U_t, scal, rho0, Minv, M, rho_vec = args
    stg = jax_default_core_settings(f32, eps_abs=eps, eps_rel=eps)
    n, m, B = 16, 24, 128
    pad2, pad1 = jbs._pad2, jbs._pad1
    Pp, Ap = pad2(P_s, n, n), pad2(A_s, m, n)
    Qp, Lp, Up = pad2(Q, n, B), pad2(L_t, m, B), pad2(U_t, m, B)
    rvec = pad1(rho_vec, m)
    rinv = jnp.where(rvec > 0, 1.0 / rvec, 0.0)
    D, Dinv = pad1(scal.D, n, 1.0), pad1(scal.Dinv, n, 1.0)
    E, Einv = pad1(scal.E, m, 1.0), pad1(scal.Einv, m, 1.0)
    mm = jnp.matmul
    F, c0 = jbs._build_affine(Ap, Ap.T, pad2(Minv, n, n), pad2(M, n, n), rvec, rinv,
                              stg.sigma, stg.alpha, Qp, mm, f32)
    CH = jnp.concatenate([Pp, Ap], axis=0)
    codes = dict(solved=1, pinf=3, dinf=5, unsolved=11, noncvx=9)

    # index maps from the padded layout back to the real rows / columns
    rows_nm = np.r_[0:n0, n:n + m0]
    rows_s = np.r_[0:n0, n:n + m0, n + m:n + m + m0]

    def t(a):
        return torch.tensor(np.asarray(a))

    t_stg = default_core_settings(torch.float32, eps_abs=eps, eps_rel=eps)
    c, cinv = (np.float32(np.asarray(v)) for v in (scal.c, scal.cinv))
    sc = tse.epoch_scalars(t_stg, c, cinv, K, iter_mode)
    zeros = jnp.zeros
    S = zeros((n + 2 * m, B), f32)
    state = (S, zeros((n, B), f32), zeros((m, B), f32), S,
             zeros((n, B), f32), zeros((m, B), f32), jnp.full((B,), 11, jnp.int32))
    n_solved = 0
    for _ in range(epochs):
        got_j = shared_body_pallas(F, CH, Ap.T, rvec, rinv, D, Dinv, E, Einv, c0, Qp, Lp, Up,
                                   *state, stg, scal.c, scal.cinv, codes, K, interpret=True,
                                   iter_mode=iter_mode)
        Sj, dXj, dYj, fSj, fdXj, fdYj, stj = (np.asarray(v) for v in state)
        got_t = tse.shared_epoch_plain(
            t(np.asarray(F)[np.ix_(rows_nm, rows_s)]),
            t(np.asarray(CH)[np.ix_(rows_nm, np.arange(n0))]),
            t(np.asarray(Ap.T)[:n0, :m0]),
            t(rvec[:m0]), t(rinv[:m0]), t(D[:n0]), t(Dinv[:n0]), t(E[:m0]), t(Einv[:m0]),
            t(np.asarray(c0)[rows_nm, :B0]), t(Q), t(L_t), t(U_t),
            t(Sj[rows_s, :B0]), t(dXj[:n0, :B0]), t(dYj[:m0, :B0]),
            t(fSj[rows_s, :B0]), t(fdXj[:n0, :B0]), t(fdYj[:m0, :B0]), t(stj[:B0]), sc,
        )
        want = [np.asarray(v) for v in got_j]
        rows = [rows_s, slice(0, n0), slice(0, m0)] * 2  # S dX dY fS fdX fdY
        for k, r in enumerate(rows):
            np.testing.assert_allclose(got_t[k].numpy(), want[k][r][:, :B0], rtol=rtol, atol=atol)
        np.testing.assert_array_equal(got_t[6].numpy(), want[6][:B0])
        for k in (7, 8):  # pri, dua
            np.testing.assert_allclose(got_t[k].numpy(), want[k][:B0], rtol=1e-4,
                                       atol=max(atol, 1e-5))
        n_solved = int((want[6][:B0] == 1).sum())
        state = tuple(got_j[:7])
    return n_solved


def test_plain_epoch_matches_pallas_interpret():
    """shared_epoch_plain against the Pallas kernel in interpret mode, f32,
    for two epochs from a cold start at a ragged shape.  Tolerance rtol 1e-4 /
    atol 1e-5, as test_fused_epoch_equivalence: float32 sums run in another
    order in XLA and in torch."""
    n_solved = _plain_vs_pallas_interpret('highest', 25, 2, 1e-4, 1e-5)
    # the second epoch saw both converged and still-active columns
    assert 0 < n_solved < 33


@pytest.mark.parametrize('K, epochs, rtol, atol', [(1, 3, 0, 1e-6), (25, 2, 1e-4, 5e-5)])
def test_plain_high_matches_pallas_interpret(K, epochs, rtol, atol):
    """iter_prec 'high' (F and S split into bfloat16 hi and lo halves, three
    products) against the JAX kernel's iter_mode 'high' in interpret mode,
    which splits with the same astype roundings on the CPU.  Three one-
    iteration epochs (the first from the zero state, whose product is zero)
    hold the product to atol 1e-6.  Two epochs of 25 iterations: statuses
    equal, the state, pri and dua to rtol 1e-4 / atol 5e-5, five times the
    atol of 'highest': a one-ulp change in S can move S_lo's rounding by
    2^-17 of S, so the sums' other order in XLA and in torch grows faster
    here than in the exact product (test_torch_iter_prec.py::
    test_high_amplifies_ulp_differences) and exceeds 'highest''s atol over
    two epochs."""
    n_solved = _plain_vs_pallas_interpret('high', K, epochs, rtol, atol)
    if K == 25:
        assert 0 < n_solved < 33


def _bf16_iteration_inputs(seed=7):
    """f32 inputs of one affine iteration at the ragged shape: F, c0, rho,
    1/rho, L, U from the JAX package's setup and map, and a state near the
    bounds, as numpy arrays."""
    B, n, m = 33, 13, 19
    args = _jax_setup(B, n, m, seed, jnp.float32, 1e-3)
    P_s, A_s, Q, L_t, U_t, scal, rho0, Minv, M, rho_vec = args
    stg = jax_default_core_settings(jnp.float32)
    rinv = jnp.where(rho_vec > 0, 1.0 / rho_vec, 0.0)
    F, c0 = jbs._build_affine(A_s, A_s.T, Minv, M, rho_vec, rinv, stg.sigma, stg.alpha, Q,
                              jnp.matmul, jnp.float32)
    X, Z, Y, dX, dY = _random_state(args, seed)
    S = np.concatenate([X, Z, 10 * Y], axis=0).astype(np.float32)
    return dict(F=np.asarray(F), c0=np.asarray(c0), rho=np.asarray(rho_vec),
                rinv=np.asarray(rinv), L=np.asarray(L_t), U=np.asarray(U_t), S=S,
                alpha=np.float32(stg.alpha), n=n, m=m)


def _torch_iteration(d, iter_prec):
    t = torch.tensor
    n, m = d['n'], d['m']
    S, _, _ = tse.affine_iterations(t(d['F']), t(d['c0']), t(d['rho']), t(d['rinv']),
                                    t(d['L']), t(d['U']), t(d['S']), t(d['S'][:n]),
                                    t(d['S'][:m]), d['alpha'], 1, iter_prec)
    return S.numpy()


def test_plain_default_matches_jax_bf16_reference():
    """iter_prec 'default' for one iteration against the JAX reference of
    what the TPU computes: the iteration of _body_kernel with its product
    ``jnp.dot(F.astype(bf16), S.astype(bf16), preferred_element_type=f32)``
    (on the CPU the Pallas kernel in interpret mode ignores
    Precision.DEFAULT and computes in full float32).  atol 1e-6."""
    d = _bf16_iteration_inputs()
    n, m = d['n'], d['m']
    bf16 = jnp.bfloat16
    S = jnp.asarray(d['S'])
    V = jnp.dot(jnp.asarray(d['F']).astype(bf16), S.astype(bf16),
                preferred_element_type=jnp.float32) + d['c0']
    X, Y = S[:n], S[n + m:]
    Zn = jnp.clip(V[n:], d['L'], d['U'])
    Yn = Y + d['rho'][:, None] * (V[n:] - d['rinv'][:, None] * Y - Zn)
    Xn = d['alpha'] * V[:n] + (1 - d['alpha']) * X
    want = np.asarray(jnp.concatenate([Xn, Zn, Yn], axis=0))
    np.testing.assert_allclose(_torch_iteration(d, 'default'), want, rtol=0, atol=1e-6)


def test_plain_default_is_not_float32():
    """The plain 'default' iteration differs from the float32 one by more
    than 1e-3 (one bfloat16 pass keeps 8 bits of each operand), and each of
    its products is the float32 product of the bfloat16 values: it is
    neither the exact product nor torch's bfloat16 matmul, whose result is
    itself rounded to bfloat16."""
    d = _bf16_iteration_inputs()
    got = _torch_iteration(d, 'default')
    assert np.abs(got - _torch_iteration(d, 'highest')).max() > 1e-3
    F, S = torch.as_tensor(d['F']), torch.as_tensor(d['S'])
    bf = (F.to(torch.bfloat16) @ S.to(torch.bfloat16)).float()
    exact = F.to(torch.bfloat16).double() @ S.to(torch.bfloat16).double()
    prod = tse.iteration_product(F, 'default')(S)
    assert float((prod.double() - exact).abs().max()) < 1e-5
    assert float((bf.double() - exact).abs().max()) > 1e-3


def _random_state(args, seed):
    rng = np.random.default_rng(seed)
    P_s, A_s, Q, L_t, U_t = (np.asarray(v) for v in args[:5])
    n, B = Q.shape
    m = A_s.shape[0]
    X = rng.standard_normal((n, B)) * 0.1
    Z = np.clip(A_s @ X + 0.01 * rng.standard_normal((m, B)), L_t, U_t)
    Y = rng.standard_normal((m, B)) * 0.05
    dX = rng.standard_normal((n, B)) * 1e-6
    dY = rng.standard_normal((m, B)) * 1e-6
    return X, Z, Y, dX, dY


@pytest.mark.parametrize('approximate', [False, True])
def test_batch_check_matches_jax(approximate):
    """_batch_check_shared against JAX's on the same scaled data and random
    states, float64: statuses equal, values to rtol 1e-12."""
    B, n, m = 12, 9, 13
    f64 = jnp.float64
    args = _jax_setup(B, n, m, 5, f64, 1e-3)
    X, Z, Y, dX, dY = _random_state(args, 5)
    stg = jax_default_core_settings(f64, eps_abs=1e-3, eps_rel=1e-3)
    j = jnp.asarray
    want = jbs._batch_check_shared(*args[:6], stg, j(X), j(Z), j(Y), j(dX), j(dY),
                                   jnp.asarray(approximate), jnp.matmul)
    port = from_jax_setup((*_np_arrays(args), X, Z, Y), 'cpu', torch.float64)
    t_stg = default_core_settings(torch.float64, eps_abs=1e-3, eps_rel=1e-3)
    tX, tZ, tY = port[10:]
    got = tbs._batch_check_shared(*port[:6], t_stg, tX, tZ, tY,
                                  torch.as_tensor(dX), torch.as_tensor(dY), approximate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for gi, wi in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-12, atol=1e-12)


def _np_arrays(args):
    P_s, A_s, Q, L_t, U_t, scal, rho0, Minv, M, rho_vec = args
    return (np.asarray(P_s), np.asarray(A_s), np.asarray(Q), np.asarray(L_t), np.asarray(U_t),
            tuple(np.asarray(v) for v in scal), np.asarray(rho0),
            np.asarray(Minv), np.asarray(M), np.asarray(rho_vec))


def test_rho_estimate_matches_jax():
    """_batch_rho_estimate against JAX's, float64, rtol 1e-12."""
    rng = np.random.default_rng(7)
    B, n, m = 11, 10, 14
    P, A, q, l, u = _problems(B, n, m, seed=7)
    X = rng.standard_normal((n, B))
    Z = rng.standard_normal((m, B))
    Y = rng.standard_normal((m, B))
    CH = np.concatenate([P, A], axis=0)
    j = jnp.asarray
    want = jbs._batch_rho_estimate(j(CH), j(A.T), n, j(q.T), j(X), j(Z), j(Y),
                                   jnp.asarray(0.37, jnp.float64), jnp.matmul)
    t = torch.as_tensor
    got = tbs._batch_rho_estimate(t(CH), t(A.T.copy()), n, t(q.T.copy()), t(X), t(Z), t(Y),
                                  np.float64(0.37))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)


def test_build_affine_matches_jax():
    """The affine iteration map F and constant c0 against JAX's, float64."""
    B, n, m = 7, 9, 13
    args = _jax_setup(B, n, m, 3, jnp.float64, 1e-3)
    P_s, A_s, Q, L_t, U_t, scal, rho0, Minv, M, rho_vec = args
    stg = jax_default_core_settings(jnp.float64)
    rinv = jnp.where(rho_vec > 0, 1.0 / rho_vec, 0.0)
    F, c0 = jbs._build_affine(A_s, A_s.T, Minv, M, rho_vec, rinv, stg.sigma, stg.alpha,
                              Q, jnp.matmul, jnp.float64)
    port = from_jax_setup((*_np_arrays(args), *(np.zeros((k, B)) for k in (n, m, m))),
                          'cpu', torch.float64)
    tA, tQ, tMinv, tM, trv = port[1], port[2], port[7], port[8], port[9]
    t_stg = default_core_settings(torch.float64)
    tF, tc0 = tbs._build_affine(tA, tA.T, tMinv, tM, trv,
                                torch.where(trv > 0, 1.0 / trv, 0.0), t_stg.sigma,
                                t_stg.alpha, tQ)
    np.testing.assert_allclose(tF.numpy(), np.asarray(F), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tc0.numpy(), np.asarray(c0), rtol=1e-12, atol=1e-14)


def test_pick_tile():
    """The kernel's plan at the four shapes chip_smoke.py checks: the tile
    width that least loads the busiest SM, F resident where it fits beside
    the tiles (ks = n + 2m) and streamed in slabs otherwise, one 4 x 2 or
    4 x 1 micro-tile per thread with at least 256 threads where the rows
    allow, shared memory within the Hopper limit; too large a problem
    raises."""
    plan = tse.plan_tile
    assert plan(32, 48, 4096, 4, 132) == tse.TilePlan(32, 320, 2, 128)
    assert tse.smem_bytes(32, 48, 32, 128, 4) == 121216
    assert plan(32, 48, 4096, 8, 132) == tse.TilePlan(32, 320, 2, 128)
    assert tse.smem_bytes(32, 48, 32, 128, 8) == 224000
    assert plan(128, 192, 1024, 4, 132) == tse.TilePlan(8, 320, 2, 120)
    assert plan(13, 19, 333, 8, 132) == tse.TilePlan(4, 32, 1, 51)
    assert tse.smem_bytes(13, 19, 4, 51, 8) == 21456
    assert plan(128, 192, 4096, 4, 132) == tse.TilePlan(8, 320, 2, 120)
    assert plan(32, 48, 8192, 4, 132).tb == 32
    assert plan(13, 19, 50, 8, 132).tb == 1
    for n, m, B, size in ((32, 48, 4096, 4), (128, 192, 1024, 4), (13, 19, 333, 8),
                          (32, 48, 4096, 8), (128, 192, 4096, 8), (128, 192, 64, 4),
                          (128, 192, 4096, 4)):
        p = plan(n, m, B, size, 132)
        assert tse.smem_bytes(n, m, p.tb, p.ks, size) <= tse._SMEM_LIMIT
        assert p.threads == -(-(n + m) // 4) * p.tb // p.tc
        assert p.tb <= p.threads <= tse._MAX_THREADS
        assert p.tc in (1, 2) and p.tc <= p.tb
        assert p.ks <= n + 2 * m
    with pytest.raises(ValueError, match='shared memory'):
        plan(4000, 4000, 64, 8, 132)
    with pytest.raises(ValueError, match='micro-tile per thread'):
        plan(1000, 1100, 64, 4, 132)


def _cu_layout_regions(count='kRegions'):
    """The region sizes of ``Layout`` (or, with ``count='kWgRegions'``, of
    ``WgLayout``) in csrc/shared_epoch.cu, as source expressions."""
    import re
    from pathlib import Path

    src = (Path(tse.__file__).parent / 'csrc' / 'shared_epoch.cu').read_text()
    body = re.search(r'const int sizes\[' + count + r'\] = \{(.*?)\};', src, re.S).group(1)
    exprs = [line.split('//')[0].strip().rstrip(',') for line in body.splitlines()]
    return [e for e in exprs if e]


@pytest.mark.parametrize('n, m, B, size', [(32, 48, 4096, 4), (128, 192, 1024, 4),
                                           (32, 48, 4096, 8), (128, 192, 1024, 8)])
def test_plan_smem_matches_cu_layout(n, m, B, size):
    """The planner's shared-memory figure is the kernel's: the regions that
    csrc/shared_epoch.cu lays out, evaluated at the plan's TB and KS and the
    stride rule of w_stride, each rounded up to 16 bytes.  F is resident at
    n=32, m=48 and streamed in slabs at n=128, m=192, in both dtypes."""
    p = tse.plan_tile(n, m, B, size, 132)
    resident = p.ks == n + 2 * m
    assert resident == (n == 32)
    nm = n + m
    ldw = tse.w_stride(nm, size)
    assert ldw >= -(-nm // 4) * 4 and (ldw * size) % 128 == 16
    assert _cu_layout_bytes(n, m, p.tb, p.ks, size, 0) == tse.smem_bytes(n, m, p.tb, p.ks, size)
    if not resident:  # the deepest 8-multiple slab that fits
        assert tse.smem_bytes(n, m, p.tb, p.ks + 8, size) > tse._SMEM_LIMIT


def _cu_layout_bytes(n, m, tb, ks, size, halves):
    """The bytes of the .cu source's ``Layout`` at a plan: its region
    expressions evaluated with the names the constructor defines, each
    rounded up to 16 bytes."""
    nm, N2 = n + m, n + 2 * m
    env = dict(n=n, m=m, nm=nm, N2=N2, TB=tb, KS=ks, LDW=tse.w_stride(nm, size), H=halves,
               MP=-(-nm // 16) * 16, LDA2=tse.bf16_words(ks), LDK2=tse.bf16_words(N2),
               imax=max)
    regions = _cu_layout_regions()
    assert len(regions) == 14
    align = 16 // size
    return sum(-(-eval(e, {}, env) // align) * align for e in regions) * size


def _cu_wg_layout_bytes(n, m, halves, xc, yc, tb):
    """The bytes of the .cu source's ``WgLayout`` at a plan: its region
    expressions evaluated with the names the constructor defines, each
    rounded up to 16 bytes."""
    nm = n + m
    env = dict(n=n, m=m, nm=nm, N2=n + 2 * m, TB=tb, LDW=tse.w_stride(nm, 4), H=halves,
               NV=xc + yc, KT=-(-(xc + 2 * yc) // 2), XC=xc, YC=yc, imax=max)
    regions = _cu_layout_regions('kWgRegions')
    assert len(regions) == 13
    return sum(-(-eval(e, {}, env) // 4) * 4 for e in regions) * 4


@pytest.mark.parametrize('halves', [1, 2])
@pytest.mark.parametrize('n, m, B', [(32, 48, 4096), (128, 192, 1024), (13, 19, 333)])
def test_plan_reduced_modes(n, m, B, halves):
    """The reduced modes' plans at the headline, slab and ragged shapes.  The
    headline and the ragged shape take the wgmma design: 32 columns per
    block, 256 threads, micro-tiles 4 x 2 in the check, F resident
    (ks = n + 2m), the instantiated padding (4, 6), shared memory within the
    limit and equal to the .cu source's WgLayout.  n=128, m=192 exceeds the
    padding and keeps
    the streamed mma.sync plan: at least 8 columns per block (the
    tensor-core tiles' width), whole warps of threads, at most 4 tiles of V
    per warp, F streamed in the deepest slab of whole 16-deep k tiles that
    fits; its shared memory is the .cu source's Layout.  Neither runs in
    float64."""
    p = tse.plan_tile(n, m, B, 4, 132, halves)
    if n != 128:
        assert p.design == 'wgmma'
        assert (p.tb, p.threads, p.tc, p.ks) == (32, 256, 2, n + 2 * m)
        assert (p.xc, p.yc) == (4, 6)
        smem = tse.wg_smem_bytes(n, m, halves, p.xc, p.yc, p.tb)
        assert smem <= tse._SMEM_LIMIT
        assert _cu_wg_layout_bytes(n, m, halves, p.xc, p.yc, p.tb) == smem
        with pytest.raises(ValueError, match='float32'):
            tse.make_plan(n, m, 32, 2, 8, halves)
        return
    assert p.design == 'mma_sync' and (p.xc, p.yc) == (0, 0)
    assert p.tb >= 8 and p.threads % 32 == 0 and p.tb <= p.threads <= tse._MAX_THREADS
    tiles = -(-(n + m) // 16) * (p.tb // 8)
    assert -(-tiles // (p.threads // 32)) <= tse._MAX_TILES
    smem = tse.smem_bytes(n, m, p.tb, p.ks, 4, halves)
    assert smem <= tse._SMEM_LIMIT
    assert _cu_layout_bytes(n, m, p.tb, p.ks, 4, halves) == smem
    assert p.ks < n + 2 * m and p.ks % 16 == 0
    assert tse.smem_bytes(n, m, p.tb, p.ks + 16, 4, halves) > tse._SMEM_LIMIT
    with pytest.raises(ValueError, match='float32'):
        tse.make_plan(n, m, p.tb, p.tc, 8, halves)


@pytest.mark.parametrize('B', [64, 4096, 4224, 4225, 8209])
def test_plan_wgmma_block_width(B):
    """The wgmma design takes 32 columns per block (one per iterating
    thread) at every batch size, below one wave of blocks over 132 SMs
    (4224 columns) and past it.  Its shared memory fits at the headline
    shape in either reduced mode, as the .cu source lays it out; 'highest'
    and float64 never take it, and a shape past the padding (n = 33 or
    m = 49) takes the streamed design."""
    for halves in (1, 2):
        p = tse.plan_tile(32, 48, B, 4, 132, halves)
        assert p.design == 'wgmma' and p.tb == 32 and p.threads == 256
        smem = tse.wg_smem_bytes(32, 48, halves, 4, 6, 32)
        assert smem <= tse._SMEM_LIMIT
        assert _cu_wg_layout_bytes(32, 48, halves, 4, 6, 32) == smem
        assert tse.plan_tile(33, 48, B, 4, 132, halves).design == 'mma_sync'
        assert tse.plan_tile(32, 49, B, 4, 132, halves).design == 'mma_sync'
    assert tse.plan_tile(32, 48, B, 4, 132).design == 'cuda_cores'
    assert tse.plan_tile(32, 48, B, 8, 132).design == 'cuda_cores'


@pytest.mark.parametrize('n, m', [(32, 48), (13, 19), (20, 13)])
def test_wg_positions_pair_z_and_y(n, m):
    """The wgmma design's internal feature order at its padding: x, z and
    y in disjoint 8-aligned segments of the state, zero-padded to whole k
    steps of 16; V's x~ and Pz where x and z sit.  A thread holds features 8 c + 2 tig + {0, 1} of every chunk c of
    8, so Pz_j, z_j and y_j share the thread and the element (position mod
    8), and y_j's chunk is z_j's plus yc, a compile-time offset."""
    xc, yc = tse._WG_PAD
    s_pos, v_pos, n_s, n_v = tse.wg_positions(n, m, xc, yc)
    assert n_s % 16 == 0 and n_s >= 8 * (xc + 2 * yc) and n_v == 8 * (xc + yc) >= n + m
    assert len(set(s_pos.tolist())) == n + 2 * m and s_pos.max() < n_s
    x, z, y = s_pos[:n], s_pos[n:n + m], s_pos[n + m:]
    assert x.max() < 8 * xc <= z.min() and z.max() < 8 * (xc + yc) <= y.min()
    np.testing.assert_array_equal(v_pos, s_pos[:n + m])
    np.testing.assert_array_equal(z % 8, y % 8)
    np.testing.assert_array_equal(y // 8, z // 8 + yc)
    np.testing.assert_array_equal(v_pos[n:] % 8, z % 8)
    with pytest.raises(ValueError):
        tse.wg_positions(8 * xc + 1, m, xc, yc)


@pytest.mark.parametrize('n, m, dtype, iter_prec', [
    (32, 48, torch.float64, 'highest'), (13, 19, torch.float64, 'highest'),
    (13, 19, torch.float32, 'high'), (20, 13, torch.float32, 'default')])
def test_wg_order_iteration_matches_affine_iterations(n, m, dtype, iter_prec):
    """The plain iteration run in the wgmma design's padded, permuted order
    (F, c0, L, U, rho and 1/rho zero-padded; the y update reading y_j at
    z_j's position plus 8 yc) equals affine_iterations within 1e-6 of the
    state's scale, and its padding stays exactly zero."""
    xc, yc = tse._WG_PAD
    s_pos, v_pos, n_s, n_v = tse.wg_positions(n, m, xc, yc)
    rng = np.random.default_rng(5)
    B, nm, N2, K = 24, n + m, n + 2 * m, 6
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    F = t(rng.standard_normal((nm, N2)) / np.sqrt(N2))
    c0 = t(rng.standard_normal((nm, B)))
    U = t(rng.random((m, B)) + 0.1)
    L = -U
    rho = t(rng.random(m) + 0.5)
    S = t(rng.standard_normal((N2, B)))
    dX, dY = t(np.zeros((n, B))), t(np.zeros((m, B)))
    alpha = tse.np_dtype(dtype)(1.6)
    want = tse.affine_iterations(F, c0, rho, 1 / rho, L, U, S, dX, dY, alpha, K, iter_prec)[0]

    zo, yo, nz = 8 * xc, 8 * (xc + yc), 8 * yc
    F_i = torch.zeros((n_v, n_s), dtype=dtype)
    F_i[torch.as_tensor(v_pos)[:, None], torch.as_tensor(s_pos)[None, :]] = F
    c0_i = torch.zeros((n_v, B), dtype=dtype)
    c0_i[torch.as_tensor(v_pos)] = c0
    L_i, U_i = torch.zeros((nz, B), dtype=dtype), torch.zeros((nz, B), dtype=dtype)
    L_i[:m], U_i[:m] = L, U
    r_i, ri_i = torch.zeros((nz, 1), dtype=dtype), torch.zeros((nz, 1), dtype=dtype)
    r_i[:m, 0], ri_i[:m, 0] = rho, 1 / rho
    S_i = torch.zeros((n_s, B), dtype=dtype)
    S_i[torch.as_tensor(s_pos)] = S
    product = tse.iteration_product(F_i, iter_prec)
    for _ in range(K):
        V = product(S_i) + c0_i
        X, Y = S_i[:zo], S_i[yo:yo + nz]
        Pz = V[zo:zo + nz]
        Zn = torch.minimum(torch.maximum(Pz, L_i), U_i)
        S_i = torch.cat([alpha * V[:zo] + (1 - alpha) * X, Zn,
                         Y + r_i * (Pz - ri_i * Y - Zn), S_i[yo + nz:]])
    got = S_i[torch.as_tensor(s_pos)]
    pad = torch.ones(n_s, dtype=torch.bool)
    pad[torch.as_tensor(s_pos)] = False
    assert bool((S_i[pad] == 0).all())
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing."""
    B, n, m = 9, 5, 7
    args = _jax_setup(B, n, m, 2, jnp.float64, 1e-3)
    port = from_jax_setup((*_np_arrays(args), *(np.zeros((k, B)) for k in (n, m, m))),
                          'cpu', torch.float64)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = port[:10]
    stg = default_core_settings(torch.float64)
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = tbs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    S = torch.zeros((n + 2 * m, B), dtype=torch.float64)
    inputs = (F, torch.cat([P_s, A_s]), A_s.T.contiguous(), rvec, rinv, scal.D, scal.Dinv,
              scal.E, scal.Einv, c0, Q, L, U, S, S[:n], S[:m], S, S[:n], S[:m],
              torch.full((B,), 11, dtype=torch.int32))
    sc = tse.epoch_scalars(stg, scal.c, scal.cinv, 25)
    before = tse.launches
    got = tse.shared_epoch(*inputs, sc)
    want = tse.shared_epoch_plain(*inputs, sc)
    assert tse.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
