"""The port's ELL, BSR and BCOO operators (osqp_tpu_torch.ops.spmv, with the
plain versions of kernels K3 and K4) against the JAX package's on the CPU in
float64.

- Each operator class's ``@``, ``.T @``, ``diag()``, ``gram_diag()``,
  ``astype`` and ``todense`` against ``osqp_tpu.ops.spmv``'s (BCOO: against
  ``jax.experimental.sparse`` and ``osqp_tpu.solver.core``), on ragged
  shapes, to 1e-12 of the row scale.
- ``choose_format`` against the JAX package's on the families of
  tests/test_spmv.py, at the default dense budget and at two small ones.
- ``OSQP(sparse=True)`` with each format forced against
  ``osqp_tpu.OSQP(algebra='jax', sparse=True)`` on tests/test_spmv.py's
  ``_mpc_like_qp`` and ``_clustered_qp``: equal statuses and iterations, x
  and y within 1e-8, through ``update(q, l, u)``, ``update(Px, Ax)`` and a
  polish.
- The solve loop from the JAX solver's ELL, BSR and BCOO state
  (``convert.from_jax_solver``): equal statuses, iterations and CG steps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import sparse as jsparse

import osqp_tpu
from osqp_tpu.backends.jax_backend import Solver as JaxSolver
from osqp_tpu.ops import spmv as jspmv
from osqp_tpu.solver import core as jcore

import osqp_tpu_torch
from osqp_tpu_torch.convert import from_jax_solver
from osqp_tpu_torch.ops import bsr_matvec as tbm
from osqp_tpu_torch.ops import ell_matvec as tem
from osqp_tpu_torch.ops import spmv as tspmv
from osqp_tpu_torch.settings import OracleSettings, core_settings
from osqp_tpu_torch.solver import core as tcore

TOL = 1e-12
ATOL = 1e-8


# --- the generators of tests/test_spmv.py, the port's copies -----------------

def _random_banded(m, n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    S = sp.lil_matrix((m, n))
    for o in offsets:
        i = np.arange(max(0, -o), min(m, n - o))
        S[i, i + o] = rng.standard_normal(len(i))
    return S.tocsc()


def _random_sparse(m, n, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng, format='csc')


def _clustered_sparse(mb, nb, frac=0.1, R=8, C=128, seed=0):
    rng = np.random.default_rng(seed)
    picks = rng.random((mb, nb)) < frac
    br, bc = np.nonzero(picks)
    if br.size == 0:
        br, bc = np.array([0]), np.array([0])
    rows = (br[:, None] * R + np.arange(R)[None, :]).repeat(C, axis=1).ravel()
    cols = np.tile((bc[:, None] * C + np.arange(C)[None, :]), (1, R)).ravel()
    data = rng.standard_normal(rows.size)
    return sp.coo_matrix((data, (rows, cols)), shape=(mb * R, nb * C)).tocsc()


def _mpc_like_qp(T=14, seed=0):
    rng = np.random.default_rng(seed)
    n = 2 * T
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.6), np.full(n - 1, -0.6)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = sp.eye(n, format='csc') + sp.diags([np.full(n - 2, 0.3)], [-2], shape=(n, n))
    return P, q, A.tocsc(), -np.ones(n) * 2, np.ones(n) * 2


def _super_clustered(nsb, pairs, seed, scale):
    rng = np.random.default_rng(seed)
    n = nsb * 128
    S = sp.lil_matrix((n, n))
    for (i, j) in [(i, i) for i in range(nsb)] + sorted(pairs):
        B = rng.standard_normal((128, 128)) * scale
        if i == j:
            B = (B + B.T) / 2
        S[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = B
        if i != j:
            S[j * 128:(j + 1) * 128, i * 128:(i + 1) * 128] = B.T
    return S.tocsc()


def _clustered_qp(seed=0, nsb=32, n_pairs=15):
    rng = np.random.default_rng(seed)
    n = nsb * 128
    pairs = set()
    while len(pairs) < n_pairs:
        i, j = sorted(rng.integers(nsb, size=2))
        if i != j:
            pairs.add((int(i), int(j)))
    scale = 1.0 / (128 * 8)
    P = (_super_clustered(nsb, pairs, seed, scale) + sp.eye(n)).tocsc()
    A = _super_clustered(nsb, pairs, seed + 1, 1.0 / 64).tocsc()
    A = (A + sp.eye(n)).tocsc()
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    l = u - 2 * s0
    return P, q, A, l, u


# --- operators ---------------------------------------------------------------

def _ragged_rows(m, n, seed):
    """Rows of 0 to 13 entries at random columns, one row full."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 14, m)
    rows = np.repeat(np.arange(m), counts)
    cols = rng.integers(0, n, rows.size)
    S = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(m, n)).tolil()
    S[m // 2, :] = rng.standard_normal(n)
    return S.tocsc()


_MATRICES = {
    'banded_square': lambda: _random_banded(33, 33, (-5, -1, 0, 1, 5)),
    'random_m_lt_n': lambda: _random_sparse(40, 56, 0.08, seed=1),
    'random_m_gt_n': lambda: _random_sparse(56, 40, 0.12, seed=2),
    'clustered': lambda: _clustered_sparse(5, 3, frac=0.3, seed=11),
    'partial_blocks': lambda: _random_sparse(317, 290, 0.03, seed=12),
    'empty_block_row': lambda: sp.csc_matrix(
        (np.ones(3), (np.array([0, 1, 60]), np.array([5, 200, 17]))), shape=(64, 260)),
    'ragged_square': lambda: _ragged_rows(130, 130, seed=3),
    'ragged_1000': lambda: _random_sparse(1000, 1000, 0.004, seed=13),
}


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize('name', list(_MATRICES))
@pytest.mark.parametrize('fmt', ['ell', 'bsr', 'bcoo'])
def test_operator_matches_jax(fmt, name):
    """``@``, ``.T @``, ``gram_diag``, ``diag`` (square), ``todense`` and an
    f32 ``astype`` of the port's operator against the JAX package's, f64."""
    S = _MATRICES[name]()
    S.sum_duplicates()
    m, n = S.shape
    J = jspmv.from_scipy(S, np.float64, fmt)
    T = tspmv.from_scipy(S, torch.float64, fmt)
    assert tspmv.is_structured(T) and T.shape == (m, n) and T.dtype == torch.float64
    assert T.device == torch.device('cpu')
    rng = np.random.default_rng(3)
    v, w, rho = rng.standard_normal(n), rng.standard_normal(m), rng.uniform(0.5, 2.0, m)
    _close(T @ torch.as_tensor(v), J @ v)
    _close(T.T @ torch.as_tensor(w), J.T @ w)
    # BCOO has no class in the JAX package: its core's helpers take it
    _close(T.gram_diag(torch.as_tensor(rho)), jcore.gram_diag(J, rho))
    if m == n:
        _close(T.diag(), jcore.mat_diag(J))
    want_dense = np.asarray(J.todense())
    np.testing.assert_array_equal(T.todense().numpy(), want_dense)
    np.testing.assert_array_equal(want_dense, S.toarray())
    # f32: each row within 1e-5 of its sum of |a| |v|
    T32 = T.astype(torch.float32)
    assert T32.dtype == torch.float32 and tspmv.is_structured(T32)
    v32 = v.astype(np.float32)
    got32 = (T32 @ torch.as_tensor(v32)).double().numpy()
    scale = max(1.0, float((abs(S) @ np.abs(v)).max(initial=0.0)))
    np.testing.assert_allclose(got32, S @ v32.astype(np.float64), rtol=0, atol=1e-5 * scale)


def test_ell_arrays_match_jax():
    """Packing: widths, pads (zero data at column 0) and the transpose's
    arrays equal the JAX package's; ``lanes_log2`` sizes the kernel's lane
    group to the power of two nearest the mean row length (log scale), from
    one lane to 32."""
    S = _ragged_rows(70, 45, seed=4)
    J = jspmv.ell_from_scipy(S, np.float64)
    T = tspmv.ell_from_scipy(S, torch.float64)
    for a, b in ((T.data, J.data), (T.cols, J.cols), (T.data_t, J.data_t),
                 (T.cols_t, J.cols_t)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert T.cols.dtype == torch.int32
    means = (0.5, 1.0, 1.4, 1.5, 2.0, 5.6, 5.7, 9.0, 11.3, 11.4, 32.0, 40.0)
    assert [tem.lanes_log2(torch.tensor([x])) for x in means] == [0, 0, 0, 1, 1, 2, 3, 3, 3, 4,
                                                                  5, 5]
    assert tem.lanes_log2(torch.zeros(0, dtype=torch.int32)) == 0
    assert tem.lanes_log2(torch.zeros(7, dtype=torch.int32)) == 0
    assert T.log2g == tem.lanes_log2(T.lens) and T.log2g_t == tem.lanes_log2(T.lens_t)


def test_bsr_arrays_match_jax():
    """Packing: blocks, block-columns (pads at block-column 0), the
    transpose's and the host diagonal equal the JAX package's."""
    S = _random_sparse(317, 290, 0.03, seed=12)
    S.sum_duplicates()
    J = jspmv.bsr_from_scipy(S, np.float64)
    T = tspmv.bsr_from_scipy(S, torch.float64)
    for a, b in ((T.blocks, J.blocks), (T.bcols, J.bcols), (T.blocks_t, J.blocks_t),
                 (T.bcols_t, J.bcols_t), (T.dvec, J.dvec)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert T.blocks.shape[2:] == (8, 128) and T.bcols.dtype == torch.int32


@pytest.mark.parametrize('m, n, K, seed', [(1000, 700, 3, 0), (333, 1000, 13, 1),
                                           (50, 60, 40, 2)])
def test_ell_plain_matches_jnp(m, n, K, seed):
    """``ell_matvec_plain`` against the jnp expression ``spmv.py:240`` on raw
    arrays, K = 3, 13 and 40 (over one warp) at m != n, with a non-finite
    v[0] reaching exactly the padded rows; the wrapper runs it on the CPU
    without a launch."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((m, K))
    cols = rng.integers(1, n, (m, K)).astype(np.int32)
    pad = rng.random((m, K)) < 0.2
    data[pad], cols[pad] = 0.0, 0
    v = rng.standard_normal(n)
    want = np.asarray(jnp.sum(jnp.asarray(data) * jnp.asarray(v)[cols], axis=1))
    before = tem.launches
    data_t, cols_t = torch.as_tensor(data), torch.as_tensor(cols)
    lens = tem.row_lens(data_t, cols_t)
    got = tem.ell_matvec(data_t, cols_t, torch.as_tensor(v), lens, tem.lanes_log2(lens))
    assert tem.launches == before
    _close(got, want)
    v[0] = np.inf
    got = tem.ell_matvec_plain(torch.as_tensor(data), torch.as_tensor(cols),
                               torch.as_tensor(v)).numpy()
    want = np.asarray(jnp.sum(jnp.asarray(data) * jnp.asarray(v)[cols], axis=1))
    np.testing.assert_array_equal(np.isnan(got), pad.any(1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize('m, n, seed', [(1000, 1000, 0), (64, 260, 1), (8, 128, 2)])
def test_bsr_plain_matches_jax(m, n, seed):
    """``bsr_matvec_plain`` against ``spmv._bsr_matvec`` on the arrays of a
    random pattern, m and n multiples of neither 8 nor 128 included; the
    wrapper runs it on the CPU without a launch."""
    S = _random_sparse(m, n, 0.01, seed=seed)
    blocks, bcols = jspmv._bsr_arrays(S, np.float64)
    v = np.random.default_rng(seed).standard_normal(n)
    want = np.asarray(jspmv._bsr_matvec(blocks, bcols, v, m, n))
    before = tbm.launches
    blocks_t, bcols_t = torch.as_tensor(blocks), torch.as_tensor(bcols)
    got = tbm.bsr_matvec(blocks_t, bcols_t, torch.as_tensor(v), m,
                         tbm.block_counts(blocks_t, bcols_t))
    assert tbm.launches == before
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), S @ v, rtol=TOL, atol=TOL)


def test_kernels_raise_on_meta_tensors():
    """A tensor on a device the kernels cannot run on raises; no fallback, no
    launch counted."""
    meta = dict(device='meta')
    before = (tem.launches, tbm.launches)
    with pytest.raises(ValueError, match='unsupported device'):
        tem.ell_matvec(torch.ones((4, 2), **meta), torch.zeros((4, 2), dtype=torch.int32, **meta),
                       torch.ones(4, **meta), torch.full((4,), 2, dtype=torch.int32, **meta), 1)
    with pytest.raises(ValueError, match='unsupported device'):
        tbm.bsr_matvec(torch.ones((1, 1, 8, 128), **meta),
                       torch.zeros((1, 1), dtype=torch.int32, **meta), torch.ones(128, **meta), 8,
                       torch.ones((1,), dtype=torch.int32, **meta))
    assert (tem.launches, tbm.launches) == before


# --- the counts past which every slot is padding ----------------------------

def _explicit_zeros():
    """45 x 300 with stored zeros (column 0 among them), empty rows and
    columns, and rows of one entry.  A zero is stored only where its row and
    its column hold a later non-zero and its (8, 128) block a non-zero, so
    no orientation ends a row or block-row with it: there the packing could
    not tell it from a pad."""
    rng = np.random.default_rng(21)
    m, n = 45, 300
    rows, cols = [], []
    for i in range(m):
        if i % 9 == 4:
            continue  # an empty row
        c = np.sort(rng.choice(np.arange(1, n), rng.integers(1, 9), replace=False))
        if i % 3 == 0:
            c = np.concatenate([[0], c])  # column 0 first, then later entries
        rows += [i] * c.size
        cols += c.tolist()
    rows, cols = np.array(rows), np.array(cols)
    data = rng.standard_normal(rows.size)
    later_in_row = np.r_[rows[1:] == rows[:-1], False]
    last_row_of_col = np.zeros(n, np.int64) - 1
    np.maximum.at(last_row_of_col, cols, rows)
    later_in_col = rows < last_row_of_col[cols]
    first_in_block = np.zeros(rows.size, bool)
    first_in_block[np.unique((rows // 8) * 3 + cols // 128, return_index=True)[1]] = True
    zero = later_in_row & later_in_col & ~first_in_block & (rng.random(rows.size) < 0.3)
    data[zero] = 0.0
    assert zero.sum() >= 10 and (zero & (cols == 0)).any()
    return sp.csr_matrix((data, (rows, cols)), shape=(m, n))


_COUNT_MATRICES = {
    'ragged_rows': lambda: _ragged_rows(130, 130, seed=5),
    'explicit_zeros': _explicit_zeros,
    'partial_blocks': lambda: _random_sparse(317, 290, 0.03, seed=12),
    'empty_block_row': _MATRICES['empty_block_row'],
}


def _stored_per_row(S):
    R = sp.csr_matrix(S)
    R.sum_duplicates()
    return np.diff(R.indptr)


def _stored_blocks_per_block_row(S, R=8, C=128):
    Coo = sp.coo_matrix(S)
    Coo.sum_duplicates()
    nbr, nbc = -(-S.shape[0] // R), -(-S.shape[1] // C)
    bid = np.unique((Coo.row // R).astype(np.int64) * nbc + Coo.col // C)
    return np.bincount(bid // nbc, minlength=nbr)


def _check_ell_counts(M, want, want_t):
    for lens, data, cols, w in ((M.lens, M.data, M.cols, want), (M.lens_t, M.data_t, M.cols_t,
                                                                   want_t)):
        assert lens.dtype == torch.int32 and lens.device == data.device
        np.testing.assert_array_equal(lens.numpy(), w)
        past = torch.arange(data.shape[1])[None, :] >= lens[:, None]
        assert not bool(data[past].any()) and not bool(cols[past].any())


def _check_bsr_counts(M, want, want_t):
    for nblk, blocks, bcols, w in ((M.nblk, M.blocks, M.bcols, want),
                                   (M.nblk_t, M.blocks_t, M.bcols_t, want_t)):
        assert nblk.dtype == torch.int32 and nblk.device == blocks.device
        np.testing.assert_array_equal(nblk.numpy(), w)
        past = torch.arange(bcols.shape[1])[None, :] >= nblk[:, None]
        assert not bool(blocks[past].any()) and not bool(bcols[past].any())


@pytest.mark.parametrize('name', list(_COUNT_MATRICES))
@pytest.mark.parametrize('fmt', ['ell', 'bsr'])
def test_counts_match_scipy(fmt, name):
    """``lens``/``lens_t`` (ELL) and ``nblk``/``nblk_t`` (BSR) equal scipy's
    stored entries per row and stored blocks per block-row, of the matrix
    and of its transpose, on ragged shapes (m and n multiples of neither 8
    nor 128), rows of pads only and stored zeros; every slot at or past a
    count is padding.  ``.T`` swaps the counts and ``astype`` keeps them,
    without computing them again."""
    S = _COUNT_MATRICES[name]()
    T = tspmv.from_scipy(S, torch.float64, fmt)
    if fmt == 'ell':
        check, want, want_t = _check_ell_counts, _stored_per_row(S), _stored_per_row(S.T)
    else:
        check = _check_bsr_counts
        want, want_t = _stored_blocks_per_block_row(S), _stored_blocks_per_block_row(S.T)
    check(T, want, want_t)
    check(T.T, want_t, want)
    check(T.astype(torch.float32), want, want_t)
    swapped = (dict(lens='lens_t', lens_t='lens', log2g='log2g_t', log2g_t='log2g')
               if fmt == 'ell' else dict(nblk='nblk_t', nblk_t='nblk'))
    T32 = T.astype(torch.float32)
    for k, k_t in swapped.items():
        assert getattr(T32, k) is getattr(T, k)
        assert getattr(T.T, k) is getattr(T, k_t)


@pytest.mark.parametrize('fmt', ['ell', 'bsr'])
def test_counts_from_jax_solver(fmt, monkeypatch):
    """The counts of the operators that ``from_jax_solver`` builds from the
    JAX solver's scaled ELL or BSR state equal the stored entries per row (or
    blocks per block-row) of those operators' matrices, both orientations."""
    monkeypatch.setenv('OSQP_TPU_SPARSE_FORMAT', fmt)
    P, q, A, l, u = _clustered_qp(seed=6, nsb=2, n_pairs=1)
    A = sp.vstack([A, _random_sparse(37, A.shape[1], 0.01, seed=4)]).tocsc()
    l, u = np.concatenate([l, -np.ones(37)]), np.concatenate([u, np.ones(37)])
    js = JaxSolver(sparse=True)
    js.setup(P, q, A, l, u, linsys_solver=1, verbose=False)
    data = from_jax_solver(_jax_state(js), 'cpu', torch.float64)[0]
    for J, T in ((js._data.P, data.P), (js._data.A, data.A)):
        S = sp.csr_matrix(np.asarray(J.todense()))  # the scaled QP holds no stored zeros
        if fmt == 'ell':
            _check_ell_counts(T, _stored_per_row(S), _stored_per_row(S.T))
        else:
            _check_bsr_counts(T, _stored_blocks_per_block_row(S),
                              _stored_blocks_per_block_row(S.T))


def _ell_family_rows(n, seed=0):
    """The row-length profile of chip_smoke.py::ell_family at a small n: P =
    S + S' + a diagonal with 4 random entries per row of S, A = I + R with 7
    per row."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(1, n, rows.size)) % n
    S = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    S = (S + S.T).tocsr()
    P = (S + sp.diags(2 * np.asarray(abs(S).sum(axis=1)).ravel() + 1)).tocsc()
    rows = np.repeat(np.arange(n), 7)
    R = sp.coo_matrix((rng.standard_normal(rows.size), (rows, rng.integers(0, n, rows.size))),
                      shape=(n, n))
    return P, (sp.eye(n, format='csc') + R.tocsc()).tocsc()


def test_lanes_rule_on_ell_family():
    """On the ELL family's profile (about 9 entries per row of P, 8 per row
    and per column of A, rows up to 2-3 times longer) the rule takes 8 lanes
    per row for P, A and A', the width the card ran fastest (PERF.md §6),
    though K, the longest row, asks 32 for P and A'."""
    P, A = _ell_family_rows(4096)
    Pm, Am = tspmv.ell_from_scipy(P, torch.float64), tspmv.ell_from_scipy(A, torch.float64)
    assert Pm.data.shape[1] > 16 and Am.data_t.shape[1] > 16
    assert 8.5 < float(Pm.lens.double().mean()) < 9.5
    assert (Pm.log2g, Am.log2g, Am.log2g_t, Am.T.log2g) == (3, 3, 3, 3)


def _ell_skip(data, cols, v, lens):
    """The kernel's rule in torch: sum only the slots below ``lens[r]``;
    NaN for a row with skipped pads when v[0] is not finite."""
    K = data.shape[1]
    keep = torch.arange(K)[None, :] < lens[:, None]
    y = torch.where(keep, data * v[cols], 0.0).sum(1)
    return torch.where((lens < K) & ~torch.isfinite(v[0]), float('nan'), y)


def _bsr_skip(blocks, bcols, v, out_rows, nblk):
    """The kernel's rule in torch: contract only the first ``nblk[b]`` blocks
    of block-row b; NaN in all its rows for a block-row with skipped padding
    when one of v[0 : min(128, n)] is not finite."""
    nbr, Kb, R, C = blocks.shape
    n = v.shape[0]
    vp = v.new_zeros((-(-n // C) * C,))
    vp[:n] = v
    vg = vp.view(-1, C)[bcols.reshape(-1).long()].view(nbr, Kb, C)
    keep = torch.arange(Kb)[None, :] < nblk[:, None]
    part = torch.einsum('bkrc,bkc->bkr', blocks, torch.where(keep[..., None], vg, 0.0))
    y = part.sum(1)
    bad = (nblk < Kb) & ~torch.isfinite(v[:C]).all()
    return torch.where(bad[:, None], float('nan'), y).reshape(-1)[:out_rows]


_V_CASES = {'finite': None, 'inf at 0': (0, np.inf), 'nan at 0': (0, np.nan),
            'nan at 5': (5, np.nan), 'nan at 200': (200, np.nan)}


def _agree(got, want, scale, tol):
    """NaN positions equal, infinities equal; elsewhere within ``tol`` of the
    row's scale."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    ok = np.isfinite(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol * np.maximum(scale[ok], 1.0))


@pytest.mark.parametrize('case', list(_V_CASES))
def test_ell_skip_rule_matches_jnp(case):
    """Summing only the slots below ``lens`` with the NaN rule gives what the
    jnp expression ``jnp.sum(data * v[cols], 1)`` gives on the CPU, on rows
    with trailing pads, interior pads (zero data at column 0 before the last
    entry) and rows of pads only: within 1e-12 of each row's sum of |a| |v|
    (the skipped pads add exact zeros; only the summation order differs),
    and NaN exactly where jnp has it, for finite v and a non-finite v[0] or
    v[5] or v[200]."""
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    m, n, K = 333, 257, 17
    want_lens = rng.integers(0, K + 1, m)
    want_lens[::11] = 0
    slot = np.arange(K)[None, :]
    keep = slot < want_lens[:, None]
    data = np.where(keep, rng.standard_normal((m, K)), 0.0)
    cols = np.where(keep, rng.integers(1, n, (m, K)), 0).astype(np.int32)
    inner = keep & (slot < want_lens[:, None] - 1) & (rng.random((m, K)) < 0.15)
    data[inner], cols[inner] = 0.0, 0
    v = rng.standard_normal(n)
    if _V_CASES[case]:
        i, val = _V_CASES[case]
        v[i] = val
    lens = tem.row_lens(torch.as_tensor(data), torch.as_tensor(cols))
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    got = _ell_skip(torch.as_tensor(data), torch.as_tensor(cols), torch.as_tensor(v), lens)
    want = np.asarray(jnp.sum(jnp.asarray(data) * jnp.asarray(v)[cols], axis=1))
    scale = np.sum(np.abs(data) * np.abs(np.nan_to_num(v, posinf=0.0))[cols], axis=1)
    _agree(got.numpy(), want, scale, 1e-12)
    assert case == 'finite' or np.isnan(want).any()


@pytest.mark.parametrize('case', list(_V_CASES))
def test_bsr_skip_rule_matches_jax(case, monkeypatch):
    """Contracting only the first ``nblk`` blocks of each block-row with the
    NaN rule gives what ``osqp_tpu``'s ``_bsr_matvec`` gives in its 'einsum'
    lowering (``OSQP_TPU_BSR_MV=einsum``; the 'onehot' lowering, picked
    automatically at this size, spreads a NaN through its one-hot product to
    every row), on block-rows holding 0 to Kb blocks, m and n multiples of
    neither 8 nor 128: within 1e-12 of each row's sum of |a| |v| (skipped
    padding adds exact zeros; only the summation order differs), and NaN
    exactly where the reference has it for finite v, a NaN or inf inside
    v[0:128] (which padding multiplies) and a NaN at v[200] (block-column 1
    only)."""
    monkeypatch.setenv('OSQP_TPU_BSR_MV', 'einsum')
    rng = np.random.default_rng(32)
    m, n = 395, 700
    rows, cols = [], []
    for b in range(-(-m // 8)):  # block-row b stores b % 6 blocks
        for bc in rng.choice(-(-n // 128), b % 6, replace=False):
            r = rng.integers(8 * b, min(8 * b + 8, m), 5)
            c = rng.integers(128 * bc, min(128 * bc + 128, n), 5)
            rows += r.tolist()
            cols += c.tolist()
    S = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(m, n))
    blocks, bcols = jspmv._bsr_arrays(S, np.float64)
    v = rng.standard_normal(n)
    if _V_CASES[case]:
        i, val = _V_CASES[case]
        v[i] = val
    nblk = tbm.block_counts(torch.as_tensor(blocks), torch.as_tensor(bcols))
    np.testing.assert_array_equal(nblk.numpy(), _stored_blocks_per_block_row(S))
    assert nblk.min() == 0 and nblk.max() == bcols.shape[1] == 5
    got = _bsr_skip(torch.as_tensor(blocks), torch.as_tensor(bcols), torch.as_tensor(v), m, nblk)
    want = np.asarray(jspmv._bsr_matvec(blocks, bcols, v, m, n))
    scale = np.abs(S) @ np.abs(np.nan_to_num(v, nan=0.0, posinf=0.0))
    _agree(got.numpy(), want, scale, 1e-12)
    if case != 'finite':
        assert np.isnan(want).any() and not np.isnan(want).all()


# --- the format ladder ------------------------------------------------------

def _ragged_full_row():
    S = _random_sparse(400, 400, 0.004, seed=8).tolil()
    S[0, :] = 1.0
    return S.tocsc()


_FAMILIES = {
    'banded_4': lambda: _random_banded(40, 56, (-3, 0, 2, 7)),
    'random_40x56': lambda: _random_sparse(40, 56, 0.08, seed=1),
    'random_56x40': lambda: _random_sparse(56, 40, 0.12, seed=2),
    'banded_5': lambda: _random_banded(33, 33, (-5, -1, 0, 1, 5)),
    'tridiagonal': lambda: _random_banded(200, 200, (-1, 0, 1)),
    'clustered': lambda: _clustered_sparse(64, 8, frac=0.01, seed=9),
    'packed': lambda: _clustered_sparse(16, 8, frac=0.3, seed=7),
    'even_rows': lambda: _random_sparse(200, 200, 0.05, seed=7),
    'ragged': _ragged_full_row,
    'clustered_qp_P': lambda: _clustered_qp(seed=5, nsb=4, n_pairs=2)[0],
}


@pytest.mark.parametrize('budget', [None, 100_000, 0])
def test_choose_format_matches_jax(budget, monkeypatch):
    """The ladder picks what the JAX package picks on every family, at the
    default dense budget and with it overridden (the JAX package's
    ``OSQP_TPU_DENSE_SPMV_BYTES``, an argument here); with no budget the
    unstructured families fall to ELL or BCOO."""
    monkeypatch.delenv('OSQP_TPU_SPARSE_FORMAT', raising=False)
    kw = {}
    if budget is None:
        monkeypatch.delenv('OSQP_TPU_DENSE_SPMV_BYTES', raising=False)
    else:
        monkeypatch.setenv('OSQP_TPU_DENSE_SPMV_BYTES', str(budget))
        kw = dict(dense_budget_bytes=budget)
    picks = {}
    for name, build in _FAMILIES.items():
        S = build()
        picks[name] = tspmv.choose_format(S, **kw)
        assert picks[name] == jspmv.choose_format(S), name
    if budget == 0:
        assert picks['ragged'] == 'bcoo' and picks['even_rows'] == 'ell'
        assert picks['clustered'] == 'bsr'


# --- the single-QP path with each format forced ----------------------------

_PROBLEMS = {
    'mpc_like': lambda: _mpc_like_qp(seed=4),
    'clustered': lambda: _clustered_qp(seed=5, nsb=2, n_pairs=1),
}


def _match(rt, rj):
    assert rt.info.status == rj.info.status
    assert rt.info.iter == rj.info.iter
    assert rt.info.status_polish == rj.info.status_polish
    for k in ('x', 'y'):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=0, atol=ATOL)


@pytest.mark.parametrize('prob', list(_PROBLEMS))
@pytest.mark.parametrize('fmt', ['ell', 'bsr', 'bcoo'])
def test_osqp_forced_format_matches_jax(fmt, prob, monkeypatch):
    """``OSQP(device='cpu', sparse=True, sparse_format=fmt)`` against the JAX
    package with ``OSQP_TPU_SPARSE_FORMAT=fmt``: a cold solve with the
    polish, ``update(q, l, u)``, ``update(Px, Ax)``, each followed by a
    solve; statuses, iterations and status_polish equal, x and y to 1e-8.
    The pinned format survives the updates."""
    monkeypatch.setenv('OSQP_TPU_SPARSE_FORMAT', fmt)
    P, q, A, l, u = _PROBLEMS[prob]()
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, verbose=False, polishing=True)
    j = osqp_tpu.OSQP(algebra='jax', sparse=True)
    j.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    t = osqp_tpu_torch.OSQP(device='cpu', sparse=True, sparse_format=fmt)
    t.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    cls = {'ell': tspmv.EllMatrix, 'bsr': tspmv.BsrMatrix, 'bcoo': tspmv.CooMatrix}[fmt]
    assert isinstance(t._solver._data.P, cls) and isinstance(t._solver._data.A, cls)
    r = t.solve(raise_error=True)
    _match(r, j.solve(raise_error=True))
    assert r.info.status_polish == 1 and t._solver.polish_cg_iters > 0

    rng = np.random.default_rng(7)
    q2 = q + 0.25 * rng.standard_normal(q.shape)
    l2, u2 = l + 0.1, u - 0.1
    l2[:2] = u2[:2] = 0.5 * (l2[:2] + u2[:2])  # two equality rows: retyped
    for s in (j, t):
        s.update(q=q2, l=l2, u=u2)
    _match(t.solve(raise_error=True), j.solve(raise_error=True))

    P_triu = sp.triu(P, format='csc')
    for s in (j, t):
        s.update(Px=1.1 * P_triu.data, Ax=0.9 * A.data)
    _match(t.solve(raise_error=False), j.solve(raise_error=False))
    assert isinstance(t._solver._data.P, cls) and isinstance(t._solver._data.A, cls)


def test_osqp_auto_formats_match_jax(monkeypatch):
    """With no format forced, the clustered QP (nsb = 32) picks BSR for both
    operators in both packages, and the ELL and BCOO families pick ELL and
    BCOO with no dense budget (``dense_budget_bytes=0``); setup only."""
    monkeypatch.delenv('OSQP_TPU_SPARSE_FORMAT', raising=False)
    cases = [(_clustered_qp(seed=5), None, ('bsr', 'bsr')),
             (_mpc_like_qp(seed=4)[:2] + (_random_sparse(28, 28, 0.1, seed=3)
                                          + sp.eye(28, format='csc'),) + _mpc_like_qp()[3:],
              0, ('dia', 'ell')),
             ((sp.eye(64, format='csc'), np.ones(64), _ragged_full_row()[:, :64].tocsc(),
               -np.ones(400), np.ones(400)), 0, ('dia', 'bcoo'))]
    for (P, q, A, l, u), budget, want in cases:
        if budget is None:
            monkeypatch.delenv('OSQP_TPU_DENSE_SPMV_BYTES', raising=False)
            t = osqp_tpu_torch.OSQP(device='cpu', sparse=True)
        else:
            monkeypatch.setenv('OSQP_TPU_DENSE_SPMV_BYTES', str(budget))
            t = osqp_tpu_torch.OSQP(device='cpu', sparse=True, dense_budget_bytes=budget)
        t.setup(P=P, q=q, A=A, l=l, u=u, verbose=False)
        js = JaxSolver(sparse=True)
        js.setup(P, q, A, l, u, verbose=False)
        got = (t._solver._sparse_fmt_P, t._solver._sparse_fmt_A)
        assert got == (js._sparse_fmt_P, js._sparse_fmt_A) == want


# --- the loop from the JAX solver's state ------------------------------------

def _np_op(M):
    if isinstance(M, jspmv.EllMatrix):
        return dict(data=np.asarray(M.data), cols=np.asarray(M.cols),
                    data_t=np.asarray(M.data_t), cols_t=np.asarray(M.cols_t), shape=M.shape)
    if isinstance(M, jspmv.BsrMatrix):
        return dict(blocks=np.asarray(M.blocks), bcols=np.asarray(M.bcols),
                    blocks_t=np.asarray(M.blocks_t), bcols_t=np.asarray(M.bcols_t),
                    dvec=np.asarray(M.dvec), shape=M.shape)
    assert isinstance(M, jsparse.BCOO)
    return dict(data=np.asarray(M.data), indices=np.asarray(M.indices), shape=M.shape)


def _jax_state(js):
    d, r = js._data, js._rho
    return dict(
        P=_np_op(d.P), A=_np_op(d.A), q=np.asarray(d.q), l=np.asarray(d.l), u=np.asarray(d.u),
        scal=tuple(np.asarray(v) for v in js._scal),
        rho=(np.asarray(r.rho), np.asarray(r.rho_vec), np.asarray(r.rho_inv_vec),
             np.asarray(r.constr_type)),
        factor=(np.asarray(js._factor.L), np.asarray(js._factor.diag)),
        iterates=tuple(np.asarray(v) for v in js._iterates),
    )


@pytest.mark.parametrize('fmt', ['ell', 'bsr', 'bcoo'])
def test_solve_scaled_from_jax_state(fmt, monkeypatch):
    """``from_jax_solver`` carries the JAX solver's scaled ELL, BSR or BCOO
    operators into the port; from that state ``solve_scaled`` gives the same
    status, iterations, rho updates and CG steps, x and y to 1e-8, and the
    preconditioner's diagonal agrees to 1e-12."""
    monkeypatch.setenv('OSQP_TPU_SPARSE_FORMAT', fmt)
    P, q, A, l, u = _clustered_qp(seed=6, nsb=4, n_pairs=2)
    settings = dict(linsys_solver=1, rho=5.0, eps_abs=1e-7, eps_rel=1e-7, verbose=False)
    js = JaxSolver(sparse=True)
    js.setup(P, q, A, l, u, **settings)
    data, scal, rho, factor, it = from_jax_solver(_jax_state(js), 'cpu', torch.float64)
    assert tspmv.is_structured(data.P) and tspmv.is_structured(data.A)
    sigma = np.float64(1e-6)
    _close(tcore.build_M_diag(data.P, data.A, sigma, rho.rho_vec),
           jcore.build_M_diag(js._data.P, js._data.A, sigma, js._rho.rho_vec))
    want = jcore.solve_scaled(js._data, js._scal, js._core_settings(), js._rho, js._factor,
                              js._iterates, indirect=True)
    stg = core_settings(OracleSettings(**settings), torch.float64)
    got = tcore.solve_scaled(data, scal, stg, rho, factor, it, indirect=True)
    assert got.status == int(want.status)
    assert got.iters == int(want.iters)
    assert got.rho_updates == int(want.rho_updates)
    assert got.cg_iters == int(want.cg_iters) > 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0, atol=ATOL)
