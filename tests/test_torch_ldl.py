"""The port's sparse LDL' (osqp_tpu_torch.ops.ldl) against the JAX package's
native factor (osqp_tpu.native.ldl.LDLFactor) on the CPU, on the patterns
of tests/test_native_ldl.py: the same ordering choice and pattern of L, the
same inertia, solves within 1e-10, numeric-only refactorizations in the
caller's data order, RCM's fill cut on a banded KKT matrix, the loud
failures, and the plain factorization's exact zeros outside the symbolic
pattern.  On the CPU the factor runs the plain versions of K5 and K6."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu.native import ldl as native_ldl
from osqp_tpu_torch.ops import ldl as tldl

pytestmark = pytest.mark.skipif(not native_ldl.available(),
                                reason='native LDL library unavailable')


def _kkt(n, m, seed, density=0.3):
    rng = np.random.default_rng(seed)
    L = sp.random(n, n, density=density, random_state=rng)
    P = (L @ L.T + 0.1 * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=density, random_state=rng).tocsc()
    rho_inv = rng.random(m) + 0.1
    K = sp.bmat([[P + 1e-6 * sp.eye(n), A.T], [A, -sp.diags(rho_inv)]], format='csc')
    K_triu = sp.triu(K, format='csc')
    K_triu.sort_indices()
    return K, K_triu, P, A, rho_inv


def _banded_kkt():
    n = 300
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0)],
                 [0, -1, 1]).tocsc()
    rng = np.random.default_rng(2)
    A = (sp.random(2 * n, n, density=0.005, random_state=rng) + sp.eye(2 * n, n)).tocsc()
    K = sp.bmat([[P + 1e-6 * sp.eye(n), A.T], [A, -sp.diags(np.full(2 * n, 10.0))]],
                format='csc')
    K_triu = sp.triu(K, format='csc')
    K_triu.sort_indices()
    return K, K_triu


def _arrow(n=40):
    d = sp.diags(np.full(n, 4.0)).tolil()
    d[:, -1] = 1.0
    d[-1, -1] = 4.0 * n
    K_triu = sp.triu(d.tocsc(), format='csc')
    K_triu.sort_indices()
    return K_triu


def _native(K_triu, ordering, monkeypatch):
    monkeypatch.setenv('OSQP_TPU_LDL_ORDERING', ordering)
    return native_ldl.LDLFactor(K_triu)


def _patterns():
    out = {f'random-{s}': _kkt(int(n), int(m), s)[1]
           for s, (n, m) in enumerate([(2, 1), (13, 9), (30, 40), (49, 3), (40, 60)])}
    out['banded'] = _banded_kkt()[1]
    out['arrow'] = _arrow()
    return out


PATTERNS = _patterns()
ORDERINGS = ['rcm', 'natural']


def _unsorted(K_triu, seed=5):
    """K_triu with its indices scrambled within each column."""
    rng = np.random.default_rng(seed)
    indptr, indices, data = K_triu.indptr.copy(), K_triu.indices.copy(), K_triu.data.copy()
    for j in range(K_triu.shape[1]):
        s, e = indptr[j], indptr[j + 1]
        p = rng.permutation(e - s)
        indices[s:e], data[s:e] = indices[s:e][p], data[s:e][p]
    K = sp.csc_matrix((data, indices, indptr), shape=K_triu.shape)
    assert not K.has_sorted_indices
    return K


@pytest.mark.parametrize('ordering', ORDERINGS)
@pytest.mark.parametrize('name', list(PATTERNS))
def test_same_ordering_and_pattern(name, ordering, monkeypatch):
    """The same permutation (RCM kept only where it strictly cuts fill) and
    the same Lp; the CSC pattern of L equals the native factor's."""
    K_triu = PATTERNS[name]
    ref = _native(K_triu, ordering, monkeypatch)
    got = tldl.LDLFactor(K_triu, device='cpu', ordering=ordering)
    if ref._perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm, ref._perm)
    np.testing.assert_array_equal(got.Lp, ref._Lp)
    np.testing.assert_array_equal(got.sym.Li, ref._Li[:ref._Lp[-1]])
    # the CSR pattern is the CSC pattern's transpose, each row sorted
    n = got.n
    L = sp.csc_matrix((np.ones(got.sym.nnz_L), got.sym.Li, got.sym.Lp), shape=(n, n)).tocsr()
    L.sort_indices()
    np.testing.assert_array_equal(got.sym.Rp, L.indptr)
    np.testing.assert_array_equal(got.sym.Rj, L.indices)
    cols = np.repeat(np.arange(n), np.diff(got.sym.Lp))
    rows_of_csr = np.repeat(np.arange(n), np.diff(got.sym.Rp))
    np.testing.assert_array_equal(got.sym.Rj[got.sym.csc2csr], cols)
    np.testing.assert_array_equal(rows_of_csr[got.sym.csc2csr], got.sym.Li)
    assert got.sym.depth <= n


@pytest.mark.parametrize('ordering', ORDERINGS)
@pytest.mark.parametrize('name', list(PATTERNS))
def test_inertia_and_solve(name, ordering, monkeypatch):
    """n_positive equal to the native factor's; solves within 1e-10 of
    the native solve (relative to the solution's max-norm)."""
    K_triu = PATTERNS[name]
    ref = _native(K_triu, ordering, monkeypatch)
    got = tldl.LDLFactor(K_triu, device='cpu', ordering=ordering)
    assert got.n_positive == ref.n_positive
    b = np.random.default_rng(1).standard_normal(K_triu.shape[0])
    want = ref.solve(b)
    x = got.solve(torch.tensor(b)).numpy()
    assert np.abs(x - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize('ordering', ORDERINGS)
@pytest.mark.parametrize('order', ['sorted', 'unsorted', 'permuted'])
def test_update_values_caller_order(order, ordering, monkeypatch):
    """A numeric-only refactorization takes its values in the caller's
    triu-CSC data order: sorted indices, indices scrambled within columns,
    and (at 40 x 60, where RCM is kept) through the permutation."""
    n, m = 40, 60
    K, K_triu, P, A, rho_inv = _kkt(n, m, seed=7)
    K2 = sp.bmat([[2.5 * P + 1e-6 * sp.eye(n), A.T], [A, -sp.diags(3.0 * rho_inv)]],
                 format='csc')
    K2_triu = sp.triu(K2, format='csc')
    K2_triu.sort_indices()
    if order == 'unsorted':
        K_triu, K2_triu = _unsorted(K_triu), _unsorted(K2_triu)
    ref = _native(K_triu, ordering, monkeypatch)
    got = tldl.LDLFactor(K_triu, device='cpu', ordering=ordering)
    if order == 'permuted':
        assert (got.perm is not None) == (ordering == 'rcm')
    ref.update_values(K2_triu.data)
    got.update_values(K2_triu.data)
    b = np.random.default_rng(1).standard_normal(n + m)
    want = ref.solve(b)
    x = got.solve(torch.tensor(b)).numpy()
    assert np.abs(x - want).max() <= 1e-10 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(K2 @ x, b, atol=1e-8)


@pytest.mark.parametrize('case', ['banded_rcm_cut', 'arrow_kept_natural'])
def test_ordering_choice_fill(case, monkeypatch):
    """RCM cuts the banded KKT matrix's fill below 0.6x the natural
    ordering's; on the arrow pattern the natural ordering is kept."""
    if case == 'banded_rcm_cut':
        K_triu = _banded_kkt()[1]
        nat = tldl.LDLFactor(K_triu, device='cpu', ordering='natural').sym.nnz_L
        rcm = tldl.LDLFactor(K_triu, device='cpu', ordering='rcm')
        assert rcm.perm is not None and rcm.sym.nnz_L < 0.6 * nat, (rcm.sym.nnz_L, nat)
    else:
        K_triu = _arrow()
        got = tldl.LDLFactor(K_triu, device='cpu', ordering='rcm')
        nat = tldl.LDLFactor(K_triu, device='cpu', ordering='natural')
        assert got.sym.nnz_L <= nat.sym.nnz_L
        np.testing.assert_array_equal(got.Lp, _native(K_triu, 'rcm', monkeypatch)._Lp)


@pytest.mark.parametrize('ordering', ORDERINGS)
@pytest.mark.parametrize('case', ['zero_pivot', 'both_triangles', 'lower_entry',
                                  'missing_diagonal'])
def test_loud_failures(case, ordering, monkeypatch):
    """A zero pivot raises ZeroDivisionError (the native factor too); both
    triangles stored, a lower-triangular entry or a missing diagonal raise
    ValueError, on both ordering paths."""
    if case == 'zero_pivot':
        # [[0, 1], [1, 0]] with its zero diagonal stored
        K_triu = sp.csc_matrix((np.array([0.0, 1.0, 0.0]), np.array([0, 0, 1]),
                                np.array([0, 1, 3])), shape=(2, 2))
        with pytest.raises(ZeroDivisionError):
            _native(K_triu, ordering, monkeypatch)
        with pytest.raises(ZeroDivisionError):
            tldl.LDLFactor(K_triu, device='cpu', ordering=ordering)
        return
    if case == 'both_triangles':
        bad = sp.csc_matrix(_kkt(10, 8, seed=3)[0])
    elif case == 'lower_entry':
        bad = sp.csc_matrix(np.array([[1.0, 0.0], [1.0, 1.0]]))
    else:
        bad = sp.csc_matrix(np.array([[1.0, 1.0], [0.0, 0.0]]))
        bad.eliminate_zeros()
    with pytest.raises(ValueError):
        _native(bad, ordering, monkeypatch)
    with pytest.raises(ValueError):
        tldl.LDLFactor(bad, device='cpu', ordering=ordering)


@pytest.mark.parametrize('name', list(PATTERNS))
def test_plain_factor_zero_outside_pattern(name, monkeypatch):
    """The plain factorization's dense L is exactly zero outside the
    symbolic pattern, its values there equal the native factor's to 1e-12
    of each column's max-norm, and D matches."""
    K_triu = PATTERNS[name]
    got = tldl.LDLFactor(K_triu, device='cpu', ordering='natural')
    n = got.n
    L = got._L_dense.numpy()
    mask = np.eye(n, dtype=bool)
    mask[got.sym.Li, np.repeat(np.arange(n), np.diff(got.sym.Lp))] = True
    assert np.all(L[~mask] == 0.0)
    ref = _native(K_triu, 'natural', monkeypatch)
    nnz = got.sym.nnz_L
    Lx_ref, Lx = ref._Lx[:nnz], got.Lx.numpy()[:nnz]
    cols = np.repeat(np.arange(n), np.diff(got.sym.Lp))
    scale = np.zeros(n)
    np.maximum.at(scale, cols, np.abs(Lx_ref))
    assert np.all(np.abs(Lx - Lx_ref) <= 1e-12 * np.maximum(scale[cols], 1.0))
    np.testing.assert_allclose(got.D.numpy(), ref._D, rtol=1e-12)


def test_cpu_limit_raises():
    """The plain versions densify: a factor past CPU_MAX_N raises on the
    CPU before any numeric work."""
    n = tldl.CPU_MAX_N + 1
    K_triu = sp.identity(n, format='csc')
    with pytest.raises(ValueError, match='CPU limit'):
        tldl.LDLFactor(K_triu, device='cpu')
