"""The port's DIA operators (osqp_tpu_torch.ops.dia_matvec and ops.spmv)
against the JAX package's (osqp_tpu.ops.spmv) on the CPU.

The TPU kernel (tools/proto_dia_pallas.py) has no interpret mode, so its
function is held through ``spmv._dia_matvec``, the plain jnp matvec it
prototypes.  On the CPU the port's wrapper runs its plain version, which sums
in the same offset order: values agree to 1e-13 relative.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from osqp_tpu.ops import spmv as jspmv

from osqp_tpu_torch.ops import dia_matvec as tdm
from osqp_tpu_torch.ops import spmv as tspmv

RTOL = 1e-13


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
    """A random ``frac`` of the (R, C) blocks of an (mb*R, nb*C) matrix are
    dense."""
    rng = np.random.default_rng(seed)
    picks = rng.random((mb, nb)) < frac
    br, bc = np.nonzero(picks)
    if br.size == 0:
        br, bc = np.array([0]), np.array([0])
    rows = (br[:, None] * R + np.arange(R)[None, :]).repeat(C, axis=1).ravel()
    cols = np.tile((bc[:, None] * C + np.arange(C)[None, :]), (1, R)).ravel()
    data = rng.standard_normal(rows.size)
    return sp.coo_matrix((data, (rows, cols)), shape=(mb * R, nb * C)).tocsc()


def _many_offsets():
    return tuple(sorted(set(np.random.default_rng(21).integers(-90, 90, 120).tolist())))


_MATRICES = {
    'ragged_m_gt_n': lambda: _random_banded(70, 45, (-30, -3, 0, 2, 7, 40)),
    'ragged_m_lt_n': lambda: _random_banded(33, 90, (-20, -1, 0, 5, 60, 89)),
    'large_offsets': lambda: _random_banded(300, 300, (-299, -150, 0, 150, 299)),
    'over_64_bands': lambda: _random_banded(128, 160, _many_offsets(), seed=22),
    'empty': lambda: sp.csc_matrix((17, 23)),
}


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize('name', list(_MATRICES))
def test_dia_matrix_matches_jax(name):
    """``@``, ``.T @``, ``diag`` and ``gram_diag`` of the port's DiaMatrix
    against the JAX package's, float64, to 1e-13 relative."""
    S = _MATRICES[name]()
    m, n = S.shape
    J = jspmv.dia_from_scipy(S, np.float64)
    T = tspmv.dia_from_scipy(S, torch.float64)
    assert T.offsets == J.offsets and T.offsets_t == J.offsets_t
    if name == 'over_64_bands':
        assert len(T.offsets) > jspmv._DIA_UNROLL_MAX  # the JAX package's scan branch
    rng = np.random.default_rng(3)
    v, w, rho = rng.standard_normal(n), rng.standard_normal(m), rng.uniform(0.5, 2.0, m)
    _close(T @ torch.as_tensor(v), J @ v)
    _close(T.T @ torch.as_tensor(w), J.T @ w)
    _close(T.gram_diag(torch.as_tensor(rho)), J.gram_diag(rho))
    if m == n:
        _close(T.diag(), J.diag())


def test_plain_matches_jax_dia_matvec():
    """``dia_matvec_plain`` against ``spmv._dia_matvec`` on raw bands, with
    offsets given as a tuple and as an int32 tensor, and an empty band set."""
    rng = np.random.default_rng(5)
    m_out, n_in = 50, 41
    offs = (-49, -7, 0, 3, 40)
    bands = rng.standard_normal((len(offs), m_out))
    v = rng.standard_normal(n_in)
    want = np.asarray(jspmv._dia_matvec(bands, offs, v, m_out))
    tb, tv = torch.as_tensor(bands), torch.as_tensor(v)
    _close(tdm.dia_matvec_plain(tb, offs, tv), want)
    _close(tdm.dia_matvec(tb, torch.tensor(offs, dtype=torch.int32), tv), want)
    empty = tdm.dia_matvec(torch.zeros((0, 9), dtype=torch.float64),
                           torch.zeros((0,), dtype=torch.int32), tv)
    assert empty.shape == (9,) and not bool(empty.any())


def test_no_launch_on_cpu_and_meta_raises():
    """CPU tensors run the plain version (no launch is counted); a tensor on
    a device the kernel cannot run on raises and does not fall back."""
    before = tdm.launches
    t = torch.ones(4)
    tdm.dia_matvec(torch.ones((1, 4)), torch.zeros(1, dtype=torch.int32), t)
    assert tdm.launches == before
    meta = torch.ones(4, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tdm.dia_matvec(torch.ones((1, 4), device='meta'),
                       torch.zeros(1, dtype=torch.int32, device='meta'), meta)
    assert tdm.launches == before


def test_choose_format_matches_jax(monkeypatch):
    """The format ladder picks what the JAX package picks for the banded,
    clustered and random patterns of tests/test_spmv.py, with the dense
    budget and the forced format as arguments instead of environment
    variables."""
    monkeypatch.delenv('OSQP_TPU_SPARSE_FORMAT', raising=False)
    monkeypatch.delenv('OSQP_TPU_DENSE_SPMV_BYTES', raising=False)
    ragged = _random_sparse(400, 400, 0.004, seed=8).tolil()
    ragged[0, :] = 1.0
    patterns = {
        'banded': _random_banded(200, 200, (-1, 0, 1)),
        'clustered': _clustered_sparse(64, 8, frac=0.01, seed=9),
        'packed': _clustered_sparse(16, 8, frac=0.3, seed=7),
        'even_rows': _random_sparse(200, 200, 0.05, seed=7),
        'ragged': ragged.tocsc(),
        'empty': sp.csc_matrix((10, 10)),
    }
    want = {'banded': 'dia', 'clustered': 'bsr', 'packed': 'dense', 'even_rows': 'dense',
            'ragged': 'dense', 'empty': 'dia'}
    for name, S in patterns.items():
        assert tspmv.choose_format(S) == jspmv.choose_format(S) == want[name], name
    monkeypatch.setenv('OSQP_TPU_DENSE_SPMV_BYTES', '100000')
    for name, S in patterns.items():
        assert tspmv.choose_format(S, dense_budget_bytes=100000) == jspmv.choose_format(S), name
    monkeypatch.delenv('OSQP_TPU_DENSE_SPMV_BYTES')
    monkeypatch.setenv('OSQP_TPU_SPARSE_FORMAT', 'ell')
    assert tspmv.choose_format(patterns['banded'], 'ell') == jspmv.choose_format(
        patterns['banded']) == 'ell'
    with pytest.raises(ValueError):
        tspmv.choose_format(patterns['banded'], 'csr')


@pytest.mark.parametrize('fmt', ['ell', 'bsr', 'bcoo'])
def test_unported_formats_raise(fmt):
    """The ELL, BSR and BCOO formats, which raised before they were ported,
    now build operators that reproduce the matrix; an unknown format still
    raises."""
    S = _random_banded(20, 20, (-1, 0, 1))
    M = tspmv.from_scipy(S, torch.float64, fmt)
    assert tspmv.is_structured(M)
    np.testing.assert_array_equal(M.todense().numpy(), S.toarray())
    with pytest.raises(ValueError, match='unknown sparse format'):
        tspmv.from_scipy(S, torch.float64, 'csr')


def test_dense_format_is_a_dense_tensor():
    S = _random_sparse(30, 20, 0.2, seed=1)
    D = tspmv.from_scipy(S, torch.float64, 'dense')
    assert isinstance(D, torch.Tensor) and D.shape == (30, 20)
    np.testing.assert_array_equal(D.numpy(), S.toarray())
