"""The ``torch.library`` operators and exported programs on the card.

These tests need an NVIDIA GPU and skip elsewhere.  They import neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_codegen_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu_torch
from osqp_tpu_torch.codegen.driver import export_aot
from osqp_tpu_torch.ops import bsr_matvec as bm
from osqp_tpu_torch.ops import dia_matvec as dm
from osqp_tpu_torch.ops import ell_matvec as em
from osqp_tpu_torch.ops import spmv
from osqp_tpu_torch.ops.library import LibraryOperator


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _banded(n, seed=0):
    """examples/huge_banded_qp.py's family."""
    rng = np.random.default_rng(seed)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.9), np.full(n - 1, -0.9)],
                 [0, 1, -1]).tocsc()
    A = (sp.eye(n) + sp.diags([np.full(n - 2, 0.5)], [-2], shape=(n, n))).tocsc()
    return P, rng.standard_normal(n), A, -1.5 * np.ones(n), 1.5 * np.ones(n)


def _even_rows(n, k=6, seed=0):
    """A random graph QP with about k entries a row (ELL's pattern)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    G = sp.coo_matrix((rng.uniform(-1, 1, n * k), (rows, cols)), shape=(n, n)).tocsr()
    P = (G.T @ G + sp.eye(n)).tocsc()
    A = (G + 2 * sp.eye(n)).tocsc()
    q = rng.standard_normal(n)
    return P, q, A, -np.ones(n), np.ones(n)


_MODULES = {'dia': dm, 'ell': em, 'bsr': bm}


@pytest.mark.cuda
@pytest.mark.parametrize('fmt', ['dia', 'ell', 'bsr', 'bcoo'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_operator_equals_wrapper(fmt, dtype):
    """Each operator's CUDA implementation gives its wrapper's output bit for
    bit (the CSR one ``torch.sparse``'s product), for ``@``, ``.T @`` and
    ``gram_diag``, and adds one to the wrapper's launch count per call."""
    _needs_cuda()
    n = 5000
    S = (_banded(n)[2] if fmt == 'dia' else _even_rows(n)[2]).tocsc()
    if fmt == 'bsr':
        S = (S + sp.random(n, n, density=0.001, random_state=1)).tocsc()
    M = spmv.from_scipy(S, dtype, fmt, 'cuda')
    L = LibraryOperator.from_spmv(M)
    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device='cuda')
    w = torch.as_tensor(rng.random(n), dtype=dtype, device='cuda')
    mod = _MODULES.get(fmt)
    for got_fn, want_fn in ((lambda: L @ v, lambda: M @ v), (lambda: L.T @ v, lambda: M.T @ v),
                            (lambda: L.gram_diag(w), lambda: M.gram_diag(w))):
        want = want_fn()
        before = mod.launches if mod else 0
        got = got_fn()
        torch.cuda.synchronize()
        if mod:
            assert mod.launches == before + 1
        assert torch.equal(got, want)
    torch.testing.assert_close(L.diag(), M.diag(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('fmt', ['dia', 'ell'])
def test_exported_solve_matches_live(fmt):
    """An exported DIA and an exported ELL problem on the card (float64):
    the live solve's status, iterations and CG steps (the live solve after
    ``update`` with the same q, l, u), x to 1e-12, and the kernel launched
    inside the exported call."""
    _needs_cuda()
    P, q, A, l, u = _banded(20000) if fmt == 'dia' else _even_rows(20000)
    o = osqp_tpu_torch.OSQP(device='cuda', sparse=True, sparse_format=fmt)
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=1e-5, eps_rel=1e-5, verbose=False)
    compiled = export_aot(o)
    mod = _MODULES[fmt]
    before = mod.launches
    got = compiled.solve(q, l, u)
    torch.cuda.synchronize()
    assert mod.launches > before
    o.update(q=q, l=l, u=u)
    live = o.solve(raise_error=False)
    assert live.info.status == 'solved'
    assert (int(got.status), int(got.iters), int(got.cg_iters)) == \
        (live.info.status_val, live.info.iter, live.info.cg_iters)
    np.testing.assert_allclose(got.x.cpu().numpy(), live.x, rtol=0, atol=1e-12)
