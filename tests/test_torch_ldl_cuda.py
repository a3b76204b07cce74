"""K5 (the LDL' factorization) and K6 (its triangular solves) against their
plain PyTorch versions on the card, and the 'ldl' algebra on the card
against the CPU.

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_ldl_cuda.py

Tolerances: K5 and the plain factorization sum in other orders (a gather
along L's rows against a dense blocked product), so L and D agree to 1e-10
of each column's max-norm; K6 and the plain solve on the same L to 1e-12 of
the right-hand side's max-norm.  Two runs of either kernel agree bit for
bit (no atomic accumulation).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu_torch
from osqp_tpu_torch.ops import ldl as tldl

from chip_smoke import banded_qp, kkt_triu, portfolio_family


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; K5 and K6 have no CPU mode')


def _ragged(seed=0, n=300, m=200, density=0.02):
    rng = np.random.default_rng(seed)
    L = sp.random(n, n, density=density, random_state=rng)
    P = (L @ L.T + 0.1 * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=density, random_state=rng).tocsc()
    return kkt_triu(P, A)


def _chain():
    P, _, A, _, _ = banded_qp(1024)
    return kkt_triu(P, A)


def _dense_block():
    P, _, A, _, _ = portfolio_family(400, 10)
    return kkt_triu(P, A)


PATTERNS = {'ragged': _ragged, 'chain': _chain, 'dense_block': _dense_block}


def _col_err(got, want, fac):
    """max |got - want| over each column of L, over that column's
    max-norm (at least 1)."""
    cols = torch.repeat_interleave(torch.arange(fac.n, device=got.device),
                                   torch.as_tensor(np.diff(fac.Lp), device=got.device))
    scale = torch.zeros(fac.n, dtype=got.dtype, device=got.device)
    scale = scale.scatter_reduce(0, cols, want.abs(), 'amax')
    return float(((got - want).abs() / torch.clamp(scale[cols], min=1.0)).max())


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(PATTERNS))
def test_factor_matches_plain_on_cuda(name):
    """K5 against the plain factorization on the same permuted values: L
    and D within 1e-10 of each column's max-norm, n_positive equal, one
    wrapper call and as many CUDA launches as the tree's heights."""
    _need_cuda()
    K_triu = PATTERNS[name]()
    calls, launches = tldl.factor_calls, tldl.factor_launches
    fac = tldl.LDLFactor(K_triu, device='cuda')
    torch.cuda.synchronize()
    assert tldl.factor_calls == calls + 1
    assert tldl.factor_launches - launches == fac.sym.depth <= fac.n
    s = fac.sym
    dev = torch.device('cuda')
    Lx, D, _, _ = tldl.ldl_factor_plain(torch.as_tensor(s.Ap, device=dev),
                                        torch.as_tensor(s.Ai, device=dev), fac.Ax,
                                        torch.as_tensor(s.Lp, device=dev),
                                        torch.as_tensor(s.Li, device=dev), fac.n)
    nnz = s.nnz_L
    assert _col_err(fac.Lx[:nnz], Lx, fac) <= 1e-10
    assert float(((fac.D - D).abs() / torch.clamp(D.abs(), min=1.0)).max()) <= 1e-10
    assert fac.n_positive == int((D > 0).sum())
    # the CSR copy holds the same values
    assert torch.equal(fac.Lr[torch.as_tensor(s.csc2csr, device=dev).long()], fac.Lx[:nnz])


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(PATTERNS))
def test_solve_matches_plain_on_cuda(name):
    """K6 against the plain solve on the kernel's own L: within 1e-12 of
    ||b||_inf; one wrapper call a solve."""
    _need_cuda()
    K_triu = PATTERNS[name]()
    fac = tldl.LDLFactor(K_triu, device='cuda')
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(fac.n), device='cuda')
    before = tldl.solve_launches
    x = fac.solve(b)
    torch.cuda.synchronize()
    assert tldl.solve_launches == before + 1
    perm = None if fac.perm is None else torch.as_tensor(fac.perm, device='cuda')
    want = tldl.ldl_solve_plain(fac.dense_L(), fac.Dinv, perm, b)
    assert float((x - want).abs().max()) <= 1e-12 * float(b.abs().max())
    # and it solves K x = b
    K = sp.triu(K_triu) + sp.triu(K_triu, 1).T
    r = K @ x.cpu().numpy() - b.cpu().numpy()
    assert np.abs(r).max() <= 1e-8 * max(1.0, np.abs(b.cpu().numpy()).max())


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(PATTERNS))
def test_run_to_run_bit_identity_on_cuda(name):
    """Two K5 runs give the same L, D and 1/D bit for bit, and two K6 runs
    the same x, on the same values."""
    _need_cuda()
    fac = tldl.LDLFactor(PATTERNS[name](), device='cuda')
    Lx, D, Dinv = fac.Lx.clone(), fac.D.clone(), fac.Dinv.clone()
    fac.factor()
    assert torch.equal(fac.Lx, Lx) and torch.equal(fac.D, D) and torch.equal(fac.Dinv, Dinv)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(fac.n), device='cuda')
    x1, x2 = fac.solve(b), fac.solve(b)
    assert torch.equal(x1, x2)


@pytest.mark.cuda
def test_cuda_never_reaches_plain(monkeypatch):
    """A CUDA factor launches K5 and K6 and never the plain versions."""
    _need_cuda()

    def boom(*a, **k):
        raise AssertionError('plain version reached with CUDA tensors')

    monkeypatch.setattr(tldl, 'ldl_factor_plain', boom)
    monkeypatch.setattr(tldl, 'ldl_solve_plain', boom)
    fac = tldl.LDLFactor(_ragged(), device='cuda')
    fac.solve(torch.ones(fac.n, dtype=torch.float64, device='cuda'))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['portfolio', 'banded'])
def test_ldl_algebra_card_vs_cpu(family):
    """OSQP(algebra='ldl') on the card against the CPU (plain versions):
    the same status, iterations within 5%, x within 1e-6 of ||x||; K5 and
    K6 launched on the card."""
    _need_cuda()
    P, q, A, l, u = portfolio_family(500, 10) if family == 'portfolio' else banded_qp(2048)
    out = []
    for dev in ('cuda', 'cpu'):
        f0, s0 = tldl.factor_calls, tldl.solve_launches
        m = osqp_tpu_torch.OSQP(device=dev, algebra='ldl')
        m.setup(P=P, q=q, A=A, l=l, u=u, verbose=False)
        r = m.solve(raise_error=False)
        if dev == 'cuda':
            assert tldl.factor_calls == f0 + 1 + r.info.rho_updates
            assert tldl.solve_launches - s0 >= r.info.iter
        out.append(r)
    gpu, cpu = out
    assert gpu.info.status == cpu.info.status == 'solved'
    assert abs(gpu.info.iter - cpu.info.iter) <= 0.05 * cpu.info.iter
    assert np.abs(gpu.x - cpu.x).max() <= 1e-6 * max(1.0, np.abs(cpu.x).max())
