"""The multi-device package on the card against the same package on the
CPU, and the mesh's device rules.

The card tests need an NVIDIA GPU with nvcc and skip elsewhere; the device
rules run anywhere.  Nothing here imports JAX or the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from osqp_tpu_torch.ops import dia_matvec as tdm
from osqp_tpu_torch.parallel import (
    Mesh, banded_mpc_rollout, banded_qp_setup, banded_qp_solve, big_qp_setup, big_qp_solve,
    dp_mp_solve, make_mesh,
)
from osqp_tpu_torch.parallel.mesh import Parts

KW = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000, cg_tol=1e-12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the port's CPU loops issue many tiny
    torch ops, and with the default pool each sparse product or batched
    factorization wakes every core (bigqp: 8x the CPU time of one thread
    for the same wall), which starves the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _banded_qp(n, seed=0):
    """tests/test_banded.py's family: tridiagonal P, banded A, a few
    equality and loose rows."""
    rng = np.random.default_rng(seed)
    P = sparse.diags([np.full(n, 2.0), np.full(n - 1, -0.7), np.full(n - 1, -0.7)],
                     [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = (sparse.eye(n) + sparse.diags([np.full(n - 2, 0.4)], [2], shape=(n, n))
         + sparse.diags([np.full(n - 1, -0.3)], [-1], shape=(n, n))).tocsc()
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    l = u - 2 * s0
    l[:3] = u[:3]
    l[3:5] = -1e30
    return P, q, A, l, u


def _random_batch(B, n, m, seed=0):
    """tests/test_sharded.py's dense batch family."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n))
    P = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m))
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    return P, q, A, u - 2 * s0, u


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['banded', 'bigqp'])
def test_huge_qp_on_cuda_matches_cpu(which):
    """J = 4 shards on the card against the CPU, f64: status, iterations and
    rho updates equal, x within 1e-9; the banded products launch K2 on
    every shard and never fall back."""
    _needs_cuda()
    setup, solve = ((banded_qp_setup, banded_qp_solve) if which == 'banded'
                    else (big_qp_setup, big_qp_solve))
    P, q, A, l, u = _banded_qp(1024, seed=5)
    runs = {}
    for dev in ('cuda', 'cpu'):
        before = tdm.launches
        runs[dev] = solve(make_mesh((4,), ('mp',), device=dev),
                          setup(P, q, A, l, u, 4, device=dev), **KW)
        launched = tdm.launches - before
        if dev == 'cpu' or which == 'bigqp':
            assert launched == 0
        else:
            assert launched >= 3 * runs[dev].cg_iters * 4
    got, want = runs['cuda'], runs['cpu']
    assert got.status == want.status == 1
    assert (got.iters, got.rho_updates) == (want.iters, want.rho_updates)
    assert got.x.device.type == 'cuda'
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_banded_rollout_on_cuda_matches_cpu():
    _needs_cuda()
    n = 512
    P, q, A, l, u = _banded_qp(n, seed=13)
    q_seq = q[None] + 0.05 * np.random.default_rng(1).standard_normal((3, n))
    runs = {dev: banded_mpc_rollout(make_mesh((4,), ('mp',), device=dev),
                                    banded_qp_setup(P, q, A, l, u, 4, device=dev), q_seq, **KW)
            for dev in ('cuda', 'cpu')}
    assert runs['cuda'].x.device.type == 'cuda'
    assert torch.equal(runs['cuda'].iters.cpu(), runs['cpu'].iters)
    assert torch.equal(runs['cuda'].status.cpu(), runs['cpu'].status)
    np.testing.assert_allclose(runs['cuda'].x.cpu().numpy(), runs['cpu'].x.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.cuda
def test_dp_mp_on_cuda_matches_cpu():
    _needs_cuda()
    P, q, A, l, u = _random_batch(8, 8, 16, seed=11)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=1000, polish=True)
    runs = {dev: dp_mp_solve(make_mesh((2, 2), ('dp', 'mp'), device=dev), P, q, A, l, u, **kw)
            for dev in ('cuda', 'cpu')}
    got, want = runs['cuda'], runs['cpu']
    assert got.x.device.type == 'cuda'
    for name in ('status', 'iters', 'rho_updates', 'status_polish'):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(), rtol=0, atol=1e-9)


def test_mesh_without_device_and_cuda_raises(monkeypatch):
    """make_mesh() with no device raises where CUDA is absent; 'cpu' is
    taken when asked for."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((4,), ('mp',))
    assert {d.type for d in make_mesh((2, 2), ('dp', 'mp'), device='cpu').device_list} == {'cpu'}


def test_cpu_tensor_on_cuda_mesh_raises():
    """A mesh on the card never takes a CPU tensor: distributing data or a
    collective over CPU parts raises (checked without touching a card)."""
    mesh = Mesh(np.array(['cuda:0'] * 2, dtype=object), ('mp',))
    t = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match='mesh on cuda'):
        mesh.split(t, ('mp',))
    with pytest.raises(ValueError, match='the mesh puts it on cuda:0'):
        mesh.psum(Parts([t, t]))
    with pytest.raises(ValueError, match='mesh on cuda'):
        banded_qp_solve(mesh, banded_qp_setup(*_banded_qp(32), 2, device='cpu'))
    with pytest.raises(ValueError, match='mesh on cuda'):
        dp_mp_solve(Mesh(np.array(['cuda:0'] * 4, dtype=object).reshape(2, 2), ('dp', 'mp')),
                    *(torch.tensor(a) for a in _random_batch(2, 4, 4)))
