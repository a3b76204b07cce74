"""The vmap batch engine and the differentiable layers on the card against
the same port on the CPU.

These tests need an NVIDIA GPU and skip elsewhere.  They import neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_vmap_cuda.py
"""

import numpy as np
import pytest
import torch

from osqp_tpu_torch import BatchedOSQP
from osqp_tpu_torch.nn import torch as tnn
from osqp_tpu_torch.nn.layer import make_qp_layer


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _batch(B, n, m, seed=0):
    """examples/batched_mpc.py's plant, one per instance."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m)) + 0.1
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    return P, q, A, u - 2 * s0, u


@pytest.mark.cuda
@pytest.mark.parametrize('kkt_method, solver_type', [
    ('chol', 'direct'), ('inv', 'direct'), ('chol', 'indirect')])
def test_vmap_engine_on_cuda_matches_cpu_f64(kkt_method, solver_type):
    """BatchedOSQP(engine='vmap') on the card against the CPU, float64,
    through a cold solve and a warm update(q): statuses, iterations, rho
    updates and CG steps equal; x within 1e-9 for the direct solves and
    within 1e-7 (1e-2 of eps) for PCG, whose every solve stops somewhere
    below its tolerance, a point the two devices' summation orders move in
    its last bits (measured: 2.0e-9 on the warm step)."""
    _needs_cuda()
    B, n, m = 200, 10, 15
    P, q, A, l, u = _batch(B, n, m, seed=1)
    q2 = q + 0.01 * np.random.default_rng(2).standard_normal(q.shape)
    runs = {}
    for dev in ('cuda', 'cpu'):
        s = BatchedOSQP(device=dev, kkt_method=kkt_method)
        s.setup(P, q, A, l, u, eps_abs=1e-5, eps_rel=1e-5, solver_type=solver_type)
        r1 = s.solve()
        s.update(q=q2)
        runs[dev] = (r1, s.solve())
    for got, want in zip(runs['cuda'], runs['cpu']):
        assert (want.info.status_val == 1).all()
        for k in ('status_val', 'iter', 'rho_updates', 'cg_iters'):
            np.testing.assert_array_equal(getattr(got.info, k), getattr(want.info, k))
        np.testing.assert_allclose(got.x, want.x, rtol=0,
                                   atol=1e-7 if solver_type == 'indirect' else 1e-9)


@pytest.mark.cuda
def test_vmap_engine_float32_on_cuda():
    """float32 with the explicit inverse ('auto') on the card: every instance
    solved, x within 1e-3 of the float64 CPU solve."""
    _needs_cuda()
    P, q, A, l, u = _batch(512, 32, 48, seed=3)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4)
    s = BatchedOSQP(dtype=torch.float32, device='cuda')
    s.setup(P, q, A, l, u, **kw)
    assert s._engine == 'vmap' and s._kkt_method == 'inv'
    got = s.solve()
    want = BatchedOSQP(device='cpu').setup(P, q, A, l, u, **kw).solve()
    assert (got.info.status_val == 1).all()
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_layers_on_cuda_match_cpu_f64():
    """nn.torch.OSQP and make_qp_layer forward and backward on CUDA tensors
    against CPU tensors, float64: x and every gradient within 1e-9 of its
    max-norm; results and gradients stay on the inputs' device."""
    _needs_cuda()
    B, n, m = 16, 8, 12
    P, q, A, l, u = _batch(B, n, m, seed=6)
    target = np.random.default_rng(5).standard_normal((B, n))
    # the module's inputs: P's upper triangle and all of A as patterns
    P_idx, A_idx = np.triu_indices(n), np.nonzero(np.ones((m, n)))
    out = {}
    for dev in ('cuda', 'cpu'):
        module = tnn.OSQP(P_idx, (n, n), A_idx, (m, n), eps_abs=1e-9, eps_rel=1e-9,
                          max_iter=100000)
        vals = [torch.tensor(v, device=dev, requires_grad=True)
                for v in (P[:, P_idx[0], P_idx[1]], q, A.reshape(B, -1), l, u)]
        x1 = module(*vals)
        (0.5 * ((x1 - torch.tensor(target, device=dev)) ** 2).sum()).backward()
        layer = make_qp_layer(dtype=torch.float64, eps_abs=1e-9, eps_rel=1e-9, max_iter=100000)
        dense = [torch.tensor(v, device=dev, requires_grad=True) for v in (P, q, A, l, u)]
        x2 = layer(*dense)
        (0.5 * ((x2 - torch.tensor(target, device=dev)) ** 2).sum()).backward()
        tensors = [x1, x2] + [v.grad for v in vals + dense]
        assert all(t.device.type == dev for t in tensors)
        out[dev] = [t.detach().cpu().numpy() for t in tensors]
    for got, want in zip(out['cuda'], out['cpu']):
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-9 * scale
