"""The port's spans as profiler annotations on the card: K1 inside the
device annotation of ``osqp.solve.loop``.

These tests need an NVIDIA GPU and skip elsewhere.  They import neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from osqp_tpu_torch import BatchedOSQP, tracing


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _fleet(B, n=32, m=48, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    P = L @ L.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    u = rng.random((B, m)) + 0.1
    return P, q, A, -u, u


@pytest.mark.cuda
def test_k1_inside_the_loop_annotation():
    """A fleet of 4,096 on the shared engine (K1 an epoch), profiled with
    CUDA activity: under ``annotate()`` every K1 record lies inside a device
    annotation ``osqp.solve.loop``; without it the profile holds no
    ``osqp.`` event, so a trace reads the same events as without spans."""
    _needs_cuda()
    P, q, A, l, u = _fleet(4096)
    s = BatchedOSQP(device='cuda', dtype=torch.float32, engine='shared')
    s.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    s.solve()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        s.update(q=q + 0.01)
        s.solve()
        torch.cuda.synchronize()
    assert not [e for e in prof.events() if e.name.startswith('osqp.')]
    with profile(activities=acts) as prof:
        with tracing.annotate():
            s.update(q=q + 0.02)
            s.solve()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.events()
    loops = [e.time_range for e in ev
             if e.device_type == cuda and e.name == 'osqp.solve.loop']
    k1 = [e.time_range for e in ev
          if e.device_type == cuda and 'shared_epoch_kernel' in e.name]
    assert loops and k1
    for k in k1:
        assert any(lp.start <= k.start and k.end <= lp.end for lp in loops), (k, loops)
