"""The port's spans as profiler annotations on the card: K1 inside the
device annotation of ``osqp.solve.loop``; the fleet's traffic through pinned
staging, with torch's count of the host's waits.

These tests need an NVIDIA GPU and skip elsewhere.  They import neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from osqp_tpu_torch import BatchedOSQP, tracing
from osqp_tpu_torch import batch as tbatch


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


def _torch_syncs(fn):
    """``fn()`` and the synchronisations torch reports while it runs."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum('synchroniz' in str(w.message) for w in rec)


@pytest.mark.cuda
def test_fleet_step_through_pinned_staging(monkeypatch):
    """A fleet step of 4,096 on the shared engine: ``update`` of q, l and u
    makes no synchronisation (CUDA sync debug mode 'error'), and stages the
    values a CPU solver stages, bit for bit; ``solve`` makes one
    synchronisation beyond the loop's, the answer's copy, which brings back
    the device's answer bit for bit; every byte of the step's vectors and
    answer goes through pinned staging."""
    _needs_cuda()
    B, n, m = 4096, 32, 48
    P, q, A, l, u = _fleet(B)
    l[:, 0], u[:, 0] = -np.inf, 1e31
    s = BatchedOSQP(device='cuda', dtype=torch.float32, engine='shared')
    s.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    ref = BatchedOSQP(device='cpu', dtype=torch.float32, engine='shared')
    ref.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    s.solve()
    torch.cuda.synchronize()
    new = dict(q=q + 0.01, l=l - 0.01, u=u + 0.01)
    ref.update(**new)
    c0 = tracing.counters()
    torch.cuda.set_sync_debug_mode('error')
    try:
        s.update(**new)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k, t in ref._pending.items():
        assert torch.equal(s._pending[k].cpu().view(torch.int32), t.view(torch.int32)), k

    seen = {}
    solve = tbatch.shared_solve

    def keep(*args, **kw):
        seen.update(solve(*args, **kw))
        return seen

    monkeypatch.setattr(tbatch, 'shared_solve', keep)
    r, syncs = _torch_syncs(s.solve)
    c1 = tracing.counters()
    d = {k: c1[k] - c0[k] for k in c1}
    assert syncs == d['sync_calls'] == d['sync_loop_calls'] + 1
    for k in ('x', 'y', 'prim_inf_cert', 'dual_inf_cert'):
        assert np.array_equal(getattr(r, k), seen[k].cpu().numpy(), equal_nan=True), k
    assert np.array_equal(r.info.status_val, seen['status'].cpu().numpy())
    assert np.array_equal(r.info.iter, seen['iters'].cpu().numpy())
    assert np.array_equal(r.info.obj_val, seen['obj_val'].cpu().numpy())
    assert d['pinned_h2d_bytes'] == d['h2d_bytes'] == B * (n + 2 * m) * 4
    assert d['pinned_d2h_bytes'] == B * 4 * (2 * n + 2 * m + 7)
    assert d['d2h_bytes'] - d['pinned_d2h_bytes'] <= 12 * d['sync_loop_calls']
