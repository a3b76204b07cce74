"""The port's spans (``osqp_tpu_torch.tracing``) on the CPU: their
arithmetic, the spans and syncs one step of the shared engine and one of the
'ldl' algebra pass, and their profiler annotations.

A sync span is counted where the code would block on a card, whatever the
device: on the CPU the same sites pass, so the counts equal the card's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import osqp_tpu_torch
from osqp_tpu_torch import BatchedOSQP, tracing


def _delta(c0):
    c1 = tracing.counters()
    return {k: c1[k] - c0[k] for k in c1}


def test_span_arithmetic():
    c0 = tracing.counters()
    with tracing.span('solve'):
        with tracing.span('sync', d2h=12):
            pass
        with tracing.span('solve.loop'):
            with tracing.span('rho.update'):
                with tracing.span('sync', h2d=5):
                    pass
            with tracing.span('sync'):
                pass
    d = _delta(c0)
    assert d['solve_calls'] == d['solve_loop_calls'] == d['rho_update_calls'] == 1
    assert d['sync_calls'] == 3 and d['sync_loop_calls'] == 2
    assert (d['h2d_bytes'], d['d2h_bytes']) == (5, 12)
    assert d['solve_self_ns'] == d['solve_ns'] - d['solve_loop_ns'] - (d['sync_ns']
                                                                       - d['sync_loop_ns'])
    assert d['rho_update_self_ns'] <= d['rho_update_ns'] <= d['solve_loop_ns'] <= d['solve_ns']
    assert d['sync_self_ns'] == d['sync_ns']  # no child
    assert d['update_calls'] == 0 and d['update_ns'] == 0
    # a span closes when its block raises, and names are checked
    with pytest.raises(ValueError):
        with tracing.span('update'):
            raise ValueError
    assert tracing._thread().t0 == []
    with pytest.raises(KeyError):
        tracing.span('no.such.span')
    assert all(isinstance(getattr(tracing, k), int) for k in tracing.COUNTERS)


def _fleet(B, n=8, m=12, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    P = L @ L.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    u = rng.random((B, m)) + 0.1
    return P, q, A, -u, u


@pytest.mark.parametrize('B', [64, 512])
def test_shared_engine_step_spans(B):
    """A warm step of the shared engine: one span each of update, stage
    (inside update), solve and solve.loop; syncs: one an epoch (the count
    of unsolved columns), the straggler compaction's two where the batch
    compacts (B = 512), and the answer's one copy.  Update's copy of q goes
    through pinned staging without a wait, and the status table is copied
    to the device once, at the first solve.  ``info.host_syncs`` counts the
    loop's syncs.  Every byte of the step but the loop's reads of its counts
    goes through the staging: q's in, the answer's eleven arrays out."""
    P, q, A, l, u = _fleet(B)
    n, m = P.shape[0], A.shape[0]
    s = BatchedOSQP(device='cpu', dtype=torch.float32, engine='shared')
    c0 = tracing.counters()
    s.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    d = _delta(c0)
    assert d['setup_calls'] == d['setup_scale_calls'] == 1
    s.solve()
    c0 = tracing.counters()
    s.update(q=q + 0.01)
    r = s.solve()
    d = _delta(c0)
    assert (r.info.status_val == 1).all()
    epochs = -(-int(r.info.iter.max()) // 25)
    compaction = 2 if B >= 512 else 0
    assert d['update_calls'] == d['stage_calls'] == d['solve_calls'] == 1
    assert d['solve_loop_calls'] == 1
    assert d['stage_ns'] <= d['update_ns']
    assert d['sync_loop_calls'] == epochs + compaction
    assert d['sync_calls'] == epochs + compaction + 1
    assert r.info.host_syncs == epochs + compaction
    assert d['h2d_bytes'] == d['pinned_h2d_bytes'] == B * n * 4
    # x, y, the two certificates, status, iterations, five (B,) values
    assert d['pinned_d2h_bytes'] == B * 4 * (2 * n + 2 * m + 7)
    # an epoch reads 8 or 12 bytes, the compaction 8 (and the indices)
    assert 8 * epochs <= d['d2h_bytes'] - d['pinned_d2h_bytes'] <= 12 * (epochs + compaction)
    assert d['setup_calls'] == d['rho_update_calls'] == 0


def _ldl_qp(n=40, m=30):
    rng = np.random.default_rng(1)
    M = sp.random(n, n, density=0.2, random_state=1)
    P = (M @ M.T + 0.1 * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=0.3, random_state=2).tocsc()
    return P, rng.standard_normal(n), A, -rng.random(m) - 0.1, rng.random(m) + 0.1


def test_ldl_step_spans():
    """OSQP(algebra='ldl'): setup's spans (Ruiz, the symbolic pass, the
    first factorization), then a warm step: update's copy of q, the loop's
    syncs (``info.host_syncs`` but the pivot reads of refactorizations,
    which the CPU's factorization does not make) and the answer's four
    copies."""
    P, q, A, l, u = _ldl_qp()
    o = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
    c0 = tracing.counters()
    o.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, eps_abs=1e-5, eps_rel=1e-5)
    d = _delta(c0)
    assert (d['setup_calls'], d['setup_scale_calls'], d['ldl_symbolic_calls'],
            d['ldl_factor_calls']) == (1, 1, 1, 1)
    assert d['ldl_symbolic_ns'] + d['ldl_factor_ns'] + d['setup_scale_ns'] <= d['setup_ns']
    for k, qk in enumerate((q, q + 0.01)):
        c0 = tracing.counters()
        if k:
            o.update(q=qk)
        r = o.solve(raise_error=True)
        d = _delta(c0)
        loop = r.info.host_syncs - r.info.rho_updates
        assert d['solve_calls'] == d['solve_loop_calls'] == 1
        assert d['update_calls'] == k
        assert d['sync_loop_calls'] == loop
        assert d['sync_calls'] == k + loop + 4
        assert d['ldl_factor_calls'] == d['rho_update_calls'] == r.info.rho_updates


def _osqp_events(prof):
    return [e for e in prof.events() if e.name.startswith('osqp.')]


def test_annotations_nest_as_the_spans():
    """Under ``annotate()`` a CPU profile holds the spans as ``osqp.*``
    ranges nested as the spans are; without it, none."""
    P, q, A, l, u = _fleet(64)
    s = BatchedOSQP(device='cpu', dtype=torch.float32, engine='shared')
    s.setup(P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3)
    s.solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.update(q=q + 0.01)
        s.solve()
    assert _osqp_events(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate():
            s.update(q=q + 0.02)
            r = s.solve()
    epochs = -(-int(r.info.iter.max()) // 25)
    ev = _osqp_events(prof)
    names = [e.name for e in ev]
    assert names.count('osqp.update') == names.count('osqp.solve') == 1
    assert names.count('osqp.solve.loop') == names.count('osqp.stage') == 1
    assert names.count('osqp.sync') == epochs + 1

    def inside(e, outer):
        return (outer.time_range.start <= e.time_range.start
                and e.time_range.end <= outer.time_range.end)

    (upd,) = [e for e in ev if e.name == 'osqp.update']
    (sol,) = [e for e in ev if e.name == 'osqp.solve']
    (loop,) = [e for e in ev if e.name == 'osqp.solve.loop']
    (stage,) = [e for e in ev if e.name == 'osqp.stage']
    assert inside(loop, sol) and inside(stage, upd)
    syncs = [e for e in ev if e.name == 'osqp.sync']
    assert sum(inside(e, upd) for e in syncs) == 0
    assert sum(inside(e, loop) for e in syncs) == epochs
    assert sum(inside(e, sol) for e in syncs) == epochs + 1
    assert tracing._thread().annotate == 0
