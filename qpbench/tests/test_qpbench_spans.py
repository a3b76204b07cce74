"""The readers of the port's span counters on a made-up window: their
arithmetic, and nothing read where the port has no spans."""

from types import SimpleNamespace

import pytest

from qpbench import harness
from qpbench.harness import HERE, Window, load_module

NAMES = ('front_end_ms_per_step', 'loop_host_ms_per_step', 'sync_wait_ms_per_step',
         'setup_solver_s')
MOD = 'osqp_tpu_torch.tracing'


def readers():
    return {name: load_module(HERE / 'metrics' / f'{name}.py') for name in NAMES}


def ctx(counters, steps=4):
    win = Window(step_ms=[10.0] * steps, instances=steps * 2, iter_sum=steps * 2 * 25,
                 host_syncs=3 * 7, synced_steps=3, counters=counters)
    return SimpleNamespace(window=win, setup_s=20.0)


def window_counters():
    ms = 1_000_000  # ns
    per_step = dict(update_ns=2 * ms, solve_ns=7 * ms, solve_loop_ns=4 * ms, sync_ns=5 * ms,
                    sync_loop_ns=3 * ms, sync_calls=7, sync_loop_calls=2, solve_loop_calls=1,
                    rho_update_ns=ms // 2, rho_update_calls=1, h2d_bytes=100, d2h_bytes=40)
    return {f'{MOD}:{k}': 4 * v for k, v in per_step.items()}


def test_span_readers_arithmetic():
    r = readers()
    for name in NAMES[:3]:
        assert set(r[name].COUNTERS) <= set(window_counters())
        assert all(v == (MOD, k.split(':')[1]) for k, v in r[name].COUNTERS.items())
    c = ctx(window_counters())
    # front end: update + solve - loop - (sync - sync in the loop) = 2 + 7 - 4 - 2
    assert r['front_end_ms_per_step'].read(c) == pytest.approx(3.0)
    assert r['loop_host_ms_per_step'].read(c) == pytest.approx(1.0)
    assert r['sync_wait_ms_per_step'].read(c) == pytest.approx(5.0)
    fe = r['front_end_ms_per_step'].detail(c)
    assert fe['coverage'] == pytest.approx(0.9)
    # the three add up to the port's update and solve
    assert sum(r[n].read(c) for n in NAMES[:3]) == pytest.approx(fe['update'] + fe['solve'])
    lh = r['loop_host_ms_per_step'].detail(c)
    assert lh['per_iter_us'] == pytest.approx(40.0) and lh['rho_updates_per_step'] == 1
    sw = r['sync_wait_ms_per_step'].detail(c)
    assert (sw['syncs'], sw['syncs_front'], sw['syncs_loop'], sw['torch_syncs']) == (7, 5, 2, 7)
    assert (sw['h2d_bytes'], sw['d2h_bytes']) == (100, 40)


def test_setup_reader_reads_the_counter():
    from osqp_tpu_torch import tracing

    r = readers()['setup_solver_s']
    c = ctx({})
    assert r.read(c) == tracing.setup_ns / 1e9
    d = r.detail(c)
    assert d['setup']['calls'] == tracing.setup_calls
    assert d['share_of_setup_s'] == pytest.approx(tracing.setup_ns / 1e9 / 20.0)


def test_nothing_read_without_spans(monkeypatch):
    """A port without ``tracing`` (the benchmark laid over an older
    checkout): no counter declared, every reader returns None."""
    r = readers()
    for name in NAMES[:3]:
        monkeypatch.setattr(r[name], 'COUNTERS', {})
        assert r[name].read(ctx({})) is None and r[name].detail(ctx({})) is None
    monkeypatch.setattr(r['setup_solver_s'], '_tracing', lambda: None)
    assert r['setup_solver_s'].read(ctx({})) is None


def test_both_cells_read_them():
    for workload in ('quadcopter.fleet4096', 'portfolio.rebalance'):
        assert set(NAMES) <= set(harness.resolve(workload).per_layer)
