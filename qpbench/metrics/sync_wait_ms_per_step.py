"""The host's waits for the card per step: every ``sync`` span of the port
(a copy between host and device memory, or a value the host reads from the
card) inside ``update`` and ``solve``, over every step of the traced run's
window.  Read from the counters of ``osqp_tpu_torch.tracing``; where the
port has no such module, nothing."""

import importlib.util

MODULE = 'osqp_tpu_torch.tracing'
NAMES = ('sync_ns', 'sync_calls', 'sync_loop_ns', 'sync_loop_calls', 'h2d_bytes', 'd2h_bytes')


def _has_spans():
    try:
        return importlib.util.find_spec(MODULE) is not None
    except ImportError:
        return False


COUNTERS = {f'{MODULE}:{k}': (MODULE, k) for k in NAMES} if _has_spans() else {}


def _per_step(ctx):
    c, steps = ctx.window.counters, len(ctx.window.step_ms)
    if not COUNTERS or not steps:
        return None
    return {k: c[f'{MODULE}:{k}'] / steps for k in NAMES}


def read(ctx):
    d = _per_step(ctx)
    return None if d is None else d['sync_ns'] / 1e6


def detail(ctx):
    """The port's own sync count per step, split into the front end's and
    the loop's, beside torch's count (``host_syncs_per_step``), their waits
    (ms per step) and the bytes copied each way per step."""
    d = _per_step(ctx)
    if d is None:
        return None
    w = ctx.window
    return dict(syncs=d['sync_calls'], syncs_front=d['sync_calls'] - d['sync_loop_calls'],
                syncs_loop=d['sync_loop_calls'],
                torch_syncs=w.host_syncs / w.synced_steps if w.synced_steps else None,
                wait_front=(d['sync_ns'] - d['sync_loop_ns']) / 1e6,
                wait_loop=d['sync_loop_ns'] / 1e6,
                h2d_bytes=d['h2d_bytes'], d2h_bytes=d['d2h_bytes'])
