"""The front end's own host time per step: the port's ``update`` and
``solve`` spans less its ``solve.loop`` span and less the ``sync`` spans
outside the loop (the API layer's ingest, checks, casts, staging and the
answer's conversion), over every step of the traced run's window.  In the
window the port runs only inside ``update`` and ``solve``, so every ``sync``
span there is one of theirs.  Read from the counters of
``osqp_tpu_torch.tracing``; where the port has no such module, nothing."""

import importlib.util

MODULE = 'osqp_tpu_torch.tracing'
NAMES = ('update_ns', 'solve_ns', 'solve_loop_ns', 'sync_ns', 'sync_loop_ns')


def _has_spans():
    try:
        return importlib.util.find_spec(MODULE) is not None
    except ImportError:
        return False


COUNTERS = {f'{MODULE}:{k}': (MODULE, k) for k in NAMES} if _has_spans() else {}


def _ms_per_step(ctx):
    """Each counter's delta over the window, in ms per step, or None."""
    c, steps = ctx.window.counters, len(ctx.window.step_ms)
    if not COUNTERS or not steps:
        return None
    return {k: c[f'{MODULE}:{k}'] / 1e6 / steps for k in NAMES}


def read(ctx):
    d = _ms_per_step(ctx)
    if d is None:
        return None
    return (d['update_ns'] + d['solve_ns'] - d['solve_loop_ns']
            - (d['sync_ns'] - d['sync_loop_ns']))


def detail(ctx):
    """The parts, ms per step, and ``coverage``: the port's ``update`` and
    ``solve`` spans over the harness's mean timed step."""
    d = _ms_per_step(ctx)
    if d is None:
        return None
    step_ms = ctx.window.step_ms
    return dict(update=d['update_ns'], solve=d['solve_ns'], solve_loop=d['solve_loop_ns'],
                sync_outside_loop=d['sync_ns'] - d['sync_loop_ns'],
                mean_step_ms=sum(step_ms) / len(step_ms),
                coverage=(d['update_ns'] + d['solve_ns']) / (sum(step_ms) / len(step_ms)))
