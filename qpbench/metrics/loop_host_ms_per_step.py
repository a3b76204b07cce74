"""The solver loops' own host time per step: the port's ``solve.loop`` span
less the ``sync`` spans inside it (launching each epoch or iteration, the
bookkeeping between them, the straggler compaction, rho updates), over every
step of the traced run's window.  Read from the counters of
``osqp_tpu_torch.tracing``; where the port has no such module, nothing."""

import importlib.util

MODULE = 'osqp_tpu_torch.tracing'
NAMES = ('solve_loop_ns', 'solve_loop_calls', 'sync_loop_ns', 'rho_update_ns',
         'rho_update_calls')


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
    return None if d is None else (d['solve_loop_ns'] - d['sync_loop_ns']) / 1e6


def detail(ctx):
    """The loop and its syncs (ms per step), rho updates, and the loop's own
    host time per ADMM iteration of the mean instance (us)."""
    d = _per_step(ctx)
    if d is None:
        return None
    w = ctx.window
    own_ms = (d['solve_loop_ns'] - d['sync_loop_ns']) / 1e6
    iters = w.iter_sum / w.instances if w.instances else 0
    return dict(solve_loop=d['solve_loop_ns'] / 1e6, sync_in_loop=d['sync_loop_ns'] / 1e6,
                loops_per_step=d['solve_loop_calls'], rho_update=d['rho_update_ns'] / 1e6,
                rho_updates_per_step=d['rho_update_calls'], iters_per_solve=iters,
                per_iter_us=own_ms * 1e3 / iters if iters else None)
