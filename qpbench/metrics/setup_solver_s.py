"""The port's own ``setup`` call, in seconds: its ``setup`` span's total
since the process started (setup comes before the window, so this is the
counter itself, not a delta).  Read from ``osqp_tpu_torch.tracing``; where
the port has no such module, nothing."""

import importlib


def _tracing():
    try:
        return importlib.import_module('osqp_tpu_torch.tracing')
    except ImportError:
        return None


def read(ctx):
    t = _tracing()
    return None if t is None else t.setup_ns / 1e9


def detail(ctx):
    """Seconds since the process started in ``setup.scale``, ``ldl.symbolic``,
    ``ldl.factor`` and ``kernel.load`` (wherever each fell: a kernel loads at
    its first launch, a refactorization may come in the window), the calls of
    each, and ``setup`` as a share of the run's ``setup_s``."""
    t = _tracing()
    if t is None:
        return None
    out = {name: dict(s=getattr(t, f'{name}_ns') / 1e9, calls=getattr(t, f'{name}_calls'))
           for name in ('setup', 'setup_scale', 'ldl_symbolic', 'ldl_factor', 'kernel_load')}
    out['share_of_setup_s'] = t.setup_ns / 1e9 / ctx.setup_s if ctx.setup_s else None
    return out
