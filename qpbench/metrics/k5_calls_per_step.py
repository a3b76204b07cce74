"""Numeric factorizations of the KKT matrix (K5 calls: a rho update
refactors) per step over the traced window, from the 'ldl' algebra's own
counter ``ops.ldl.factor_calls``."""

COUNTERS = {'k5_calls': ('osqp_tpu_torch.ops.ldl', 'factor_calls')}


def read(ctx):
    steps = len(ctx.window.step_ms)
    return ctx.window.counters['k5_calls'] / steps if steps else None
