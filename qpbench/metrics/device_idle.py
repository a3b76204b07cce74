"""The share of the traced steps' wall time in which no operation ran on
the device, in percent: 100 (1 - busy_s / window_s) from the trace."""


def read(ctx):
    t = ctx.trace
    if not t or t['window_s'] <= 0 or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
