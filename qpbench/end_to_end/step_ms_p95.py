"""The 95th percentile, over every step of the window, of one step's wall
time on the host clock: from ``update`` to x and y on the host (the end of
``solve``)."""

import numpy as np


def read(ctx):
    ms = ctx.window.step_ms
    return float(np.percentile(ms, 95)) if ms else None
