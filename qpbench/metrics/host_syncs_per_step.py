"""Device synchronisations per step: the waits of the host for the card
inside ``update`` and ``solve`` (an epoch's or a termination check's
decision, the copies of the answer).  The count is torch's: its CUDA sync
debug mode reports each synchronisation, on every step of the traced run's
window but the profiled ones, so the profile carries no cost of counting."""


def read(ctx):
    w = ctx.window
    return w.host_syncs / w.synced_steps if w.synced_steps else None
