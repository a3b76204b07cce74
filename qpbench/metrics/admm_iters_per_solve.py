"""ADMM iterations per QP solved in the window: the mean of the answers'
``info.iter`` over every instance of every step (the algorithm: rho
adaptation and termination)."""


def read(ctx):
    w = ctx.window
    return w.iter_sum / w.instances if w.instances else None
