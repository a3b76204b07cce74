"""QP instances solved in the window over the window's wall time (host
clock).  A fleet step counts every vehicle's QP; an answer that is not
solved counts as attempted, not solved."""


def read(ctx):
    w = ctx.window
    return w.solved / w.wall_s if w.wall_s > 0 and w.solved else None
