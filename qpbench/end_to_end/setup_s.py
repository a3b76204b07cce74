"""From the process's start to the window's start: imports, the data, the
system's ``setup`` (in a fresh checkout, nvcc building the kernels), the cold
solve and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
