"""K1 (``ops/csrc/shared_epoch.cu``, the fused shared-structure epoch) against
its roofline, in percent, over the traced steps.

The work is what the inputs need, whatever implements it: each instance
iterates ``info.iter`` times with the (n+m) x (n+2m) affine map F, 2 (n+m)
(n+2m) operations an iteration, and is checked once an epoch while it is
active (ceil(iter / epoch) checks of [P; A] x and A'y, 2 (n+m) n + 2 m n
operations); F is read once a launch, and the state of each active instance
(S: n+2m, dX: n, dY: m) is read once and written once an epoch.  The
operations are put against the card's bf16 tensor-core peak and the bytes
against its memory bandwidth, so no implementation of the same float32 work
reads above 100%; the time is the kernel's records in the trace."""

import numpy as np

from qpbench.trace import seconds_of

KERNEL = 'shared_epoch_kernel'
KERNEL_COUNTER = ('osqp_tpu_torch.ops.shared_epoch', 'launches')


def iteration_ops(n, m):
    return 2 * (n + m) * (n + 2 * m)


def check_ops(n, m):
    return 2 * (n + m) * n + 2 * m * n


def work(iters, launches, n, m, epoch_iters, itemsize):
    """``(operations, bytes)`` of the epochs that gave these per-instance
    iteration counts in ``launches`` launches."""
    iters = np.asarray(iters, np.int64)
    checks = int((-(-iters // epoch_iters)).sum())
    ops = int(iters.sum()) * iteration_ops(n, m) + checks * check_ops(n, m)
    state = (n + 2 * m) + n + m
    nbytes = launches * (n + m) * (n + 2 * m) * itemsize + checks * 2 * state * itemsize
    return ops, nbytes


def _numbers(ctx):
    t = ctx.trace
    secs = seconds_of(t, KERNEL) if t else 0.0
    if secs <= 0:
        return None
    cfg = ctx.cfg
    iters = np.concatenate([a['iter'] for a in t['answers']])
    launches = t['counters'][':'.join(KERNEL_COUNTER)]
    itemsize = 4 if cfg['precision'] == 'float32' else 8
    ops, nbytes = work(iters, launches, cfg['n'], cfg['m'], cfg['check_termination'], itemsize)
    card = ctx.card
    return dict(kernel_s=secs, launches=launches, ops=ops, bytes=nbytes,
                bound_s=max(ops / card['bf16'], nbytes / card['bytes_per_s']),
                fp32_bound_s=max(ops / card['fp32'], nbytes / card['bytes_per_s']))


def read(ctx):
    v = _numbers(ctx)
    return None if v is None else 100.0 * v['bound_s'] / v['kernel_s']


def detail(ctx):
    """The counts behind the share, and the share against the CUDA cores'
    float32 peak, for reading."""
    v = _numbers(ctx)
    if v is not None:
        v['share_of_fp32_peak_pct'] = 100.0 * v['fp32_bound_s'] / v['kernel_s']
    return v
