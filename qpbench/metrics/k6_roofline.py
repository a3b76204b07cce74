"""K6 (``ops/csrc/ldl_solve.cu``, the LDL' solves) against its roofline, in
percent, over the traced steps.

A solve needs L's values once: 8 bytes for each structural nonzero of L
under the ordering the system chose (``nnz_L`` of its symbolic analysis,
without supernode padding), plus the right-hand side and the solution (8
bytes each of N).  Those bytes of every launch are put against the card's
memory bandwidth; the time is the kernel's records in the trace."""

from qpbench.trace import seconds_of

KERNEL = 'ldl_solve_kernel'
KERNEL_COUNTER = ('osqp_tpu_torch.ops.ldl', 'solve_launches')


def launch_bytes(nnz_L, N):
    return 8 * nnz_L + 2 * 8 * N


def structure(system):
    """(nnz_L, N) of the factor the system solves with."""
    fac = system._solver._kkt.factor
    return fac.sym.nnz_L, fac.n


def _numbers(ctx):
    t = ctx.trace
    secs = seconds_of(t, KERNEL) if t else 0.0
    if secs <= 0:
        return None
    nnz_L, N = structure(ctx.system)
    launches = t['counters'][':'.join(KERNEL_COUNTER)]
    nbytes = launches * launch_bytes(nnz_L, N)
    return dict(kernel_s=secs, launches=launches, nnz_L=nnz_L, N=N, bytes=nbytes,
                bound_s=nbytes / ctx.card['bytes_per_s'])


def read(ctx):
    v = _numbers(ctx)
    return None if v is None else 100.0 * v['bound_s'] / v['kernel_s']


def detail(ctx):
    return _numbers(ctx)
