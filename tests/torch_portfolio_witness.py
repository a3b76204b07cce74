"""The Portfolio family (``chip_smoke.py::portfolio_family``) through both
packages on the CPU in float64: ``osqp_tpu.OSQP(algebra='jax', sparse=True)``
and ``osqp_tpu_torch.OSQP(device='cpu', sparse=True)``, with no dense budget
so that both ladders pick DIA for P and the CSR/BCOO fallback for A, as at
full size.  Each runs ``chip_smoke.py``'s Portfolio path: eps 1e-3, no
polish, every other setting at its default, a cold solve and two warm
``update(q * 1.01^k)`` steps.  One JSON line per package and size: formats,
statuses, ADMM iterations, each solution's f64 host residual over its bound
(``chip_smoke.py::sparse_residual_check``, not held), the solver's duality
gap over its bound (``chip_smoke.py::gap_over_bound``), and seconds.

It shows whether the reference reaches eps 1e-3 on this family within the
default 4,000 iterations, and so whether the port's iteration counts belong
to the algorithm.  Not a test (pytest does not collect it); run from the
repository root:

    JAX_PLATFORMS=cpu python tests/torch_portfolio_witness.py [n:k ...]

The sizes default to 2000:20 and 10000:100.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EPS = 1e-3
WARM = 2


def run(name, make, P, q, A, l, u):
    import chip_smoke as cs

    t0 = time.perf_counter()
    o = make()
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=False, verbose=False)
    setup_s = time.perf_counter() - t0
    out = dict(package=name, formats=[o._solver._sparse_fmt_P, o._solver._sparse_fmt_A],
               setup_s=setup_s, statuses=[], admm_iters=[], residual_over_bound=[],
               gap_over_bound=[], solve_s=[])
    for k in range(WARM + 1):
        qk = q * 1.01 ** k
        t0 = time.perf_counter()
        if k:
            o.update(q=qk)
        r = o.solve(raise_error=False)
        out['solve_s'].append(time.perf_counter() - t0)
        out['statuses'].append(r.info.status)
        out['admm_iters'].append(int(r.info.iter))
        out['residual_over_bound'].append(
            cs.sparse_residual_check(P, A, l, u, qk, r.x, r.y, EPS, hold=False))
        out['gap_over_bound'].append(cs.gap_over_bound(r.info, EPS))
    return out


def main(argv):
    os.environ['OSQP_TPU_DENSE_SPMV_BYTES'] = '0'
    import jax

    jax.config.update('jax_enable_x64', True)
    import chip_smoke as cs
    import osqp_tpu
    import osqp_tpu_torch

    sizes = [tuple(int(s) for s in a.split(':')) for a in argv] or [(2000, 20), (10000, 100)]
    for n, k in sizes:
        P, q, A, l, u = cs.portfolio_family(n, k)
        for name, make in (
                ('osqp_tpu', lambda: osqp_tpu.OSQP(algebra='jax', sparse=True)),
                ('osqp_tpu_torch', lambda: osqp_tpu_torch.OSQP(device='cpu', sparse=True,
                                                               dense_budget_bytes=0))):
            row = dict(assets=n, factors=k, **run(name, make, P, q, A, l, u))
            print('portfolio witness:', json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
