"""The Portfolio family (``chip_smoke.py::portfolio_family``) through the
direct sparse algebra of either package in float64:
``osqp_tpu.OSQP(algebra='numpy')`` on the host, or
``osqp_tpu_torch.OSQP(device=..., algebra='ldl')``.  Each runs the path of
``chip_smoke.py`` phase 12: eps 1e-3, every other setting at its default, a
cold solve and two warm ``update(q * 1.01^k)`` steps.  One JSON line per
package and size: statuses, ADMM iterations, rho updates, the final rho,
each solution's f64 host residual over its bound
(``chip_smoke.py::sparse_residual_check``, not held), the solver's duality
gap over its bound and seconds.

It shows whether the port's iteration counts on the card are the
algorithm's, at sizes where the numpy algebra also runs.  Not a test
(pytest does not collect it); run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_ldl_witness.py --package numpy 2000:20 5000:50
    python tests/torch_ldl_witness.py --package ldl --device cuda 5000:50 10000:100

The ``ldl`` package imports neither JAX nor ``osqp_tpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EPS = 1e-3
WARM = 2


def run(make, P, q, A, l, u):
    import chip_smoke as cs

    t0 = time.perf_counter()
    o = make()
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, verbose=False)
    out = dict(setup_s=time.perf_counter() - t0, statuses=[], admm_iters=[], rho_updates=[],
               rho_estimate=[], residual_over_bound=[], gap_over_bound=[], solve_s=[])
    for k in range(WARM + 1):
        qk = q * 1.01 ** k
        t0 = time.perf_counter()
        if k:
            o.update(q=qk)
        r = o.solve(raise_error=False)
        out['solve_s'].append(time.perf_counter() - t0)
        out['statuses'].append(r.info.status)
        out['admm_iters'].append(int(r.info.iter))
        out['rho_updates'].append(int(r.info.rho_updates))
        out['rho_estimate'].append(float(r.info.rho_estimate))
        out['residual_over_bound'].append(
            cs.sparse_residual_check(P, A, l, u, qk, r.x, r.y, EPS, hold=False))
        out['gap_over_bound'].append(cs.gap_over_bound(r.info, EPS))
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--package', choices=('numpy', 'ldl'), required=True)
    ap.add_argument('--device', default='cuda', help="the port's device (package 'ldl')")
    ap.add_argument('sizes', nargs='*', default=['2000:20', '5000:50'],
                    help='assets:factors pairs')
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if args.package == 'numpy':
        import osqp_tpu

        def make():
            return osqp_tpu.OSQP(algebra='numpy')
    else:
        import osqp_tpu_torch

        def make():
            return osqp_tpu_torch.OSQP(device=args.device, algebra='ldl')

    for size in args.sizes:
        n, k = (int(s) for s in size.split(':'))
        P, q, A, l, u = cs.portfolio_family(n, k)
        row = dict(package=args.package, device=args.device if args.package == 'ldl' else 'host',
                   assets=n, factors=k, **run(make, P, q, A, l, u))
        print('ldl witness:', json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
