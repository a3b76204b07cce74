"""Times the port's sparse LDL' set-up on one KKT matrix: the host's
symbolic pass (``osqp_tpu_torch.ops.ldl.symbolic``), and on a card also the
whole ``LDLFactor`` set-up (symbolic pass, copies to the card and the first
numeric factorization) and one factorization (K5) and one solve (K6),
timed with CUDA events.

``--root DIR`` imports ``osqp_tpu_torch`` and ``chip_smoke`` from another
checkout (an unpacked parent commit), so two versions compare in one run
on one machine: run them in turn, parent, change, change, parent.  One
JSON line per case.  Not a test (pytest does not collect it); run from the
repository root:

    python tests/torch_ldl_symbolic_time.py portfolio:2000:20 random:3000:2000:0.002
    python tests/torch_ldl_symbolic_time.py --device cuda --root build/parent \\
        portfolio:10000:100 random:6000:4000:0.001 banded:65536

Cases: ``portfolio:N:K`` (``chip_smoke.py::portfolio_family``),
``random:n:m:density`` (a seeded random sparse QP, P = L L' + 0.1 I, A
random, as ``tests/test_torch_ldl_cuda.py::_ragged``) and ``banded:n``
(``chip_smoke.py::banded_qp``), each as ``chip_smoke.py::kkt_triu``.
Imports neither JAX nor ``osqp_tpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

REPEATS = 3


def kkt(cs, case):
    kind, *a = case.split(':')
    if kind == 'portfolio':
        P, _, A, _, _ = cs.portfolio_family(int(a[0]), int(a[1]))
    elif kind == 'banded':
        P, _, A, _, _ = cs.banded_qp(int(a[0]))
    elif kind == 'random':
        n, m, density = int(a[0]), int(a[1]), float(a[2])
        rng = np.random.default_rng(0)
        L = sp.random(n, n, density=density, random_state=rng)
        P = (L @ L.T + 0.1 * sp.eye(n)).tocsc()
        A = sp.random(m, n, density=density, random_state=rng).tocsc()
    else:
        raise ValueError(f'unknown case {case!r}')
    return cs.kkt_triu(P, A)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('cases', nargs='+')
    ap.add_argument('--root', default=str(Path(__file__).resolve().parents[1]),
                    help='the checkout to import the port from')
    ap.add_argument('--device', default=None, help="'cuda' also times set-up, K5 and K6")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import chip_smoke as cs
    from osqp_tpu_torch.ops import ldl

    for case in args.cases:
        K = kkt(cs, case)
        sym_s = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            s = ldl.symbolic(K)
            sym_s.append(time.perf_counter() - t0)
        row = dict(root=root, case=case, N=s.n, nnz_L=s.nnz_L, symbolic_s=sym_s,
                   supernodes=len(getattr(s, 'sn', ())))
        if args.device == 'cuda':
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fac = ldl.LDLFactor(K, device='cuda')
            torch.cuda.synchronize()
            row['setup_s'] = time.perf_counter() - t0
            row['k5_ms'] = cuda_ms(fac.launch_factor, 3)
            b = torch.ones(fac.n, dtype=torch.float64, device='cuda')
            row['k6_ms'] = cuda_ms(lambda: fac.solve(b), 5)
            del fac
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
