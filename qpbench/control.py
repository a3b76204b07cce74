"""The control of the comparison that decides ``correct``: the plain
reference put in the system's place, computed in the precision below the one
the configuration states (``control_precision`` in its file: TF32 products
for float32, float32 for float64).  Its answers go through the same run (the
traffic's own warm-up, then the window) and the same judge as the system's, and have to come out as not correct.

    python3 qpbench/control.py --workload <name> --seed <n> [...] --seconds <s>

prints, for each seed, the judged numbers beside their limits as one JSON
line.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class ReferenceSystem:
    """The reference with the solver's interface (``setup``, ``update``,
    ``solve``), solving every instance of a step in the configuration's
    ``control_precision``."""

    def __init__(self, cfg, device):
        from qpbench.reference import ipm

        self.ipm = ipm
        self.prec = ipm.Precision(cfg['control_precision'])
        self.device = device

    def _t(self, v):
        import scipy.sparse as sp
        import torch

        v = v.toarray() if sp.issparse(v) else np.asarray(v, np.float64)
        return torch.as_tensor(v, dtype=torch.float64, device=self.device)

    def setup(self, P, A, q, l, u, **settings):
        self.P, self.A = self._t(P), self._t(A)
        self.q, self.l, self.u = (self._t(v).reshape(-1, v.shape[-1]) for v in (q, l, u))

    def update(self, q=None, l=None, u=None):
        for name, v in (('q', q), ('l', l), ('u', u)):
            if v is not None:
                setattr(self, name, self._t(v).reshape(-1, np.shape(v)[-1]))

    def solve(self):
        B = max(t.shape[0] for t in (self.q, self.l, self.u))
        q, l, u = (t.expand(B, -1) for t in (self.q, self.l, self.u))
        r = self.ipm.solve(self.P, self.A, q, l, u, prec=self.prec)

        def host(t):
            return t.cpu().numpy()

        info = SimpleNamespace(status_val=host(r.status), iter=host(r.iters),
                               obj_val=host(r.obj_val).astype(np.float64),
                               dual_res=host(r.dual_res).astype(np.float64))
        return SimpleNamespace(x=host(r.x), y=host(r.y), info=info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from qpbench import harness, judge

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print('the control runs on the card', file=sys.stderr)
        return 3
    what = f"reference in {cell.cfg['control_precision']}"
    for seed in args.seed:
        out = harness.run_cell(cell, seed, args.seconds, False, 'cuda',
                               system_factory=ReferenceSystem)
        print(json.dumps(dict(workload=cell.name, control=what, seed=seed,
                              correct=judge.passed(out['checks']), attempted=out['attempted'],
                              failed=out['failed'], steps=len(out['window'].step_ms),
                              checks=out['checks'], readings=out['readings'])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
