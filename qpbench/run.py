"""Run one cell of the benchmark of ``osqp_tpu_torch`` once, on the card.

    python3 qpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic and
metrics are named in ``BENCHMARK.json``; ``harness.py`` says how a run goes.
The process keeps to one host thread.  Prints the judged numbers beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and the trace's breakdown.  Exits
non-zero, with no result, without enough CUDA cards, without the system under
test, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import os
import time

T_ORIGIN = time.perf_counter()
# one host thread for every library: on a host shared with other work, a pool
# of threads makes the host's part of a step slower and its runs spread wider
for _var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
    os.environ[_var] = '1'

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out, trace, torch):
    metrics = out['layers'] if trace else out['e2e']
    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=int(out['memory_peak']))
    line = dict(correct=None, attempted=out['attempted'], failed=out['failed'],
                metrics={name: dict(value=float(v), unit=entry['unit'])
                         for name, (entry, v) in metrics.items() if v is not None},
                device=device)
    if trace:
        t = out['trace']
        device.update(busy_s=t['busy_s'], window_s=t['window_s'])
        line['breakdown'] = dict(device_ops=t['device_ops'], idle_gaps=t['idle_gaps'])
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from qpbench import harness, imports, judge

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} CUDA card(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    try:
        import osqp_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f'the system under test, osqp_tpu_torch, is not here: {exc}', file=sys.stderr)
        return 4
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                           t_origin=T_ORIGIN)
    found = imports.forbidden_loaded(sys.modules)
    if found:
        print(f'loaded in this process: {found}', file=sys.stderr)
        return 5
    line = result_line(cell, out, bool(args.trace), torch)
    line['correct'] = judge.passed(out['checks'])
    # a reading that is not a finite number fails its check; JSON has no inf
    line['checks'] = {name: dict(value=c['value'] if math.isfinite(c['value']) else None,
                                 limit=c['limit'])
                      for name, c in out['checks'].items()}
    if args.trace:
        for name, value in out['details'].items():
            print(f'detail {name} {json.dumps(value)}', file=sys.stderr)
        print(f"trace idle_by_span {json.dumps(out['trace']['idle_by_span'])} "
              f"tries {out['trace']['tries']}", file=sys.stderr)
    print(f"readings {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in out['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
