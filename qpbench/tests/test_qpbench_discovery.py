"""A configuration, a traffic mix and metrics that the harness picks up
from new files and manifest entries alone."""

import json
import textwrap

from qpbench import harness

TOY_CFG = {
    'name': 'toy_box', 'system': {'class': 'BatchedOSQP',
                                  'init': {'dtype': 'float64', 'engine': 'shared'},
                                  'settings': {'eps_abs': 1e-6, 'eps_rel': 1e-6}},
    'precision': 'float64', 'control_precision': 'float32', 'n': 4,
    'limits': {'status_mismatch': 0, 'term_ratio': 1.01, 'claim_gap': 1e-10},
}
TOY_PY = '''
import numpy as np


class Client:
    def __init__(self, cfg, traffic, seed):
        self.rng = np.random.default_rng(seed)
        n, B = cfg['n'], traffic['batch']
        self.P, self.A = np.eye(n), np.eye(n)
        self.q = self.rng.normal(size=(B, n))
        self.l, self.u = -np.ones((B, n)), np.ones((B, n))

    def inputs(self):
        return dict(q=self.q)

    def setup_inputs(self):
        return dict(q=self.q, l=self.l, u=self.u)

    def record(self):
        return dict(q=self.q.copy())

    def expand(self, rec, rows=None):
        rows = slice(None) if rows is None else rows
        return rec['q'][rows], self.l[rows], self.u[rows]

    def advance(self, x):
        self.q = self.q + self.rng.normal(0, self.traffic_step, self.q.shape)

    traffic_step = 0.1
'''


def write_bench(tmp_path):
    base = tmp_path / 'bench'
    for d in ('configs', 'traffic', 'metrics', 'end_to_end'):
        (base / d).mkdir(parents=True)
    (base / 'configs' / 'toy_box.json').write_text(json.dumps(TOY_CFG))
    (base / 'configs' / 'toy_box.py').write_text(TOY_PY)
    (base / 'traffic' / 'walk.json').write_text(json.dumps(dict(
        batch=3, warmup_steps=1, trace_skip=0, trace_steps=1, sample_steps=2,
        sample_instances=2)))
    (base / 'end_to_end' / 'steps_done.py').write_text(textwrap.dedent('''
        def read(ctx):
            return float(len(ctx.window.step_ms))
        '''))
    (base / 'metrics' / 'toy_iters.py').write_text(textwrap.dedent('''
        def read(ctx):
            return ctx.window.iter_sum / ctx.window.instances
        '''))
    (base / 'metrics' / 'elsewhere.py').write_text('def read(ctx):\n    return 1.0\n')
    manifest = {
        'configs': [{'name': 'toy_box', 'file': 'bench/configs/toy_box.json'}],
        'workloads': [{'name': 'toy.walk', 'config': 'toy_box', 'traffic': 'walk',
                       'chips': 1},
                      {'name': 'toy.other', 'config': 'toy_box', 'traffic': 'walk',
                       'chips': 1}],
        'end_to_end': [{'name': 'steps_done', 'unit': 'steps'}],
        'per_layer': [{'name': 'toy_iters', 'unit': 'iters', 'moves': 'steps_done',
                       'workloads': ['toy.walk']},
                      {'name': 'elsewhere', 'unit': 'x', 'moves': 'steps_done',
                       'workloads': ['toy.other']}],
    }
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    return base


def test_new_files_are_found(tmp_path):
    base = write_bench(tmp_path)
    cell = harness.resolve('toy.walk', base)
    assert cell.chips == 1 and cell.cfg['name'] == 'toy_box'
    assert set(cell.end_to_end) == {'steps_done'}
    assert set(cell.per_layer) == {'toy_iters'}
    out = harness.run_cell(cell, 2**31 + 1, 0.3, False, device='cpu')
    steps = out['e2e']['steps_done'][1]
    assert steps >= 1 and out['attempted'] == 3 * steps
    assert out['checks']['status_mismatch']['value'] == 0
    assert out['checks']['claim_gap']['value'] < 1e-10
    assert set(harness.resolve('toy.other', base).per_layer) == {'elsewhere'}
