"""The comparison that decides ``correct``, on the CPU at a size a test run
holds: the system passes it, the control (the reference in the precision
below the configuration's) fails it, and so does the system with each fault
that a cell can have planted under its timed path."""

import copy
import json

import numpy as np
import pytest

from qpbench import harness, judge
from qpbench.control import ReferenceSystem

SIZES = {'quadcopter.fleet4096': dict(batch=8),
         'portfolio.rebalance': dict(n_assets=200, n_factors=2)}


def small(workload):
    cell = harness.resolve(workload)
    cell.traffic = dict(cell.traffic, warmup_steps=1, sample_steps=3, sample_instances=8)
    return cell


def run(workload, factory=None, seconds=0.5):
    return harness.run_cell(small(workload), 2**31 + 99, seconds, False, device='cpu',
                            system_factory=factory, client_kw=SIZES[workload])


class Broken:
    """The system with a fault under ``solve``."""

    def __init__(self, fault, cfg, device):
        self.inner = harness.build_system(cfg, device)
        self.fault = fault
        self.last = None

    def setup(self, **kw):
        return self.inner.setup(**kw)

    def update(self, **kw):
        return self.inner.update(**kw)

    def solve(self):
        res = self.inner.solve()
        if self.fault == 'unchanged' and self.last is not None:
            return self.last  # the step returns the state it started from
        self.last = copy.deepcopy(res)
        if self.fault == 'half':  # the second half of the batch left out
            B = len(np.atleast_1d(res.info.status_val))
            h = B // 2
            for arr in (res.x, res.y, res.info.status_val, res.info.iter, res.info.obj_val,
                        res.info.dual_res):
                arr[h:] = arr[:B - h]
        if self.fault == 'altered':  # an answer altered where it is produced
            x = np.atleast_2d(res.x)
            x[0, -1] += 0.01
        return res


@pytest.mark.parametrize('workload', sorted(SIZES))
def test_system_passes(workload):
    out = run(workload)
    assert judge.passed(out['checks']), out['checks']
    assert out['failed'] == 0


@pytest.mark.parametrize('workload', sorted(SIZES))
def test_control_fails(workload):
    out = run(workload, ReferenceSystem)
    assert not judge.passed(out['checks']), out['checks']
    c = out['checks']['claim_gap']
    assert c['value'] > 3 * c['limit']


@pytest.mark.parametrize('workload,fault', [
    ('quadcopter.fleet4096', 'unchanged'), ('quadcopter.fleet4096', 'half'),
    ('quadcopter.fleet4096', 'altered'), ('portfolio.rebalance', 'unchanged'),
    ('portfolio.rebalance', 'altered')])
def test_fault_fails(workload, fault):
    out = run(workload, lambda cfg, device: Broken(fault, cfg, device))
    assert not judge.passed(out['checks']), (fault, out['checks'])


def test_limits_stated():
    for name in ('quadcopter_mpc', 'portfolio_10k'):
        cfg = json.loads((harness.HERE / 'configs' / f'{name}.json').read_text())
        assert set(cfg['limits']) == {'status_mismatch', 'term_ratio', 'claim_gap'}
        assert all(v is not None for v in cfg['limits'].values())
