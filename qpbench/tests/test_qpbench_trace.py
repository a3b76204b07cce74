"""What is read from a trace, on events made up for the purpose."""

from types import SimpleNamespace

import torch

from qpbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, dev, start, end):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_gaps_and_kernels():
    events = [
        ev('qpbench.update', CPU, 0, 100), ev('qpbench.solve', CPU, 100, 1000),
        ev('qpbench.plant', CPU, 1000, 1200),
        ev('qpbench.solve', CUDA, 100, 1000),  # the span's annotation on the device
        ev('Memcpy HtoD', CUDA, 50, 90),
        ev('k1_kernel<float>', CUDA, 200, 600), ev('k1_kernel<float>', CUDA, 550, 700),
        ev('small', CUDA, 900, 950),
    ]
    s = trace.summarize(events, window_s=0.0012)
    # device busy: [50, 90], [200, 700], [900, 950] inside [0, 1200]
    assert abs(s['busy_s'] - 590e-6) < 1e-12
    assert trace.records_of(s, 'k1_kernel') == 2
    assert abs(trace.seconds_of(s, 'k1_kernel') - 550e-6) < 1e-12
    assert all(not name.startswith('qpbench.') for name, _ in s['device_ops'])
    gaps = s['idle_gaps']
    assert gaps[0][0] == 'plant' and abs(gaps[0][1] - 250e-6) < 1e-12
    assert sorted(g[0] for g in gaps) == ['plant', 'solve', 'solve', 'update']
    assert len(s['device_ops']) == 3
