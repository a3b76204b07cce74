"""The benchmark's general driver: one run of one cell.

Everything particular sits in files that ``BENCHMARK.json`` names:

- ``configs/<config>.json``: the configuration as it is run (the system's
  class, constructor arguments and settings, the sizes, the limits of the
  comparison), with ``configs/<config>.py`` beside it: the QP and the
  closed loop around the solver (``Client``);
- ``traffic/<traffic>.json``: the traffic's parameters, read by the
  configuration's ``Client`` and by this driver (warm-up steps, traced
  steps, sampled steps);
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(ctx)`` returning a number or None (nothing to read).  A
  per-layer reader may declare ``COUNTERS`` ({key: (module, attribute)}: a
  counter of the system, read before and after the window and the traced
  steps) and ``KERNEL`` with ``KERNEL_COUNTER`` (a kernel's name in the
  device trace and the counter of its launches: a trace that holds fewer of
  its records than launches is taken again, and fails the run if it still
  does).

A run: set-up (the system's ``setup``, the cold solve, the warm-up steps),
then the window: steps until ``seconds`` have passed, each ``update`` and
``solve`` on the host clock.  The answers of a sample of steps (drawn from
the seed) are kept and judged against the plain reference once the window
has closed (``judge.py``).  With ``trace`` on, a few steps inside the
window run under the profiler, and the host's synchronisations are counted
on the other steps, so that the counting costs the traced steps nothing.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent


def load_module(path: Path):
    name = 'qpbench_' + '_'.join(path.with_suffix('').parts[-2:]).replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the manifest, with everything its name points to."""
    name: str
    chips: int
    cfg: dict
    cfg_module: object
    traffic: dict
    end_to_end: dict  # name -> (manifest entry, module)
    per_layer: dict


def _applies(entry, workload, reported):
    if 'workloads' in entry:
        return workload in entry['workloads']
    return reported is None or entry.get('moves') in reported


def resolve(workload: str, base: Path = HERE) -> Cell:
    """The cell ``workload`` of the manifest at the root above ``base``
    (the benchmark's folder), its files found by name under ``base``."""
    root = base.parent
    manifest = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in manifest['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; the manifest has {sorted(cells)}')
    w = cells[workload]
    cfgs = {c['name']: c for c in manifest['configs']}
    cfg = json.loads((root / cfgs[w['config']]['file']).read_text())
    cfg_module = load_module(base / 'configs' / f"{w['config']}.py")
    traffic = json.loads((base / 'traffic' / f"{w['traffic']}.json").read_text())
    e2e = {m['name']: (m, load_module(base / 'end_to_end' / f"{m['name']}.py"))
           for m in manifest['end_to_end'] if _applies(m, workload, None)}
    per_layer = {m['name']: (m, load_module(base / 'metrics' / f"{m['name']}.py"))
                 for m in manifest['per_layer'] if _applies(m, workload, set(e2e))}
    return Cell(w['name'], int(w['chips']), cfg, cfg_module, traffic, e2e, per_layer)


def process_age_s() -> float | None:
    """Seconds since this process started, from the kernel's record of it
    (None where /proc has no such record)."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


# -- the system under test ------------------------------------------------

def build_system(cfg, device):
    import torch

    import osqp_tpu_torch as port

    spec = cfg['system']
    init = dict(spec['init'])
    if 'dtype' in init:
        init['dtype'] = getattr(torch, init['dtype'])
    return getattr(port, spec['class'])(device=device, **init)


def answers(res) -> dict:
    """The answer of one solve as per-instance arrays (a leading axis of 1
    for a single QP)."""
    info = res.info
    x = np.asarray(res.x)
    return dict(x=x if x.ndim == 2 else x[None], y=np.atleast_2d(res.y),
                status=np.atleast_1d(np.asarray(info.status_val)),
                iter=np.atleast_1d(np.asarray(info.iter)),
                obj_val=np.atleast_1d(np.asarray(info.obj_val, np.float64)),
                dual_res=np.atleast_1d(np.asarray(info.dual_res, np.float64)))


def counter_values(counters: dict) -> dict:
    return {k: getattr(importlib.import_module(mod), attr)
            for k, (mod, attr) in counters.items()}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# -- the run ----------------------------------------------------------------

@dataclass
class Window:
    step_ms: list = field(default_factory=list)
    wall_s: float = 0.0
    instances: int = 0
    solved: int = 0
    iter_sum: int = 0
    host_syncs: int = 0  # the synchronisations counted (traced run)
    synced_steps: int = 0  # the steps they were counted on
    counters: dict = field(default_factory=dict)


class SyncCounter:
    """Counts the device synchronisations torch reports (CUDA sync debug
    mode, 'warn') while it is entered."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self._rec = self._cm.__enter__()
        warnings.simplefilter('always')
        self.torch.cuda.set_sync_debug_mode(1)
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self.count += sum('synchroniz' in str(w.message) for w in self._rec)
        self._cm.__exit__(*exc)
        return False


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = 'cuda',
             system_factory=None, client_kw=None, t_origin=None) -> dict:
    """One run; returns the parts of the result line (and what the readers
    read).  ``system_factory(cfg, device)`` replaces the system under test
    (the control, the planted faults); ``client_kw`` sizes the client (the
    CPU tests)."""
    import torch

    from . import judge, trace as trace_mod

    t_origin = time.perf_counter() if t_origin is None else t_origin
    cuda = device.startswith('cuda')
    tr = cell.traffic
    client = cell.cfg_module.Client(cell.cfg, tr, seed, **(client_kw or {}))
    factory = system_factory or build_system
    system = factory(cell.cfg, device)
    counters = {}
    kernels = {}
    for _, mod in cell.per_layer.values():
        counters.update(getattr(mod, 'COUNTERS', {}))
        if getattr(mod, 'KERNEL', None):
            kernels[mod.KERNEL] = mod.KERNEL_COUNTER
            counters[mod.KERNEL_COUNTER[0] + ':' + mod.KERNEL_COUNTER[1]] = mod.KERNEL_COUNTER
    if not trace:
        counters = {}

    system.setup(P=client.P, A=client.A, **client.setup_inputs(),
                 **cell.cfg['system']['settings'])
    res = system.solve()
    client.advance(answers(res)['x'])
    for _ in range(int(tr['warmup_steps'])):
        system.update(**client.inputs())
        res = system.solve()
        client.advance(answers(res)['x'])
    if cuda:
        torch.cuda.synchronize()
    age = process_age_s()
    setup_s = time.perf_counter() - t_origin if age is None else age

    rng = np.random.default_rng([seed, 1])
    k_sample = int(tr['sample_steps'])
    samples = []
    win = Window()
    profiled = None
    trace_at = int(tr['trace_skip']) if trace else -1
    syncs = SyncCounter(torch) if (trace and cuda) else None
    c0 = counter_values(counters)
    t_start = time.perf_counter()
    i = 0
    while True:
        if i == trace_at:
            profiled = trace_mod.profile_steps(
                lambda: _step(system, client, win, None, spans=True), int(tr['trace_steps']),
                kernels, counters)
            for rec, ans in profiled.pop('records'):
                samples = _reservoir(samples, (rec, ans), i, k_sample, rng)
                i += 1
        else:
            rec, ans = _step(system, client, win, syncs)
            samples = _reservoir(samples, (rec, ans), i, k_sample, rng)
            i += 1
        if time.perf_counter() - t_start >= seconds and (profiled or not trace):
            break
    win.wall_s = time.perf_counter() - t_start
    win.counters = delta(counter_values(counters), c0)
    win.host_syncs = syncs.count if syncs else 0

    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = SimpleNamespace(cell=cell, cfg=cell.cfg, traffic=tr, window=win, setup_s=setup_s,
                          trace=profiled, system=system, client=client, device=device)
    if cuda:
        from .peaks import card
        ctx.card = card(torch.cuda.get_device_name(0))
    e2e = {name: (entry, mod.read(ctx)) for name, (entry, mod) in cell.end_to_end.items()}
    layers = ({name: (entry, mod.read(ctx)) for name, (entry, mod) in cell.per_layer.items()}
              if trace else {})
    details = ({name: mod.detail(ctx) for name, (_, mod) in cell.per_layer.items()
                if hasattr(mod, 'detail')} if trace else {})
    del system, res, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = judge.judge(client, cell.cfg, samples, seed, int(tr['sample_instances']),
                                   device)
    return dict(attempted=win.instances, failed=win.instances - win.solved, e2e=e2e,
                layers=layers, details=details, checks=checks, readings=readings,
                memory_peak=memory_peak, trace=profiled, window=win)


def _reservoir(samples, item, i, k, rng):
    """Algorithm R: after step i, ``samples`` is a uniform draw of k steps."""
    if i < k:
        return samples + [item]
    j = int(rng.integers(0, i + 1))
    if j < k:
        samples[j] = item
    return samples


def _span(name, on):
    if not on:
        return _NULL
    from torch.profiler import record_function
    return record_function(f'qpbench.{name}')


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _step(system, client, win: Window, syncs, spans=False):
    """One closed-loop step: the inputs, ``update`` and ``solve`` (timed),
    then the plant.  Returns the step's record and answers."""
    with _span('inputs', spans):
        inputs = client.inputs()
        rec = client.record()
    t0 = time.perf_counter()
    with syncs or _NULL:
        with _span('update', spans):
            system.update(**inputs)
        with _span('solve', spans):
            res = system.solve()
    t1 = time.perf_counter()
    ans = answers(res)
    with _span('plant', spans):
        client.advance(ans['x'])
    win.step_ms.append((t1 - t0) * 1e3)
    win.synced_steps += syncs is not None
    win.instances += len(ans['status'])
    win.solved += int((ans['status'] == 1).sum())
    win.iter_sum += int(ans['iter'].sum())
    return rec, ans
