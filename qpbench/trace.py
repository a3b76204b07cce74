"""The traced steps: a few steps of the window under ``torch.profiler``, and
what is read from the trace.

- ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, memset) ran, inside the traced steps; ``window_s``: their
  length on the host clock, from before the first step to a synchronise
  after the last.
- ``kernels``: for each kernel named by a per-layer reader, its records and
  their summed seconds.  The trace can drop records; where a kernel has
  fewer records than its launch counter says it launched, the steps are
  traced again (the method of the repository's ``chip_smoke.device_ms``),
  and a run whose traces all fall short fails rather than read a kernel as
  shorter than it was.
- ``breakdown``: the ten device operations that took most time, and the ten
  longest idle gaps, each named by the benchmark's own span that the host
  was in at the gap's middle: ``inputs`` (the client makes the step's
  inputs), ``update``, ``solve`` (which ends with the answer's copy to the
  host) or ``plant`` (the client applies the answer).
"""

from __future__ import annotations

import sys
import time

from .harness import counter_values, delta


class TraceError(RuntimeError):
    pass


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s):
    """Numbers from a profile's events (``prof.events()``; times in us)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # the benchmark's spans also appear on the device's timeline, as
    # annotations: they are not device operations
    dev = [e for e in events if e.device_type == cuda and not e.name.startswith('qpbench.')]
    spans = [e for e in events if e.device_type != cuda and e.name.startswith('qpbench.')]
    by_name = {}
    for e in dev:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + (e.time_range.end - e.time_range.start))
    if spans:
        t0 = min(e.time_range.start for e in spans)
        t1 = max(e.time_range.end for e in spans)
    else:
        t0 = min((e.time_range.start for e in dev), default=0.0)
        t1 = max((e.time_range.end for e in dev), default=0.0)
    busy = _merge([(max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in dev
                   if e.time_range.end > t0 and e.time_range.start < t1])
    busy_us = sum(e - s for s, e in busy)
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def label(mid):
        for sp in spans:
            if sp.time_range.start <= mid <= sp.time_range.end:
                return sp.name.split('.', 1)[1]
        return 'harness'

    named = sorted(((label(0.5 * (s + e)), (e - s) / 1e6) for s, e in gaps),
                   key=lambda g: -g[1])
    idle_by_span = {}
    for name, sec in named:
        idle_by_span[name] = idle_by_span.get(name, 0.0) + sec
    ops = sorted(((name, us / 1e6) for name, (_, us) in by_name.items()), key=lambda o: -o[1])
    return dict(busy_s=busy_us / 1e6, window_s=window_s,
                kernel_records={name: cnt for name, (cnt, _) in by_name.items()},
                kernel_seconds={name: us / 1e6 for name, (_, us) in by_name.items()},
                device_ops=[[name[:120], sec] for name, sec in ops[:10]],
                idle_gaps=[[name, sec] for name, sec in named[:10]],
                idle_by_span=idle_by_span)


def records_of(summary, kernel):
    return sum(c for name, c in summary['kernel_records'].items() if kernel in name)


def seconds_of(summary, kernel):
    return sum(s for name, s in summary['kernel_seconds'].items() if kernel in name)


def profile_steps(step_fn, count, kernels, counters, tries=3):
    """Trace ``count`` steps (``step_fn()`` returns a step's record and
    answers); again, with the next steps, while a kernel of ``kernels``
    ({name: (module, counter)}) has fewer records than launches.  Returns
    the summary of the accepted trace, its counters' deltas, its steps'
    answers, and the records of every traced step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    records = []
    for attempt in range(tries):
        torch.cuda.synchronize()
        c0 = counter_values(counters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = [step_fn() for _ in range(count)]
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        records += steps
        dc = delta(counter_values(counters), c0)
        summary = summarize(prof.events(), window_s)
        short = {k: (records_of(summary, k), dc[f'{mod}:{attr}'])
                 for k, (mod, attr) in kernels.items()
                 if records_of(summary, k) < dc[f'{mod}:{attr}']}
        if summary['busy_s'] > 0 and not short:
            summary.update(counters=dc, answers=[a for _, a in steps], steps=count,
                           records=records, tries=attempt + 1)
            return summary
        print(f'trace: records short of launches {short} (busy {summary["busy_s"]} s); '
              'tracing the next steps', file=sys.stderr, flush=True)
    raise TraceError(f'the profiler dropped kernel records or recorded no device time in '
                     f'each of {tries} traces')

