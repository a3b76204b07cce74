"""Spans inside the port: where the host's time goes in ``setup``, ``update``
and ``solve``.

A span is a named interval on the host clock (``time.perf_counter_ns``),
opened with ``with span(name):`` where the work happens.  Spans nest: each
knows its parent, and its self time is its time less what its child spans
cover.  On exit a span adds to three integer counters, ``<key>_calls``,
``<key>_ns`` and ``<key>_self_ns``, where ``<key>`` is the
span's name with ``.`` as ``_`` (``solve.loop`` counts into
``solve_loop_ns``).  A ``sync`` span (the host blocked on the card: a copy
between host and device memory, or a value the host reads) also counts the
bytes it copies, ``h2d_bytes`` and ``d2h_bytes``, and, inside a
``solve.loop`` span, ``sync_loop_calls`` and ``sync_loop_ns``.  A ``stage``
span (a host pass that casts vectors into one host buffer, and the enqueue
of the buffer's copy to the device, which does not wait) counts the bytes it
sends in ``h2d_bytes`` too.  The copies through pinned staging (that one,
and the answer's one copy back) count also in ``pinned_h2d_bytes`` and
``pinned_d2h_bytes``, on the CPU as on the card.  The counters only grow;
read them as attributes of this module, ``getattr(tracing, name)`` (or all
of them through ``counters()``), before and after the work to be measured.

========================  ==================================================
span                      covers
========================  ==================================================
``setup``                 the whole ``setup`` call of ``OSQP``, ``BatchedOSQP``
``setup.scale``           the Ruiz equilibration of ``setup``
``ldl.symbolic``          the 'ldl' algebra's host analysis and the pattern's
                          copies to the device (``ops.ldl.LDLFactor``)
``ldl.factor``            a numeric LDL' factorization: the KKT values'
                          gather, K5 and its pivot read
``kernel.load``           the first load of a compiled library in the
                          process: its build where none is cached, the dlopen
``update``                the whole ``update`` call: ingest, checks, casts,
                          the copies to the device
``stage``                 ``BatchedOSQP``'s cast of the vectors of an
                          ``update`` or ``warm_start`` into one host buffer,
                          and the enqueue of its copy to the device
``solve``                 the whole ``solve`` call, up to the answer on the host
``solve.loop``            the ADMM loop of a solve (its epochs, checks, rho
                          adaptation, the shared engine's compaction)
``rho.update``            a new rho: its refactorization (and the shared
                          engine's new iteration map)
``sync``                  one wait of the host for the card
========================  ==================================================

A span does no device operation and no synchronisation: two reads of the
clock and a few integer additions.  Inside ``annotate()`` each span is also
a ``torch.profiler.record_function`` named ``osqp.<name>``, so a profile of
the caller's own loop shows the solver's phases on the kernels' clock.  Each
thread keeps its own nesting and counts; a counter read is the sum over the
process's threads.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from threading import get_ident
from time import perf_counter_ns

SPANS = ('setup', 'setup.scale', 'ldl.symbolic', 'ldl.factor', 'kernel.load', 'update',
         'stage', 'solve', 'solve.loop', 'rho.update', 'sync')

# each span's three counters sit at 3 i, 3 i + 1, 3 i + 2 of a thread's list
COUNTERS = tuple(f"{name.replace('.', '_')}_{what}" for name in SPANS
                 for what in ('calls', 'ns', 'self_ns'))
COUNTERS += ('sync_loop_calls', 'sync_loop_ns', 'h2d_bytes', 'd2h_bytes', 'pinned_h2d_bytes',
             'pinned_d2h_bytes')
_INDEX = {k: i for i, k in enumerate(COUNTERS)}
_BASE = {name: 3 * i for i, name in enumerate(SPANS)}
_SYNC = _BASE['sync']
_LOOP = _BASE['solve.loop']
_SYNC_LOOP, _SYNC_LOOP_NS = _INDEX['sync_loop_calls'], _INDEX['sync_loop_ns']
_H2D, _D2H = _INDEX['h2d_bytes'], _INDEX['d2h_bytes']
_PINNED_H2D, _PINNED_D2H = _INDEX['pinned_h2d_bytes'], _INDEX['pinned_d2h_bytes']

_lock = threading.Lock()  # guards _all, the list of every thread's counts
_all = []


class _Thread:
    """A thread's open spans and its own counts: a thread writes only its
    own list, so counting takes no lock."""

    __slots__ = ('t0', 'child', 'loop', 'annotate', 'rf', 'counts')

    def __init__(self):
        self.t0 = []  # the open spans' start times, innermost last
        self.child = [0]  # the time their child spans took, and the outside's
        self.loop = 0  # open solve.loop spans
        self.annotate = 0  # depth of annotate() blocks
        self.rf = []  # (depth, profiler range) of the open spans entered under annotate()
        self.counts = [0] * len(COUNTERS)
        with _lock:
            _all.append(self.counts)


_local = threading.local()
_MAIN = threading.get_ident()
_main = _Thread()


def _thread() -> _Thread:
    if get_ident() == _MAIN:
        return _main
    return _other()


def _other() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        _local.state = _Thread()
        return _local.state


def __getattr__(name):
    """A counter by name: its sum over every thread that has counted."""
    i = _INDEX.get(name)
    if i is None:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
    with _lock:
        return sum(c[i] for c in _all)


class _Span:
    """The span of one name; its state lives in the thread that enters it,
    so one object serves every thread and every nesting."""

    __slots__ = ('name', 'base')

    def __init__(self, name):
        self.name = name
        self.base = _BASE[name]

    def __enter__(self):
        th = _main if get_ident() == _MAIN else _other()
        if self.base == _LOOP:
            th.loop += 1
        if th.annotate:
            from torch.profiler import record_function

            rf = record_function('osqp.' + self.name)
            rf.__enter__()
            th.rf.append((len(th.t0), rf))
        th.child.append(0)
        th.t0.append(perf_counter_ns())
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = perf_counter_ns()
        th = _main if get_ident() == _MAIN else _other()
        dt = t1 - th.t0.pop()
        child = th.child
        inner = child.pop()
        child[-1] += dt
        if th.rf and th.rf[-1][0] == len(th.t0):
            th.rf.pop()[1].__exit__(exc_type, exc, tb)
        c = th.counts
        i = self.base
        c[i] += 1
        c[i + 1] += dt
        c[i + 2] += dt - inner
        if i == _SYNC:
            if th.loop:
                c[_SYNC_LOOP] += 1
                c[_SYNC_LOOP_NS] += dt
        elif i == _LOOP:
            th.loop -= 1
        return False


_SPAN = {name: _Span(name) for name in SPANS}


def span(name: str, h2d: int = 0, d2h: int = 0, pinned: bool = False) -> _Span:
    """The span named ``name`` (one of ``SPANS``), to enter with ``with``.
    ``h2d`` and ``d2h``: the bytes the span copies to and from the device;
    ``pinned``: those copies go through pinned staging."""
    if h2d or d2h:
        c = (_main if get_ident() == _MAIN else _other()).counts
        c[_H2D] += h2d
        c[_D2H] += d2h
        if pinned:
            c[_PINNED_H2D] += h2d
            c[_PINNED_D2H] += d2h
    return _SPAN[name]


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _SPAN[name]:
                return fn(*args, **kwargs)
        return call
    return wrap


def thread_syncs() -> int:
    """The ``sync`` spans closed so far in the calling thread (the
    difference over a call is that call's host syncs)."""
    return _thread().counts[_SYNC]


def counters() -> dict:
    """Every counter's value now, by name."""
    with _lock:
        return {k: sum(c[i] for c in _all) for i, k in enumerate(COUNTERS)}


@contextmanager
def annotate():
    """Inside this block (in this thread), each span is also a
    ``torch.profiler.record_function('osqp.<name>')``: under
    ``torch.profiler.profile`` the port's spans appear beside the kernels,
    and with CUDA activity on the device's timeline too."""
    th = _thread()
    th.annotate += 1
    try:
        yield
    finally:
        th.annotate -= 1
