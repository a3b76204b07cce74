"""A device mesh, in one process or over several, and its collectives.

Counterpart of ``jax.sharding.Mesh`` and of the collectives the JAX
package's ``shard_map`` bodies call: ``lax.psum``, ``lax.pmax``,
``lax.all_gather(tiled=True)`` and ``lax.ppermute`` as a halo exchange.

A mesh holds one device per shard, and a sharded value is a ``Parts``: one
tensor per shard, on that shard's device, in the mesh's (row-major) order.
Devices may repeat (four shards on ``cuda:0``, or on ``'cpu'``), so every
exchange of the distributed solvers runs, and is tested, on a one-card
machine and on the CPU; on a host with several cards the same mesh spreads
over them.

In one process (``group=None``) the mesh holds every shard, as ``shard_map``
does on one host.  Over a process group (``make_mesh(..., group='world')``,
after ``distributed.initialize``) the flat shard order is process-major:
process r holds the contiguous block of ``size / world`` shards from
``r * size / world`` on, as ``jax.devices()`` orders a multi-process mesh
by process, and a ``Parts`` holds this process's shards only (JAX's
addressable shards).  ``Mesh.local`` names their global indices; ``groups``
and ``coords`` speak of global indices, ``device_list`` and a ``Parts`` of
local positions.  A collective gathers what it needs from the other
processes, then computes as the one-process mesh does, in shard order, so
every process gets the one-process mesh's values bit for bit, and the
replicas of a value are bit-identical on every process: each process's
host reads its own (``read``) and all take the same branches.

Every collective returns fresh tensors: no two shards ever share storage,
also where they share a device.  A tensor on another device than its
shard's raises, so a mesh on the card never falls back to the CPU.
"""

from __future__ import annotations

import itertools
import operator
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import Transport, resolve_group


class Parts(tuple):
    """One value per shard, in mesh order.

    Arithmetic, comparisons (``==`` too) and ``@`` apply shard by shard; an
    operand that is not a ``Parts`` (a host scalar, a shared constant) is
    used as is on every shard.  Indexing and iteration are the tuple's."""

    __slots__ = ()
    __array_ufunc__ = None  # numpy scalars defer to the reflected operators

    def map(self, fn, *others):
        return each(fn, self, *others)


def each(fn, *args):
    """``fn`` applied shard by shard: the Parts among ``args`` give each
    shard its own argument, every other argument is passed as is."""
    size = next(len(a) for a in args if isinstance(a, Parts))
    cols = [a if isinstance(a, Parts) else itertools.repeat(a, size) for a in args]
    if any(isinstance(a, Parts) and len(a) != size for a in args):
        raise ValueError('Parts of different lengths')
    return Parts(fn(*row) for row in zip(*cols))


def _binary(fn):
    return lambda self, other: each(fn, self, other)


def _reflected(fn):
    return lambda self, other: each(lambda a, b: fn(b, a), self, other)


for _name, _fn in (('add', operator.add), ('sub', operator.sub), ('mul', operator.mul),
                   ('truediv', operator.truediv), ('matmul', operator.matmul),
                   ('and', operator.and_), ('or', operator.or_)):
    setattr(Parts, f'__{_name}__', _binary(_fn))
    setattr(Parts, f'__r{_name}__', _reflected(_fn))
for _name, _fn in (('lt', operator.lt), ('le', operator.le), ('gt', operator.gt),
                   ('ge', operator.ge), ('eq', operator.eq), ('ne', operator.ne)):
    setattr(Parts, f'__{_name}__', _binary(_fn))
Parts.__neg__ = lambda self: each(operator.neg, self)
Parts.__invert__ = lambda self: each(operator.invert, self)
Parts.__hash__ = object.__hash__


def _normalize(device) -> torch.device:
    d = torch.device(device)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


class Mesh:
    """Shards laid out on devices: ``devices`` is an array of devices (or
    device strings) shaped like the mesh, one axis per name in
    ``axis_names``.  ``mesh.shape[axis]`` is the axis' size, as in JAX.

    With a process ``group`` (``'world'`` or a ``torch.distributed``
    ``ProcessGroup``) the mesh spans the group's processes: this process
    holds the process-major block ``local`` of the shards, all on one
    device, and the other entries of ``devices`` (another process's cards,
    unknown here) are ignored and kept as ``None``."""

    def __init__(self, devices, axis_names, group=None):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f'{len(axis_names)} axis names for a {arr.ndim}-D device array')
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f'axis names repeat: {axis_names}')
        self.size = int(arr.size)
        if not self.size:
            raise ValueError('a mesh needs at least one device')
        world, rank = 1, 0
        if group is not None:
            group = resolve_group(group)
            world, rank = dist.get_world_size(group), dist.get_rank(group)
        if self.size % world:
            raise ValueError(f'a mesh of {self.size} shards does not split over {world} '
                             'processes')
        per = self.size // world
        # global indices of this process's shards
        self.local = tuple(range(rank * per, (rank + 1) * per))
        self._first = rank * per
        flat = arr.reshape(-1)
        self.device_list = [_normalize(flat[i]) for i in self.local]
        kinds = {d.type for d in self.device_list}
        if len(kinds) != 1:
            raise ValueError(f'a mesh holds devices of one type, got {sorted(kinds)}')
        self.device_type = kinds.pop()
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in zip(self.local, self.device_list):
            self.devices.flat[i] = d
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.transport = None
        if group is not None:
            if len(set(self.device_list)) != 1:
                raise ValueError('the shards of one process of a mesh share one device, got '
                                 f'{[str(d) for d in self.device_list]}')
            self.transport = Transport(group, self.device_list[0])
        self._memo = {}
        self._groups = {}
        self._spanning = {}

    def __repr__(self):
        procs = '' if self.transport is None else \
            f', process {self.transport.rank} of {self.transport.world}'
        return f'Mesh({self.shape}, devices={[str(d) for d in self.device_list]}{procs})'

    # -- layout -------------------------------------------------------------

    def _axis_pos(self, axis):
        if axis not in self.shape:
            raise ValueError(f'no axis {axis!r} in mesh axes {self.axis_names}')
        return self.axis_names.index(axis)

    def groups(self, axis=None):
        """The shards that a collective over ``axis`` joins: a list of
        groups, each the flat (global) shard indices along ``axis`` in
        order, one group for each position on the other axes.  ``None`` is
        every axis: one group of all shards."""
        if axis not in self._groups:
            idx = np.arange(self.size).reshape(self.devices.shape)
            if axis is None:
                self._groups[axis] = [[int(i) for i in idx.reshape(-1)]]
            else:
                moved = np.moveaxis(idx, self._axis_pos(axis), -1)
                self._groups[axis] = [[int(i) for i in g]
                                      for g in moved.reshape(-1, self.shape[axis])]
        return self._groups[axis]

    def coords(self, i):
        """The mesh coordinates of flat (global) shard ``i``, by axis name."""
        return dict(zip(self.axis_names, np.unravel_index(i, self.devices.shape)))

    def is_local(self, i):
        """Whether global shard ``i`` is one of this process's."""
        return self._first <= i < self._first + len(self.local)

    def representatives(self, axis=None):
        """Positions in this process's Parts of one shard of each group
        over ``axis`` that has a shard here (the group's first one here)."""
        return [next(i for i in g if self.is_local(i)) - self._first
                for g in self.groups(axis) if any(self.is_local(i) for i in g)]

    def check(self, t: torch.Tensor):
        """Raise unless ``t`` lies on this mesh's type of device."""
        if t.device.type != self.device_type:
            raise ValueError(f'a tensor on {t.device} given to a mesh on '
                             f'{self.device_type} devices')
        return t

    def _check_parts(self, parts):
        if len(parts) != len(self.local):
            raise ValueError(f'{len(parts)} parts for the {len(self.local)} shards this '
                             f'process holds of a mesh of {self.size}')
        for i, t, d in zip(self.local, parts, self.device_list):
            if t.device != d:
                raise ValueError(f'shard {i} is on {t.device}, the mesh puts it on {d}')

    def split(self, t, spec=()):
        """Distribute ``t`` over the shards as ``PartitionSpec(*spec)``
        would: dimension ``k`` of ``t`` is cut into equal blocks along the
        mesh axis ``spec[k]`` (``None``: not cut); axes that ``spec`` does
        not name replicate.  Each shard of this process gets its own copy
        of its block on its device (every process passes the global
        ``t``)."""
        t = self.check(torch.as_tensor(t)) if isinstance(t, torch.Tensor) else \
            torch.as_tensor(np.asarray(t), device=self.device_list[0])
        named = [(k, a) for k, a in enumerate(spec) if a is not None]
        for k, a in named:
            if t.shape[k] % self.shape[a]:
                raise ValueError(f'dimension {k} of size {t.shape[k]} does not split '
                                 f'over the {self.shape[a]} shards of axis {a!r}')
        parts = []
        for i, d in zip(self.local, self.device_list):
            c = self.coords(i)
            idx = [slice(None)] * t.dim()
            for k, a in named:
                blk = t.shape[k] // self.shape[a]
                idx[k] = slice(c[a] * blk, (c[a] + 1) * blk)
            parts.append(t[tuple(idx)].to(d, copy=True).contiguous())
        return Parts(parts)

    def shards(self, t, axis):
        """Shard ``j`` along ``axis`` gets ``t[j]``: the leading axis of ``t``
        holds one entry per shard (the JAX package's ``(J, ...)`` data with
        ``PartitionSpec(axis)``, each block without its unit axis)."""
        return self.split(t, (axis,)).map(lambda v: v[0])

    def memo(self, keys, build):
        """``build()``, computed once for this mesh and the tensors ``keys``
        and kept while they live (state derived from data, such as a solve's
        local operators)."""
        key = tuple(id(k) for k in keys)
        hit = self._memo.get(key)
        if hit is not None and all(r() is k for r, k in zip(hit[0], keys)):
            return hit[1]
        value = build()
        self._memo[key] = ([weakref.ref(k) for k in keys], value)
        weakref.finalize(keys[0], self._memo.pop, key, None)
        return value

    def _spans(self, axis):
        """Whether a group over ``axis`` holds shards of two processes:
        decided from the layout alone, the same on every process."""
        if axis not in self._spanning:
            per = len(self.local)
            self._spanning[axis] = self.transport is not None and any(
                g[0] // per != g[-1] // per for g in self.groups(axis))
        return self._spanning[axis]

    def _everyone(self, parts):
        """Global shard index -> its part: this process's parts, and over
        processes every shard's, gathered (one ``all_gather``, onto this
        process's device)."""
        self._check_parts(parts)
        if self.transport is None:
            return lambda i: parts[i]
        if len({(t.shape, t.dtype) for t in parts}) != 1:
            raise ValueError('a collective over processes takes parts of one shape and dtype')
        full = self.transport.gather(torch.stack(tuple(parts)).reshape(len(parts), -1))
        full = full.reshape(self.size, *parts[0].shape)
        return lambda i: full[i]

    def _sources(self, parts, axis):
        """Global shard index -> its part, for the groups over ``axis`` that
        hold a shard of this process: a gather only where a group spans
        processes."""
        if self._spans(axis):
            return self._everyone(parts)
        self._check_parts(parts)
        return lambda i: parts[i - self._first]

    def _device_of(self, i):
        """Global shard ``i``'s device if it is this process's, else the
        device this process computes the other shards' values on."""
        return self.device_list[i - self._first] if self.is_local(i) else self.device_list[0]

    def join(self, parts, spec=(), device=None):
        """The global tensor of ``parts`` laid out as ``spec`` (the inverse
        of ``split``), on ``device`` (the first shard's by default): blocks
        along the named axes are concatenated, an axis that ``spec`` does
        not name is read from its first shard.  Over processes every
        process gets the global tensor, for one gather of every shard."""
        src = self._everyone(parts)
        device = self.device_list[0] if device is None else torch.device(device)
        named = [(k, a) for k, a in enumerate(spec) if a is not None]

        def rec(pos, level):
            if level == len(named):
                flat = np.ravel_multi_index(
                    tuple(pos.get(a, 0) for a in self.axis_names), self.devices.shape)
                return src(int(flat)).to(device)
            k, a = named[level]
            return torch.cat([rec({**pos, a: i}, level + 1) for i in range(self.shape[a])],
                             dim=k)

        out = rec({}, 0)
        return out.clone() if out._base is not None or any(out is p for p in parts) else out

    # -- collectives --------------------------------------------------------

    def _mine(self, axis):
        """The groups over ``axis`` that hold a shard of this process."""
        return [g for g in self.groups(axis) if any(self.is_local(i) for i in g)]

    def _reduce(self, parts, axis, fn):
        src = self._sources(parts, axis)
        out = [None] * len(self.local)
        for g in self._mine(axis):
            acc = src(g[0]).to(self._device_of(g[0]))
            for i in g[1:]:
                acc = fn(acc, src(i).to(acc.device))
            first = True
            for i in g:
                if self.is_local(i):
                    fresh = first and len(g) > 1
                    out[i - self._first] = acc if fresh else acc.to(self._device_of(i), copy=True)
                    first = False
        return Parts(out)

    def psum(self, parts, axis=None):
        """``lax.psum``: the sum over the group, added in shard order and
        copied to every shard of it, so the replicas are bit-identical."""
        return self._reduce(parts, axis, torch.add)

    def pmax(self, parts, axis=None):
        """``lax.pmax`` (a NaN anywhere in the group gives NaN)."""
        return self._reduce(parts, axis, torch.maximum)

    def all_gather(self, parts, axis=None, size=None):
        """``lax.all_gather(tiled=True)``: the group's parts concatenated
        along their first dimension in shard order, cut to its first
        ``size`` rows, on every shard of the group."""
        src = self._sources(parts, axis)
        out = [None] * len(self.local)
        for g in self._mine(axis):
            d0 = self._device_of(g[0])
            full = torch.cat([src(i).to(d0) for i in g])
            if size is not None:
                full = full[:size]
            first = True
            for i in g:
                if self.is_local(i):
                    out[i - self._first] = full if first else full.to(self._device_of(i),
                                                                      copy=True)
                    first = False
        return Parts(out)

    def halo_window(self, parts, W, axis=None):
        """Each shard's ``(L + 2W,)`` window: its left neighbour's last ``W``
        entries, its own ``L``, its right neighbour's first ``W``.  The ends
        of the group get zeros, which is the out-of-range convention of a
        DIA product (``lax.ppermute`` zero-fills a missing link).  Over
        processes only each shard's ``2W`` edge entries are gathered."""
        self._check_parts(parts)
        for v in parts:
            if W > v.shape[0]:
                raise ValueError(f'halo {W} wider than the shard ({v.shape[0]})')
        if self._spans(axis):
            # (first W, last W) of every shard
            edges = self._sources(Parts(torch.cat([v[:W], v[v.shape[0] - W:]]) for v in parts),
                                  axis)
            head, tail = (lambda i: edges(i)[:W]), (lambda i: edges(i)[W:])
        else:
            head = lambda i: parts[i - self._first][:W]  # noqa: E731
            tail = lambda i: parts[i - self._first][parts[i - self._first].shape[0] - W:]  # noqa: E731
        out = [None] * len(self.local)
        for g in self._mine(axis):
            for k, i in enumerate(g):
                if not self.is_local(i):
                    continue
                v = parts[i - self._first]
                d = v.device
                left = tail(g[k - 1]).to(d) if k > 0 else v.new_zeros((W,))
                right = head(g[k + 1]).to(d) if k + 1 < len(g) else v.new_zeros((W,))
                out[i - self._first] = torch.cat([left, v, right])
        return Parts(out)

    def replicate(self, t):
        """A copy of ``t`` on every shard."""
        return self.split(t, ())

    def read(self, *values):
        """Copy replicated 0-d values to the host in one transfer, each from
        this process's first shard: one host sync whatever the mesh's size,
        and no exchange between processes, whose replicas are
        bit-identical.  Returns Python floats."""
        d0 = self.device_list[0]
        vals = [(v[0] if isinstance(v, Parts) else v).to(d0, torch.float64) for v in values]
        return torch.stack(vals).cpu().tolist()

    def any(self, flags):
        """Whether any of ``flags`` (0-d bool tensors of this process's
        shards) is set on any process: one copy to the host, and over
        processes one all-reduce of one flag."""
        d0 = self.device_list[0]
        flag = torch.stack([f.to(d0) for f in flags]).any()
        return bool(flag.cpu()) if self.transport is None else self.transport.any(flag)


def make_mesh(shape, axis_names, device=None, group=None) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.  With no ``device`` the
    shards go round robin over the CUDA cards (``torch.cuda.device_count()``;
    all on ``cuda:0`` on a one-card machine), and without CUDA this raises.
    ``device='cpu'`` puts every shard on the CPU; an indexed device
    (``'cuda:1'``) puts every shard there; ``'cuda'`` spreads them over the
    cards.

    With a process ``group`` (``'world'``: the group ``distributed.
    initialize`` joined) the mesh spans its processes and this process's
    shards all sit on ``device``, by default the current CUDA card (the
    card of ``$LOCAL_RANK`` under NCCL); without CUDA and a device this
    raises.  Raises too where no process group is initialized, where the
    mesh's size does not divide by the number of processes, where NCCL is
    asked to move CPU tensors and where two NCCL ranks share a card."""
    shape = tuple(int(s) for s in (shape if np.iterable(shape) else (shape,)))
    size = int(np.prod(shape))
    arr = np.empty(size, dtype=object)
    if group is not None:
        # this process's block takes the device; the mesh ignores the rest
        arr[:] = [_normalize(resolve_device(device))] * size
        return Mesh(arr.reshape(shape), axis_names, group=group)
    dev = resolve_device(device)
    if dev.type == 'cuda' and (device is None or dev.index is None):
        count = torch.cuda.device_count()
        devs = [torch.device('cuda', i % count) for i in range(size)]
    else:
        devs = [dev] * size
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)
