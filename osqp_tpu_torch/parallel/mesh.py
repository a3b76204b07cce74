"""A single-process device mesh and its collectives.

Counterpart of ``jax.sharding.Mesh`` and of the collectives the JAX
package's ``shard_map`` bodies call: ``lax.psum``, ``lax.pmax``,
``lax.all_gather(tiled=True)`` and ``lax.ppermute`` as a halo exchange.

JAX runs every shard of a ``shard_map`` in one process; so does this mesh.
It holds one device per shard, and a sharded value is a ``Parts``: one
tensor per shard, on that shard's device, in the mesh's (row-major) order.
Devices may repeat (four shards on ``cuda:0``, or on ``'cpu'``), so every
exchange of the distributed solvers runs, and is tested, on a one-card
machine and on the CPU; on a host with several cards the same mesh spreads
over them.  There is no process group and no ``torch.distributed``.

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

from ..device import resolve_device


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
    ``axis_names``.  ``mesh.shape[axis]`` is the axis' size, as in JAX."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f'{len(axis_names)} axis names for a {arr.ndim}-D device array')
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f'axis names repeat: {axis_names}')
        self.device_list = [_normalize(d) for d in arr.reshape(-1)]
        if not self.device_list:
            raise ValueError('a mesh needs at least one device')
        kinds = {d.type for d in self.device_list}
        if len(kinds) != 1:
            raise ValueError(f'a mesh holds devices of one type, got {sorted(kinds)}')
        self.device_type = kinds.pop()
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(self.device_list):
            self.devices.flat[i] = d
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.size = len(self.device_list)
        self._memo = {}
        self._groups = {}

    def __repr__(self):
        return f'Mesh({self.shape}, devices={[str(d) for d in self.device_list]})'

    # -- layout -------------------------------------------------------------

    def _axis_pos(self, axis):
        if axis not in self.shape:
            raise ValueError(f'no axis {axis!r} in mesh axes {self.axis_names}')
        return self.axis_names.index(axis)

    def groups(self, axis=None):
        """The shards that a collective over ``axis`` joins: a list of
        groups, each the flat shard indices along ``axis`` in order, one
        group for each position on the other axes.  ``None`` is every
        axis: one group of all shards."""
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
        """The mesh coordinates of flat shard ``i``, by axis name."""
        return dict(zip(self.axis_names, np.unravel_index(i, self.devices.shape)))

    def check(self, t: torch.Tensor):
        """Raise unless ``t`` lies on this mesh's type of device."""
        if t.device.type != self.device_type:
            raise ValueError(f'a tensor on {t.device} given to a mesh on '
                             f'{self.device_type} devices')
        return t

    def _check_parts(self, parts):
        if len(parts) != self.size:
            raise ValueError(f'{len(parts)} parts for a mesh of {self.size} shards')
        for j, (t, d) in enumerate(zip(parts, self.device_list)):
            if t.device != d:
                raise ValueError(f'shard {j} is on {t.device}, the mesh puts it on {d}')

    def split(self, t, spec=()):
        """Distribute ``t`` over the shards as ``PartitionSpec(*spec)``
        would: dimension ``k`` of ``t`` is cut into equal blocks along the
        mesh axis ``spec[k]`` (``None``: not cut); axes that ``spec`` does
        not name replicate.  Each shard gets its own copy on its device."""
        t = self.check(torch.as_tensor(t)) if isinstance(t, torch.Tensor) else \
            torch.as_tensor(np.asarray(t), device=self.device_list[0])
        named = [(k, a) for k, a in enumerate(spec) if a is not None]
        for k, a in named:
            if t.shape[k] % self.shape[a]:
                raise ValueError(f'dimension {k} of size {t.shape[k]} does not split '
                                 f'over the {self.shape[a]} shards of axis {a!r}')
        parts = []
        for i, d in enumerate(self.device_list):
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

    def join(self, parts, spec=(), device=None):
        """The global tensor of ``parts`` laid out as ``spec`` (the inverse
        of ``split``), on ``device`` (the first shard's by default): blocks
        along the named axes are concatenated, an axis that ``spec`` does
        not name is read from its first shard."""
        self._check_parts(parts)
        device = self.device_list[0] if device is None else torch.device(device)
        named = [(k, a) for k, a in enumerate(spec) if a is not None]

        def rec(pos, level):
            if level == len(named):
                flat = np.ravel_multi_index(
                    tuple(pos.get(a, 0) for a in self.axis_names), self.devices.shape)
                return parts[int(flat)].to(device)
            k, a = named[level]
            return torch.cat([rec({**pos, a: i}, level + 1) for i in range(self.shape[a])],
                             dim=k)

        out = rec({}, 0)
        return out.clone() if any(out is p for p in parts) else out

    # -- collectives --------------------------------------------------------

    def _reduce(self, parts, axis, fn):
        self._check_parts(parts)
        out = [None] * self.size
        for g in self.groups(axis):
            d0 = self.device_list[g[0]]
            acc = parts[g[0]]
            for i in g[1:]:
                acc = fn(acc, parts[i].to(d0))
            for k, i in enumerate(g):
                fresh = k == 0 and len(g) > 1
                out[i] = acc if fresh else acc.to(self.device_list[i], copy=True)
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
        self._check_parts(parts)
        out = [None] * self.size
        for g in self.groups(axis):
            d0 = self.device_list[g[0]]
            full = torch.cat([parts[i].to(d0) for i in g])
            if size is not None:
                full = full[:size]
            for k, i in enumerate(g):
                out[i] = full if k == 0 else full.to(self.device_list[i], copy=True)
        return Parts(out)

    def halo_window(self, parts, W, axis=None):
        """Each shard's ``(L + 2W,)`` window: its left neighbour's last ``W``
        entries, its own ``L``, its right neighbour's first ``W``.  The ends
        of the group get zeros, which is the out-of-range convention of a
        DIA product (``lax.ppermute`` zero-fills a missing link)."""
        self._check_parts(parts)
        out = [None] * self.size
        for g in self.groups(axis):
            for k, i in enumerate(g):
                v = parts[i]
                if W > v.shape[0]:
                    raise ValueError(f'halo {W} wider than the shard ({v.shape[0]})')
                d = self.device_list[i]
                left = parts[g[k - 1]][v.shape[0] - W:].to(d) if k > 0 else v.new_zeros((W,))
                right = parts[g[k + 1]][:W].to(d) if k + 1 < len(g) else v.new_zeros((W,))
                out[i] = torch.cat([left, v, right])
        return Parts(out)

    def replicate(self, t):
        """A copy of ``t`` on every shard."""
        return self.split(t, ())

    def read(self, *values):
        """Copy replicated 0-d values to the host in one transfer, each from
        its first shard: one host sync whatever the mesh's size.  Returns
        Python floats."""
        d0 = self.device_list[0]
        vals = [(v[0] if isinstance(v, Parts) else v).to(d0, torch.float64) for v in values]
        return torch.stack(vals).cpu().tolist()


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.  With no ``device`` the
    shards go round robin over the CUDA cards (``torch.cuda.device_count()``;
    all on ``cuda:0`` on a one-card machine), and without CUDA this raises.
    ``device='cpu'`` puts every shard on the CPU; an indexed device
    (``'cuda:1'``) puts every shard there; ``'cuda'`` spreads them over the
    cards."""
    shape = tuple(int(s) for s in (shape if np.iterable(shape) else (shape,)))
    size = int(np.prod(shape))
    dev = resolve_device(device)
    if dev.type == 'cuda' and (device is None or dev.index is None):
        count = torch.cuda.device_count()
        devs = [torch.device('cuda', i % count) for i in range(size)]
    else:
        devs = [dev] * size
    arr = np.empty(size, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)
