"""Processes that share one mesh: the counterpart of ``jax.distributed``.

``initialize`` joins this process to a ``torch.distributed`` process group
(the default group), as ``jax.distributed.initialize`` joins a JAX process to
its cluster; ``make_mesh(..., group='world')`` then lays a mesh over every
process of it.  Importing this module starts no process group.

The backend is the caller's choice; nothing switches from one to the other:

- ``'nccl'``: CUDA tensors, one process per card (the card of ``LOCAL_RANK``,
  as ``torchrun --nproc-per-node`` starts them).  NCCL refuses two ranks on
  one card, and a mesh over such ranks raises when it is built.
- ``'gloo'``: CPU tensors, and CUDA tensors of processes that may share a
  card.  Gloo's collectives here take CPU tensors: a mesh on the card copies
  what it sends into pinned host buffers and what it receives back to the
  card, so the bytes go through host memory.

Every process group has a timeout: a collective that a process waits on for
longer raises instead of hanging.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

BACKENDS = ('gloo', 'nccl')
DEFAULT_TIMEOUT_S = 300.0


def _from_env(name, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f'{name.lower()} not given and ${name} not set (torchrun sets it)')
    return int(os.environ[name])


def initialize(backend, *, init_method=None, rank=None, world_size=None,
               timeout_s=DEFAULT_TIMEOUT_S):
    """Join this process to the default process group.

    ``rank`` and ``world_size`` default to ``$RANK`` and ``$WORLD_SIZE``,
    ``init_method`` to ``'env://'`` (``$MASTER_ADDR``, ``$MASTER_PORT``);
    ``'file://<path>'`` and ``'tcp://<host>:<port>'`` work too.  With
    ``'nccl'`` the process takes the card ``$LOCAL_RANK`` (default: its
    rank) as its current device, and raises where CUDA is absent.  Every
    collective of the group raises after ``timeout_s`` seconds of waiting."""
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got {backend!r}')
    if dist.is_initialized():
        raise RuntimeError('a process group is already initialized; call shutdown() first')
    rank = _from_env('RANK', rank)
    world_size = _from_env('WORLD_SIZE', world_size)
    if init_method is None:
        missing = [v for v in ('MASTER_ADDR', 'MASTER_PORT') if v not in os.environ]
        if missing:
            raise ValueError(f'no init_method given and ${", $".join(missing)} not set')
        init_method = 'env://'
    if backend == 'nccl':
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' moves CUDA tensors and no CUDA device is "
                               "available; backend='gloo' runs a mesh on the CPU")
        local = int(os.environ.get('LOCAL_RANK', rank))
        if not 0 <= local < torch.cuda.device_count():
            raise RuntimeError(f'LOCAL_RANK {local} names no card: {torch.cuda.device_count()} '
                               'visible')
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))


def process_index() -> int:
    """This process's rank (0 where no group is initialized)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the default group (1 where none is)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown():
    """Leave the default process group (nothing where none is)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def resolve_group(group):
    """``'world'`` is the default group; a ``ProcessGroup`` is itself.
    Raises where no process group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError('a mesh over processes needs a process group: call '
                           'osqp_tpu_torch.parallel.distributed.initialize first')
    if isinstance(group, str):
        if group != 'world':
            raise ValueError(f"group must be 'world' or a ProcessGroup, got {group!r}")
        return dist.group.WORLD
    return group


class Transport:
    """How the shards of one process reach the other processes of
    ``group``: every exchange is a gather of this process's shards,
    stacked, in rank order (NCCL: one ``all_gather``; gloo: one
    ``broadcast`` a rank)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if self.backend not in BACKENDS:
            raise ValueError(f'a mesh runs on one backend of {BACKENDS}, the group has '
                             f'{self.backend!r}')
        self.device = device
        if self.backend == 'nccl':
            if device.type != 'cuda':
                raise ValueError(f"backend 'nccl' moves CUDA tensors only, the mesh is on "
                                 f"{device}; use backend='gloo' for a mesh on the CPU")
            self._check_one_rank_per_card()
        # gloo's collectives take host tensors: a card's go through pinned buffers
        self.staged = self.backend == 'gloo' and device.type == 'cuda'

    def _check_one_rank_per_card(self):
        """NCCL refuses two ranks on one card; say so before it is asked,
        over a gloo group of the same ranks that lives for this check."""
        props = torch.cuda.get_device_properties(self.device)
        me = (socket.gethostname(), str(getattr(props, 'uuid', self.device.index)))
        side = dist.new_group(dist.get_process_group_ranks(self.group), backend='gloo',
                              use_local_synchronization=True)
        try:
            seen = [None] * self.world
            dist.all_gather_object(seen, me, group=side)
        finally:
            dist.destroy_process_group(side)
        if len(set(seen)) != len(seen):
            raise ValueError(f'NCCL needs one rank per card, and ranks share a card here '
                             f'({seen}); processes that share a card run backend=\'gloo\'')

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` (all of one shape and dtype), stacked in
        rank order: a ``(world, *t.shape)`` tensor on ``t``'s device."""
        t = t.contiguous()
        if self.backend == 'nccl':
            out = t.new_empty((self.world, *t.shape))
            dist.all_gather(list(out.unbind(0)), t, group=self.group)
            return out
        # gloo: one broadcast a rank, all posted before the first wait, so
        # gloo's worker threads move the blocks side by side: faster than its
        # all_gather at every size timed between two processes of one H100
        # host (tests/torch_gloo_exchange_time.py, PERF.md section 5)
        out = torch.empty((self.world, *t.shape), dtype=t.dtype, pin_memory=self.staged)
        out[self.rank].copy_(t)
        works = [dist.broadcast(out[r], dist.get_global_rank(self.group, r), group=self.group,
                                async_op=True) for r in range(self.world)]
        for w in works:
            w.wait()
        return out.to(t.device, non_blocking=True) if self.staged else out

    def any(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` (0-d bool) is set on any process: one copy to
        the host (before gloo's all-reduce, after NCCL's)."""
        f = flag.to('cpu' if self.backend == 'gloo' else flag.device, torch.uint8).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=self.group)
        return bool(f)
