"""The multi-device package across processes on the CPU: a mesh over a gloo
process group (``osqp_tpu_torch.parallel.distributed``) against the
one-process mesh of the same shape, and the two-process banded solve against
``osqp_tpu.parallel.banded_qp_solve`` on a 4-device CPU JAX mesh.

Workers are separate processes (``tests/torch_mesh_worker.py``), started
with a ``FileStore`` under the test's temporary directory, one torch thread
each, a 60 s group timeout and a wall limit past which the test kills them.
A worker's results must equal the one-process mesh's bit for bit: the
process mesh gathers the parts it needs and reduces them in shard order.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import torch_mesh_worker as worker
from osqp_tpu.parallel import banded as jbanded
from osqp_tpu_torch import parallel as par
from osqp_tpu_torch.parallel import distributed
from osqp_tpu_torch.parallel.mesh import Mesh, Parts

WALL_S = 240.0  # each launch's wall limit
MESHES = {'1d': ((4,), ('mp',)), '2d': ((2, 2), ('dp', 'mp'))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test, as in the workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def collectives(tmp_path_factory):
    """Each rank's collective outputs, at 2 processes x 2 shards and at
    4 processes x 1 shard."""
    return {world: worker.launch('collectives', world, tmp_path_factory.mktemp(f'c{world}'),
                                 wall_s=WALL_S, device='cpu', timeout_s=60)
            for world in (2, 4)}


@pytest.fixture(scope='module')
def solvers(tmp_path_factory):
    return worker.launch('solvers', 2, tmp_path_factory.mktemp('solvers'), wall_s=WALL_S,
                         device='cpu', timeout_s=60)


@pytest.fixture(scope='module')
def solvers_one_process():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return worker.solver_outputs(lambda shape, axes: par.make_mesh(shape, axes,
                                                                      device='cpu'), 'cpu')
    finally:
        torch.set_num_threads(threads)


def _same_bits(a, b):
    """Equal dtype, shape and bits (NaN where NaN)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _assert_same(got, want, what):
    if isinstance(want, torch.Tensor):
        assert _same_bits(got, want), what
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f'{what}[{k}]')
    else:
        assert got == want, what


# ---------------------------------------------------------------------------
# The collectives, bit for bit against the one-process mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('name', sorted(MESHES))
def test_collectives_match_one_process(collectives, world, name):
    """psum, pmax, all_gather (cut and not), halo_window (W = 1, 3 and the
    whole shard), split, join and the any-flag over every axis and all of
    them: each process's shards get the one-process mesh's values for
    those shards, bit for bit (a NaN included), and join the global tensor
    on every process.  At 2 x 2 the 1-D mesh's halos and reductions cross
    the process boundary, and the (dp, mp) mesh's dp axis does while its mp
    axis stays inside a process; at 4 x 1 every axis crosses."""
    shape, axes = MESHES[name]
    want = worker.collective_outputs(par.make_mesh(shape, axes, device='cpu'))
    per = 4 // world
    for rank, out in enumerate(collectives[world]):
        got = out[name]
        assert sorted(got) == sorted(want)
        for key, (kind, value) in want.items():
            assert got[key][0] == kind, key
            if kind == 'parts':
                value = value[rank * per:(rank + 1) * per]
            _assert_same(got[key][1], value, f'rank {rank}: {key}')


def test_mesh_that_does_not_split_over_the_processes_raises(collectives):
    for world, outs in collectives.items():
        for out in outs:
            assert out['indivisible'] == (f'a mesh of {world + 1} shards does not split over '
                                          f'{world} processes')


def test_halo_window_crosses_the_process_boundary(collectives):
    """The 1-D mesh over two processes (shards 0, 1 on rank 0; 2, 3 on
    rank 1): shard 1's right halo is shard 2's head and shard 2's left halo
    is shard 1's tail; the ends of the mesh get zeros."""
    L, W = 4, 3
    glob = np.arange(1.0, 4 * L + 1)
    padded = np.concatenate([np.zeros(W), glob, np.zeros(W)])
    for rank, out in enumerate(collectives[2]):
        wins = out['1d'][f'halo{W}/mp'][1]
        for k, win in enumerate(wins):
            j = 2 * rank + k
            np.testing.assert_array_equal(win.numpy(), padded[j * L:j * L + L + 2 * W])


# ---------------------------------------------------------------------------
# The solvers, bit for bit against the one-process mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('which', ['banded', 'bigqp', 'rollout', 'dp_mp'])
def test_solver_matches_one_process(solvers, solvers_one_process, which):
    """banded_qp_solve, big_qp_solve and a 3-step banded_mpc_rollout at
    J = 4 (n = 64), and dp_mp_solve at (2, 2) with dp across the two
    processes, f64: every field of every process's result, x, y, z,
    residuals, certificates and carries, the one-process mesh's bit for
    bit; statuses, iterations, rho updates, CG steps and host syncs
    equal."""
    want = solvers_one_process[which]
    for field in ('status', 'iters', 'host_syncs'):
        assert field in want
    for rank, out in enumerate(solvers):
        _assert_same(out[which], want, f'rank {rank}: {which}')
    status = want['status']
    assert (torch.as_tensor(status) == 1).all()


def test_two_processes_match_jax_package(tmp_path):
    """The two-process banded_qp_solve (n = 4,096, J = 4, 2 shards a
    process), started from the JAX package's setup through
    ``from_jax_banded``, against ``osqp_tpu.parallel.banded_qp_solve`` on
    a 4-device CPU mesh: status, iterations and rho updates equal, x and y
    within 1e-8 on both processes."""
    P, q, A, l, u = worker.banded_qp(4096, seed=5)
    jd = jbanded.banded_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
    with jax.default_device(jax.devices('cpu')[0]):
        want = jbanded.banded_qp_solve(JaxMesh(np.array(jax.devices('cpu')[:4]), ('mp',)), jd,
                                       **worker.KW)
    np.savez(tmp_path / 'setup.npz', **{k: np.asarray(v) for k, v in jd._asdict().items()})
    outs = worker.launch('banded_data', 2, tmp_path, wall_s=WALL_S, device='cpu', timeout_s=60,
                         data=tmp_path / 'setup.npz')
    assert int(want.status) == 1
    for got in outs:
        assert got['status'] == int(want.status)
        assert got['iters'] == int(want.iters)
        assert got['rho_updates'] == int(want.rho_updates)
        np.testing.assert_allclose(got['x'].numpy(), np.asarray(want.x), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got['y'].numpy(), np.asarray(want.y), rtol=0, atol=1e-8)
    _assert_same(outs[1], outs[0], 'rank 1 against rank 0')


# ---------------------------------------------------------------------------
# Failures that must be loud
# ---------------------------------------------------------------------------


def test_process_mesh_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='initialize'):
        par.make_mesh((4,), ('mp',), device='cpu', group='world')
    with pytest.raises(RuntimeError, match='initialize'):
        Mesh(np.array(['cpu'] * 4, dtype=object), ('mp',), group='world')
    assert (par.process_index(), par.process_count()) == (0, 1)


def test_nccl_without_cuda_raises(tmp_path, monkeypatch):
    """'nccl' moves CUDA tensors only: initialize raises where CUDA is
    absent, and a mesh on the CPU over an NCCL group raises too (the
    group's backend read as NCCL), each naming gloo; nothing falls back."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        par.initialize('nccl', init_method=f'file://{tmp_path}/store', rank=0, world_size=1)
    assert not torch.distributed.is_initialized()
    par.initialize('gloo', init_method=f'file://{tmp_path}/store2', rank=0, world_size=1,
                   timeout_s=30)
    try:
        monkeypatch.setattr(distributed.dist, 'get_backend', lambda group=None: 'nccl')
        with pytest.raises(ValueError, match="backend='gloo'"):
            par.make_mesh((2,), ('mp',), device='cpu', group='world')
    finally:
        par.shutdown()
    with pytest.raises(ValueError, match='backend must be one of'):
        par.initialize('mpi', init_method=f'file://{tmp_path}/store3', rank=0, world_size=1)


def test_initialize_reads_torchrun_environment(monkeypatch):
    """RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT as torchrun sets
    them: a world of one, whose mesh holds every shard and computes the
    one-process mesh's psum."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK='0', WORLD_SIZE='1', MASTER_ADDR='localhost',
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    par.initialize('gloo', timeout_s=30)
    try:
        assert (par.process_index(), par.process_count()) == (0, 1)
        for group in ('world', torch.distributed.group.WORLD):
            mesh = par.make_mesh((2,), ('mp',), device='cpu', group=group)
            assert mesh.local == (0, 1)
            parts = Parts([torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])])
            assert [t.tolist() for t in mesh.psum(parts)] == [[4.0, 6.0]] * 2
        with pytest.raises(RuntimeError, match='already initialized'):
            par.initialize('gloo', timeout_s=30)
    finally:
        par.shutdown()
    assert not torch.distributed.is_initialized()


def test_dead_worker_fails_the_launch(tmp_path):
    """A worker that dies while the other waits for it in a collective
    fails the launch at once, not at the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='worker 1 exited with 3'):
        worker.launch('die', 2, tmp_path, wall_s=WALL_S, device='cpu', timeout_s=60)
    assert time.monotonic() - t0 < 50


def test_hung_workers_are_killed_at_the_wall_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='still running after 8.0 s'):
        worker.launch('hang', 2, tmp_path, wall_s=8.0, device='cpu', timeout_s=60)
    assert time.monotonic() - t0 < 40
    for rank in range(2):
        pid_file = tmp_path / f'rank{rank}.pid'
        if pid_file.exists():  # the worker reached its sleep
            with pytest.raises(ProcessLookupError):
                os.kill(int(pid_file.read_text()), 0)
