"""The multi-device package across processes on the card: two gloo processes
sharing ``cuda:0`` against the one-process card mesh, one NCCL process per
card, and NCCL asked for two ranks on one card.

The card tests need an NVIDIA GPU with nvcc and skip elsewhere.  Nothing
here imports JAX or the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_procs_cuda.py
"""

import pytest
import torch

import torch_mesh_worker as worker
from osqp_tpu_torch import parallel as par

N = 4096
WALL_S = 300.0


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _one_process(shards, device):
    P, q, A, l, u = worker.banded_qp(N, seed=1)
    mesh = par.make_mesh((shards,), ('mp',), device=device)
    data = par.banded_qp_setup(P, q, A, l, u, shards, device=device)
    return worker._result(par.banded_qp_solve(mesh, data, **worker.KW))


@pytest.mark.cuda
def test_two_gloo_processes_on_one_card_match_one_process(tmp_path):
    """Two gloo processes with two shards each on ``cuda:0`` (the halo
    windows and reductions of the middle cross the processes through host
    memory): every field of both processes' banded_qp_solve at n = 4,096
    equals the one-process card mesh's bit for bit, and each process
    launched K2."""
    _needs_cuda()
    want = _one_process(4, 'cuda:0')
    outs = worker.launch('banded', 2, tmp_path, wall_s=WALL_S, device='cuda:0', timeout_s=120,
                         n=N, shards=4)
    assert want['status'] == 1
    for rank, got in enumerate(outs):
        assert got.pop('k2_launches') > 0, rank
        assert got.pop('world') == 2
        assert sorted(got) == sorted(want)
        for field, value in want.items():
            if isinstance(value, torch.Tensor):
                assert got[field].dtype == value.dtype and torch.equal(
                    got[field].reshape(-1).view(torch.uint8),
                    value.reshape(-1).view(torch.uint8)), field
            else:
                assert got[field] == value, field


@pytest.mark.cuda
def test_nccl_one_process_per_card_gives_the_counts(tmp_path):
    """One NCCL process per card (two shards each) gives the one-process
    mesh's status, iterations, rho updates, CG steps and host syncs."""
    _needs_cuda()
    world = torch.cuda.device_count()
    want = _one_process(2 * world, 'cuda')
    outs = worker.launch('banded', world, tmp_path, wall_s=WALL_S, backend='nccl',
                         device='cuda', timeout_s=120, n=N, shards=2 * world)
    for got in outs:
        assert got['world'] == world and got['k2_launches'] > 0
        for field in ('status', 'iters', 'rho_updates', 'cg_iters', 'host_syncs'):
            assert got[field] == want[field], field


@pytest.mark.cuda
def test_nccl_two_ranks_on_one_card_raises(tmp_path):
    """NCCL refuses two ranks on one card: building the mesh raises on
    both, naming gloo, before NCCL is asked; nothing switches backends."""
    _needs_cuda()
    outs = worker.launch('nccl_shared_card', 2, tmp_path, wall_s=WALL_S, backend='nccl',
                         device='cuda:0', timeout_s=60, env={'LOCAL_RANK': '0'})
    for got in outs:
        assert got['error'] is not None and "backend='gloo'" in got['error']
