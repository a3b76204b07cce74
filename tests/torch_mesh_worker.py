"""Processes of a mesh over ``torch.distributed``, for the tests of
``osqp_tpu_torch.parallel`` across processes
(``tests/test_torch_parallel_procs.py``, ``tests/test_torch_parallel_procs_cuda.py``).

    python tests/torch_mesh_worker.py JOB --rank R --world W --init file:///tmp/store \\
        --out DIR [--backend gloo] [--device cpu] [--timeout-s 60] [--data FILE]

runs ``JOB`` as process R of W and writes what it computed to
``DIR/rank<R>.pt``.  ``launch`` starts W of them and waits for all under a
wall limit: a worker that fails, or the limit passing, kills every worker
still running and raises.  The functions that compute a job's results
(``collective_outputs``, ``solver_outputs``) take the mesh as an argument,
so a test computes the same on a one-process mesh and compares.  Nothing
here imports JAX or the JAX package.
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sparse
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from osqp_tpu_torch import parallel as par  # noqa: E402
from osqp_tpu_torch.ops import dia_matvec as dm  # noqa: E402
from osqp_tpu_torch.parallel.mesh import Parts  # noqa: E402

F64 = torch.float64
# test_torch_parallel.py's settings with a looser CG tolerance: half the CG
# steps, each a few exchanges between the processes
KW = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000, cg_tol=1e-8)
SOLVER_N = 64
DPMP = (4, 8, 16)  # B, n, m: test_torch_parallel_dpmp.py's family


def banded_qp(n, seed=0):
    """tests/test_banded.py's family: tridiagonal P, banded A (I + two
    off-diagonals), a few equality and loose rows."""
    rng = np.random.default_rng(seed)
    P = sparse.diags([np.full(n, 2.0), np.full(n - 1, -0.7), np.full(n - 1, -0.7)],
                     [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = (sparse.eye(n) + sparse.diags([np.full(n - 2, 0.4)], [2], shape=(n, n))
         + sparse.diags([np.full(n - 1, -0.3)], [-1], shape=(n, n))).tocsc()
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    l = u - 2 * s0
    l[:3] = u[:3]
    l[3:5] = -1e30
    return P, q, A, l, u


def random_batch(B, n, m, seed=0):
    """tests/test_sharded.py's dense batch family with its bad scaling."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n))
    P = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    A *= np.logspace(-1, 1, m)[None, :, None]
    q *= 10.0
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m))
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    return P, q, A, u - 2 * s0, u


# ---------------------------------------------------------------------------
# What a job computes, on any mesh
# ---------------------------------------------------------------------------


def _local(mesh, glob):
    """This process's shards of a (size, ...) array, one part a shard."""
    return Parts(torch.as_tensor(glob[i], device=d) for i, d in zip(mesh.local, mesh.device_list))


def collective_outputs(mesh):
    """Every collective of ``mesh`` over every axis (and all of them) on
    inputs from a numpy seed: a dict of ``('parts', [this process's
    shards])`` or ``('global', tensor)``."""
    rng = np.random.default_rng(mesh.size)
    vals = rng.standard_normal((mesh.size, 5))
    vals[0, 2] = np.nan  # pmax propagates a NaN
    out = {}
    for axis in (None, *mesh.axis_names):
        tag = axis or 'all'
        parts = _local(mesh, vals)
        out[f'psum/{tag}'] = ('parts', list(mesh.psum(parts, axis)))
        out[f'pmax/{tag}'] = ('parts', list(mesh.pmax(parts, axis)))
        out[f'psum0d/{tag}'] = ('parts', list(mesh.psum(_local(mesh, vals[:, 1]), axis)))
        out[f'all_gather/{tag}'] = ('parts', list(mesh.all_gather(parts, axis)))
        out[f'all_gather_cut/{tag}'] = ('parts', list(mesh.all_gather(parts, axis, size=7)))
        L = 4
        glob = np.arange(1.0, mesh.size * L + 1).reshape(mesh.size, L)
        for W in (1, 3, 4):
            out[f'halo{W}/{tag}'] = ('parts', list(mesh.halo_window(_local(mesh, glob), W, axis)))
    # blocks of 1 MiB a shard, as well as the small ones
    big = rng.standard_normal((mesh.size, 1 << 17))
    out['psum_1MiB/all'] = ('parts', list(mesh.psum(_local(mesh, big))))
    out['all_gather_1MiB/all'] = ('parts', list(mesh.all_gather(_local(mesh, big))))
    flags = _local(mesh, np.arange(mesh.size) == mesh.size - 1)
    out['any/last'] = ('global', torch.tensor(mesh.any(list(flags))))
    out['any/none'] = ('global', torch.tensor(mesh.any([f & False for f in flags])))
    x = torch.as_tensor(rng.standard_normal((4, 8, 4)), device=mesh.device_list[0])
    specs = [(), tuple(mesh.axis_names[:1])] + \
        ([tuple(mesh.axis_names), (None, mesh.axis_names[-1])] if len(mesh.axis_names) > 1 else
         [(None, mesh.axis_names[0])])
    for spec in specs:
        blocks = mesh.split(x, spec)
        out[f'split/{spec}'] = ('parts', list(blocks))
        out[f'join/{spec}'] = ('global', mesh.join(blocks, spec))
    return out


def _result(r):
    """A solver result as a dict of tensors and ints, on the CPU."""
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in r._asdict().items()
            if v is not None}


def solver_outputs(mesh_of, device):
    """banded_qp_solve, big_qp_solve and a 3-step banded_mpc_rollout (warm
    from the banded solve) at J = 4 (n = 64), and dp_mp_solve at (2, 2),
    f64: ``mesh_of(shape, axes)`` builds each mesh."""
    n = SOLVER_N
    P, q, A, l, u = banded_qp(n, seed=7)
    mesh = mesh_of((4,), ('mp',))
    out = {}
    bd = par.banded_qp_setup(P, q, A, l, u, 4, device=device)
    cold = par.banded_qp_solve(mesh, bd, **KW)
    out['banded'] = _result(cold)
    gd = par.big_qp_setup(P, q, A, l, u, 4, device=device)
    out['bigqp'] = _result(par.big_qp_solve(mesh, gd, **KW))
    q_seq = np.stack([q * 1.01 ** k for k in range(1, 4)])
    Dinv, Einv = bd.Dinv.reshape(-1)[:n], bd.Einv.reshape(-1)[:n]
    out['rollout'] = _result(par.banded_mpc_rollout(
        mesh, bd, q_seq, x0=cold.x * Dinv, z0=cold.z, y0=cold.y * bd.c * Einv, **KW))
    B, n, m = DPMP
    out['dp_mp'] = _result(par.dp_mp_solve(mesh_of((2, 2), ('dp', 'mp')),
                                           *random_batch(B, n, m, seed=11), max_iter=1000,
                                           eps_abs=1e-5, eps_rel=1e-5))
    return out


# ---------------------------------------------------------------------------
# Jobs: one process of a group
# ---------------------------------------------------------------------------


def _process_mesh(device):
    return lambda shape, axes: par.make_mesh(shape, axes, device=device, group='world')


def job_collectives(args):
    meshes = {'1d': ((4,), ('mp',)), '2d': ((2, 2), ('dp', 'mp'))}
    out = {name: collective_outputs(par.make_mesh(shape, axes, device=args.device,
                                                  group='world'))
           for name, (shape, axes) in meshes.items()}
    # a mesh that does not split over the processes
    try:
        par.make_mesh((args.world + 1,), ('mp',), device=args.device, group='world')
    except ValueError as e:
        out['indivisible'] = str(e)
    return out


def job_solvers(args):
    return solver_outputs(_process_mesh(args.device), args.device)


def job_banded_data(args):
    """banded_qp_solve on the setup in ``--data`` (an .npz of a
    BandedQPData's fields) at J = 4."""
    from osqp_tpu_torch.convert import from_jax_banded

    with np.load(args.data) as z:
        arrays = {k: z[k] for k in z.files}
    for k in ('offsets_p', 'offsets_a', 'offsets_at'):
        arrays[k] = tuple(int(o) for o in arrays[k])
    for k in ('n', 'm', 'L'):
        arrays[k] = int(arrays[k])
    for k in ('sigma', 'rho0'):
        arrays[k] = float(arrays[k])
    arrays['rho_is_vec'] = bool(arrays['rho_is_vec'])
    data = from_jax_banded(arrays, args.device, F64)
    mesh = par.make_mesh((4,), ('mp',), device=args.device, group='world')
    return _result(par.banded_qp_solve(mesh, data, **KW))


def job_banded(args):
    """banded_qp_solve of the family at n = ``--n`` on ``--shards`` shards
    (all of this process's on its device), with K2's launches."""
    P, q, A, l, u = banded_qp(args.n, seed=1)
    mesh = par.make_mesh((args.shards,), ('mp',), device=args.device, group='world')
    data = par.banded_qp_setup(P, q, A, l, u, args.shards, device=args.device)
    dm.launches = 0
    res = _result(par.banded_qp_solve(mesh, data, **KW))
    return dict(res, k2_launches=dm.launches, world=par.process_count())


def job_nccl_shared_card(args):
    """Two NCCL ranks on one card: building the mesh must raise."""
    try:
        par.make_mesh((2,), ('mp',), device='cuda:0', group='world')
    except ValueError as e:
        return dict(error=str(e))
    return dict(error=None)


def job_die(args):
    """Rank 1 dies; rank 0 waits for it in a collective."""
    if args.rank == 1:
        os._exit(3)
    mesh = par.make_mesh((2,), ('mp',), device=args.device, group='world')
    mesh.psum(_local(mesh, np.ones((2, 3))))
    return {}


def job_hang(args):
    """Every rank sleeps past any wall limit (after writing its pid)."""
    (Path(args.out) / f'rank{args.rank}.pid').write_text(str(os.getpid()))
    time.sleep(600)
    return {}


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith('job_')}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('job', choices=sorted(JOBS))
    ap.add_argument('--rank', type=int, required=True)
    ap.add_argument('--world', type=int, required=True)
    ap.add_argument('--init', required=True, help='init_method, e.g. file:///tmp/store')
    ap.add_argument('--out', required=True)
    ap.add_argument('--backend', default='gloo')
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--timeout-s', type=float, default=60.0)
    ap.add_argument('--data')
    ap.add_argument('--n', type=int, default=4096)
    ap.add_argument('--shards', type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(1)
    par.initialize(args.backend, init_method=args.init, rank=args.rank, world_size=args.world,
                   timeout_s=args.timeout_s)
    try:
        out = JOBS[args.job](args)
    finally:
        par.shutdown()
    torch.save(out, Path(args.out) / f'rank{args.rank}.pt')


def launch(job, world, workdir, *, wall_s=120.0, env=None, **opts):
    """Run ``job`` in ``world`` worker processes and return each rank's
    results.  ``opts`` become the workers' options (``device='cpu'``,
    ``timeout_s=30``, ...).  A worker that exits with an error, or the wall
    limit passing, kills every worker still running and raises
    (``RuntimeError``, ``TimeoutError``) with the end of each one's log
    (``chip_smoke.run_children``)."""
    from chip_smoke import run_children

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / 'store'
    if store.exists():
        store.unlink()
    cmd = [sys.executable, str(Path(__file__).resolve()), job, '--world', str(world),
           '--init', f'file://{store}', '--out', str(workdir)]
    for k, v in opts.items():
        cmd += [f'--{k.replace("_", "-")}', str(v)]
    run_children(cmd, world, workdir, wall_s, job, env={'OMP_NUM_THREADS': '1', **(env or {})})
    return [torch.load(workdir / f'rank{r}.pt', weights_only=True) for r in range(world)]


if __name__ == '__main__':
    main()
