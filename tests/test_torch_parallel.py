"""The port's multi-device package (``osqp_tpu_torch.parallel``) on the CPU:
the single-process mesh and its collectives, and the row-sharded
(``bigqp``) and halo-exchange banded (``banded``) huge-QP modes against
``osqp_tpu.parallel`` on a 4-device CPU mesh, in float64.

Three JAX solver calls in all (``big_qp_solve``, ``banded_qp_solve`` and a
3-step ``banded_mpc_rollout``, each at J = 4 on
``tests/test_banded.py``'s family); everything else holds the port to the
JAX package's host setup, to the JAX package's product on the halo window,
or to itself.
"""

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as JP

from osqp_tpu._oracle.solver import ReferenceSolver
from osqp_tpu.parallel import banded as jbanded, bigqp as jbigqp
from osqp_tpu_torch.constants import SolverStatus
from osqp_tpu_torch.convert import from_jax_banded, from_jax_bigqp
from osqp_tpu_torch.ops.dia_matvec import dia_matvec
from osqp_tpu_torch.parallel import (
    Mesh, banded_mpc_rollout, banded_qp_setup, banded_qp_solve, banded_qp_update_vec,
    big_qp_mpc_rollout, big_qp_setup, big_qp_solve, big_qp_update_vec, make_mesh,
)
from osqp_tpu_torch.parallel.mesh import Parts
from test_banded import _banded_qp

KW = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000, cg_tol=1e-12)
# the port against itself: the same CG tolerance, a looser ADMM one
KW5 = dict(KW, eps_abs=1e-5, eps_rel=1e-5)
F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu_default_device():
    with jax.default_device(jax.devices('cpu')[0]):
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the port's CPU loops issue many tiny
    torch ops, and with the default pool each sparse product or batched
    factorization wakes every core (bigqp: 8x the CPU time of one thread
    for the same wall), which starves the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(J):
    return JaxMesh(np.array(jax.devices('cpu')[:J]), ('mp',))


def _mesh(J):
    return make_mesh((J,), ('mp',), device='cpu')


def _arrays(data):
    """A JAX setup's fields as numpy arrays (ints and tuples as they are)."""
    return {k: (np.asarray(v) if hasattr(v, 'shape') else v) for k, v in data._asdict().items()}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


def _parts(mesh, arrays):
    return Parts(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize('J', [1, 2, 4])
def test_mesh_collectives_match_numpy(J):
    """psum (summed in shard order), pmax, tiled all_gather cut to a size,
    on every shard, each a fresh tensor of its own."""
    mesh = _mesh(J)
    assert mesh.shape['mp'] == J and mesh.size == J
    rng = np.random.default_rng(J)
    vals = [rng.standard_normal(5) for _ in range(J)]
    parts = _parts(mesh, vals)
    want = vals[0].copy()
    for v in vals[1:]:
        want = want + v
    for got in mesh.psum(parts):
        np.testing.assert_array_equal(got.numpy(), want)
    for got in mesh.pmax(parts):
        np.testing.assert_array_equal(got.numpy(), np.max(vals, axis=0))
    gathered = mesh.all_gather(parts, size=5 * J - 2)
    for got in gathered:
        np.testing.assert_array_equal(got.numpy(), np.concatenate(vals)[:5 * J - 2])
    out = list(mesh.psum(parts)) + list(gathered)
    ptrs = [t.data_ptr() for t in out] + [t.data_ptr() for t in parts]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize('J', [1, 2, 4])
@pytest.mark.parametrize('W', [1, 3])
def test_mesh_halo_window_edges(J, W):
    """Each shard's window is its left neighbour's last W entries, its own
    block and its right neighbour's first W; the mesh's ends get zeros, an
    interior shard never does."""
    mesh = _mesh(J)
    L = 4
    glob = np.arange(1.0, J * L + 1)
    wins = mesh.halo_window(_parts(mesh, glob.reshape(J, L)), W)
    padded = np.concatenate([np.zeros(W), glob, np.zeros(W)])
    for j, w in enumerate(wins):
        np.testing.assert_array_equal(w.numpy(), padded[j * L:j * L + L + 2 * W])
    with pytest.raises(ValueError, match='halo'):
        mesh.halo_window(_parts(mesh, glob.reshape(J, L)), L + 1)


def test_mesh_axes_split_join_and_groups():
    """A (2, 3) mesh: collectives over one axis join the shards that differ
    on it only; split and join invert each other as a PartitionSpec."""
    mesh = make_mesh((2, 3), ('dp', 'mp'), device='cpu')
    assert mesh.groups('mp') == [[0, 1, 2], [3, 4, 5]]
    assert mesh.groups('dp') == [[0, 3], [1, 4], [2, 5]]
    parts = Parts(torch.tensor([float(i)]) for i in range(6))
    assert [float(t) for t in mesh.psum(parts, 'mp')] == [3.0] * 3 + [12.0] * 3
    assert [float(t) for t in mesh.pmax(parts, 'dp')] == [3.0, 4.0, 5.0] * 2
    x = torch.arange(4 * 6 * 5, dtype=F64).reshape(4, 6, 5)
    blocks = mesh.split(x, ('dp', 'mp'))
    assert blocks[4].shape == (2, 2, 5)
    assert torch.equal(blocks[4], x[2:4, 2:4])
    assert torch.equal(mesh.join(blocks, ('dp', 'mp')), x)
    rep = mesh.split(x, ('dp',))
    assert torch.equal(rep[1], rep[2]) and torch.equal(mesh.join(rep, ('dp',)), x)
    assert Mesh(np.array(['cpu'] * 4).reshape(2, 2), ('a', 'b')).shape == {'a': 2, 'b': 2}


def test_parts_arithmetic_is_per_shard():
    a = Parts([torch.tensor(1.0, dtype=F64), torch.tensor(2.0, dtype=F64)])
    b = Parts([torch.tensor(10.0, dtype=F64), torch.tensor(20.0, dtype=F64)])
    assert [float(t) for t in np.float64(2.0) * a + b - 1.0] == [11.0, 23.0]
    assert [bool(t) for t in (a == 2.0)] == [False, True]
    assert [float(t) for t in 1.0 / b] == [0.1, 0.05]


# ---------------------------------------------------------------------------
# Setup against the JAX package's (host only)
# ---------------------------------------------------------------------------


def _assert_fields_match(port, jax_data, tol=1e-14):
    want = _arrays(jax_data)
    for name in port._fields:
        got = getattr(port, name)
        if isinstance(got, torch.Tensor):
            w = want[name].astype(np.float64)
            scale = max(1.0, np.abs(w[np.abs(w) < 1e29]).max(initial=0))
            np.testing.assert_allclose(_np(got).astype(np.float64), w, rtol=tol,
                                       atol=tol * scale, err_msg=name)
        else:
            assert got == want[name], name


@pytest.mark.parametrize('m_eq_n', [True, False])
@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_setup_fields_match_jax_package(which, m_eq_n):
    P, q, A, l, u = _banded_qp(96, seed=3, m_eq_n=m_eq_n)
    if which == 'bigqp':
        port = big_qp_setup(P, q, A, l, u, 4, device='cpu')
        ref = jbigqp.big_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
    else:
        port = banded_qp_setup(P, q, A, l, u, 4, device='cpu')
        ref = jbanded.banded_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
    _assert_fields_match(port, ref)
    assert port.q.dtype == F64 and port.q.device.type == 'cpu'


def test_setup_defaults_to_float64_and_raises_without_cuda(monkeypatch):
    P, q, A, l, u = _banded_qp(32, seed=1)
    assert banded_qp_setup(P, q, A, l, u, 2, device='cpu').q.dtype == F64
    assert big_qp_setup(P, q, A, l, u, 2, device='cpu', dtype=torch.float32).q.dtype == \
        torch.float32
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for setup in (banded_qp_setup, big_qp_setup):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            setup(P, q, A, l, u, 2)


# ---------------------------------------------------------------------------
# Solves against the JAX package (three JAX solver calls)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_solve_matches_jax_package(which):
    """J = 4, f64, started from the JAX package's own setup: status,
    iterations and rho updates equal; x and y within 1e-8."""
    P, q, A, l, u = _banded_qp(128, seed=5)
    if which == 'bigqp':
        jd = jbigqp.big_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
        want = jbigqp.big_qp_solve(_jax_mesh(4), jd, **KW)
        got = big_qp_solve(_mesh(4), from_jax_bigqp(_arrays(jd), 'cpu', F64), **KW)
    else:
        jd = jbanded.banded_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
        want = jbanded.banded_qp_solve(_jax_mesh(4), jd, **KW)
        got = banded_qp_solve(_mesh(4), from_jax_banded(_arrays(jd), 'cpu', F64), **KW)
    assert got.status == int(want.status) == 1
    assert got.iters == int(want.iters)
    assert got.rho_updates == int(want.rho_updates)
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.y), np.asarray(want.y), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.z), np.asarray(want.z), rtol=0, atol=1e-8)
    assert abs(float(got.obj_val) - float(want.obj_val)) < 1e-8
    assert got.cg_iters > got.iters and got.host_syncs >= got.cg_iters
    assert got.cg_cap_hits == 0


def test_banded_rollout_matches_jax_package():
    """A 3-step warm rollout: statuses and per-step iterations equal, x
    within 1e-8, the carries too."""
    n = 128
    P, q, A, l, u = _banded_qp(n, seed=13)
    q_seq = q[None] + 0.05 * np.random.default_rng(1).standard_normal((3, n))
    jd = jbanded.banded_qp_setup(P, q, A, l, u, 4, dtype=jnp.float64)
    want = jbanded.banded_mpc_rollout(_jax_mesh(4), jd, q_seq, **KW)
    got = banded_mpc_rollout(_mesh(4), from_jax_banded(_arrays(jd), 'cpu', F64), q_seq, **KW)
    np.testing.assert_array_equal(_np(got.status), np.asarray(want.status))
    assert (_np(got.status) == 1).all()
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    for name in ('x', 'x_carry', 'z_carry', 'y_carry'):
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_halo_product_plain_path_matches_jax():
    """The banded local product on 4 CPU shards, on the family's own scaled
    bands: the port's halo windows equal the JAX package's ``halo_window``
    (``lax.ppermute``, ``osqp_tpu/parallel/banded.py:269-275``) bit for bit;
    the plain K2 path equals the window's products summed in offset order
    (numpy, no fused multiply-add) bit for bit; and the JAX package's
    ``dia_mv`` (``:277-284``) agrees to rounding only: XLA on the CPU fuses
    its multiply-adds into FMAs, so about a third of its entries differ from
    the unfused sum in the last bit."""
    J = 4
    P, q, A, l, u = _banded_qp(128, seed=5)
    jd = jbanded.banded_qp_setup(P, q, A, l, u, J, dtype=jnp.float64)
    pd = from_jax_banded(_arrays(jd), 'cpu', F64)
    L = pd.L
    W = max(max(abs(o) for o in offs) for offs in (pd.offsets_p, pd.offsets_a, pd.offsets_at))
    v = np.random.default_rng(0).standard_normal((J, L))
    fwd = [(j, j + 1) for j in range(J - 1)]
    bwd = [(j + 1, j) for j in range(J - 1)]
    mesh = _mesh(J)
    wins = mesh.halo_window(Parts(torch.tensor(r) for r in v), W)
    for bands, offsets in ((pd.p_bands, pd.offsets_p), (pd.a_bands, pd.offsets_a),
                           (pd.at_bands, pd.offsets_at), (pd.a2t_bands, pd.offsets_at)):
        def run(b, v_b, offsets=offsets):
            b, v_loc = b[0], v_b[0]
            left = lax.ppermute(v_loc[-W:], 'mp', fwd)
            right = lax.ppermute(v_loc[:W], 'mp', bwd)
            w = jnp.concatenate([left, v_loc, right])
            acc = b[0] * lax.slice(w, (W + offsets[0],), (W + offsets[0] + L,))
            for d, o in enumerate(offsets[1:], start=1):
                acc = acc + b[d] * lax.slice(w, (W + o,), (W + o + L,))
            return w[None], acc[None]

        jw, jy = jax.jit(jax.shard_map(run, mesh=_jax_mesh(J), in_specs=(JP('mp'), JP('mp')),
                                       out_specs=(JP('mp'), JP('mp'))))(
            jnp.asarray(_np(bands)), jnp.asarray(v))
        off = torch.tensor([W + o for o in offsets], dtype=torch.int32)
        for j in range(J):
            w = wins[j].numpy()
            np.testing.assert_array_equal(w, np.asarray(jw)[j])
            got = dia_matvec(bands[j], off, wins[j]).numpy()
            b = _np(bands[j])
            terms = [b[d] * w[W + o:W + o + L] for d, o in enumerate(offsets)]
            unfused = terms[0]
            for t in terms[1:]:
                unfused = unfused + t
            np.testing.assert_array_equal(got, unfused)
            bound = 4 * np.finfo(np.float64).eps * np.sum(np.abs(terms), axis=0)
            assert (np.abs(got - np.asarray(jy)[j]) <= bound).all()


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


def test_banded_matches_bigqp():
    P, q, A, l, u = _banded_qp(64, seed=5)
    rb = banded_qp_solve(_mesh(4), banded_qp_setup(P, q, A, l, u, 4, device='cpu'), **KW5)
    rg = big_qp_solve(_mesh(4), big_qp_setup(P, q, A, l, u, 4, device='cpu'), **KW5)
    assert rb.status == rg.status == 1
    assert rb.iters == rg.iters
    np.testing.assert_allclose(_np(rb.x), _np(rg.x), rtol=0, atol=1e-8)


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_one_shard_equals_four(which):
    P, q, A, l, u = _banded_qp(64, seed=7)
    setup, solve = ((big_qp_setup, big_qp_solve) if which == 'bigqp'
                    else (banded_qp_setup, banded_qp_solve))
    r1 = solve(_mesh(1), setup(P, q, A, l, u, 1, device='cpu'), **KW5)
    r4 = solve(_mesh(4), setup(P, q, A, l, u, 4, device='cpu'), **KW5)
    assert r1.status == r4.status == 1
    assert r1.iters == r4.iters and r1.rho_updates == r4.rho_updates
    np.testing.assert_allclose(_np(r1.x), _np(r4.x), rtol=0, atol=1e-10)


def test_m_ne_n_solves_to_bigqp_optimum():
    """m = n - 1 pads the banded blocks with loose rows and pinned
    variables; both modes give the same iterations and solution."""
    P, q, A, l, u = _banded_qp(64, seed=3, m_eq_n=False)
    rb = banded_qp_solve(_mesh(4), banded_qp_setup(P, q, A, l, u, 4, device='cpu'), **KW5)
    rg = big_qp_solve(_mesh(4), big_qp_setup(P, q, A, l, u, 4, device='cpu'), **KW5)
    assert rb.status == rg.status == 1 and rb.iters == rg.iters
    assert rb.x.shape == (64,) and rb.y.shape == (63,)
    np.testing.assert_allclose(_np(rb.x), _np(rg.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(rb.y), _np(rg.y), rtol=0, atol=1e-7)


def test_banded_bandwidth_guard():
    n = 64
    P = sparse.eye(n, format='csc')
    A = (sparse.eye(n) + sparse.diags([np.ones(n - 40)], [40], shape=(n, n))).tocsc()
    with pytest.raises(ValueError, match='bandwidth'):
        banded_qp_setup(P, np.zeros(n), A, -np.ones(n), np.ones(n), 8, device='cpu')


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_warm_start_from_solution(which):
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=7)
    setup, solve = ((big_qp_setup, big_qp_solve) if which == 'bigqp'
                    else (banded_qp_setup, banded_qp_solve))
    data = setup(P, q, A, l, u, 4, device='cpu')
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
    res = solve(_mesh(4), data, **kw)
    assert res.status == 1
    D = data.D.reshape(-1)[:n]
    E = data.E.reshape(-1)[:n]
    res2 = solve(_mesh(4), data, x0=res.x / D, z0=res.z, y0=res.y * data.c / E, **kw)
    assert res2.status == 1
    assert res2.iters <= 25 < res.iters


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_polish_accepted(which):
    """The polish through the same distributed PCG lowers both residuals
    and lands on the float64 oracle's polished optimum (the JAX package's
    test_banded_polish tolerances)."""
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=9)
    setup, solve = ((big_qp_setup, big_qp_solve) if which == 'bigqp'
                    else (banded_qp_setup, banded_qp_solve))
    data = setup(P, q, A, l, u, 4, device='cpu')
    kw = dict(eps_abs=1e-3, eps_rel=1e-3, check_every=5, max_iter=20000, cg_tol=1e-12)
    loose = solve(_mesh(4), data, **kw)
    res = solve(_mesh(4), data, polish=True, **kw)
    assert res.status == 1 and res.status_polish == 1 and loose.status_polish == 0
    assert float(res.pri_res) < float(loose.pri_res) and float(res.dua_res) < float(loose.dua_res)
    ref = ReferenceSolver()
    ref.setup(P, q, A, l, u, verbose=False, eps_abs=1e-10, eps_rel=1e-10, max_iter=200000,
              polishing=True)
    sol, _ = ref.solve()
    np.testing.assert_allclose(_np(res.x), sol.x, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(res.y), sol.y, rtol=1e-4, atol=1e-5)


def test_primal_infeasible_certificate():
    """An unsatisfiable equality row: both modes end primal infeasible with
    NaN x and an unscaled Farkas certificate (the JAX package's test
    tolerances), and their two certificates agree to 1e-6 relative."""
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=11)
    A = A.tolil()
    A[n // 2, :] = 0.0
    A = A.tocsc()
    l[n // 2] = u[n // 2] = 5.0
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
    certs = []
    for setup, solve in ((big_qp_setup, big_qp_solve), (banded_qp_setup, banded_qp_solve)):
        res = solve(_mesh(4), setup(P, q, A, l, u, 4, device='cpu'), **kw)
        assert res.status in (int(SolverStatus.OSQP_PRIMAL_INFEASIBLE),
                              int(SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE))
        assert np.isnan(_np(res.x)).all() and np.isnan(_np(res.y)).all()
        dy = _np(res.prim_inf_cert)
        norm_dy = np.abs(dy).max()
        assert norm_dy > 0
        lhs = np.minimum(u, 1e30) @ np.maximum(dy, 0) + np.maximum(l, -1e30) @ np.minimum(dy, 0)
        assert lhs < 0
        assert np.abs(A.T @ dy).max() < 1e-3 * norm_dy
        certs.append(dy)
    np.testing.assert_allclose(certs[1], certs[0], rtol=0, atol=1e-6 * np.abs(certs[0]).max())


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_update_vec_against_fresh_setup(which):
    """Without scaling, an update of q, l and u gives the fields of a fresh
    setup on the new vectors (rho retyped, the preconditioner rebuilt);
    with scaling, the same solution as a fresh setup's, and banded and
    bigqp updates keep their iteration parity."""
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=17)
    l2, u2 = l - 0.05, u + 0.05
    u2[:3] = l2[:3] + 1.0
    l2[6:10] = u2[6:10] = 0.5 * (l2[6:10] + u2[6:10])
    l2[10], u2[10] = -1e30, 1e30
    q2 = q + 0.1
    setup, solve, update = ((big_qp_setup, big_qp_solve, big_qp_update_vec) if which == 'bigqp'
                            else (banded_qp_setup, banded_qp_solve, banded_qp_update_vec))
    plain = update(setup(P, q, A, l, u, 4, scaling=0, device='cpu'), q=q2, l=l2, u=u2)
    fresh = setup(P, q2, A, l2, u2, 4, scaling=0, device='cpu')
    for name in ('q', 'l', 'u', 'rho_vec', 'types', 'diag_M'):
        np.testing.assert_allclose(_np(getattr(plain, name)).astype(float),
                                   _np(getattr(fresh, name)).astype(float), rtol=1e-14,
                                   atol=1e-14, err_msg=name)
    upd = update(setup(P, q, A, l, u, 4, device='cpu'), q=q2, l=l2, u=u2)
    r_upd = solve(_mesh(4), upd, **KW5)
    r_new = solve(_mesh(4), setup(P, q2, A, l2, u2, 4, device='cpu'), **KW5)
    assert r_upd.status == r_new.status == 1
    np.testing.assert_allclose(_np(r_upd.x), _np(r_new.x), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match='l must be'):
        update(upd, l=u + 1.0, u=u)


@pytest.mark.parametrize('which', ['bigqp', 'banded'])
def test_rollout_equals_step_by_step_bit_for_bit(which):
    """The rollout is the loop update_vec(q) + a warm solve from the last
    step's scaled iterates, bit for bit; its carries restart a rollout."""
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=13)
    setup, solve, update, roll = (
        (big_qp_setup, big_qp_solve, big_qp_update_vec, big_qp_mpc_rollout) if which == 'bigqp'
        else (banded_qp_setup, banded_qp_solve, banded_qp_update_vec, banded_mpc_rollout))
    data = setup(P, q, A, l, u, 4, device='cpu')
    mesh = _mesh(4)
    q_seq = q[None] + 0.05 * np.random.default_rng(1).standard_normal((2, n))
    r = roll(mesh, data, q_seq, **KW5)
    assert (_np(r.status) == 1).all() and r.x.device.type == 'cpu'
    x0 = z0 = y0 = None
    Dinv = data.Dinv.reshape(-1)[:n]
    Einv = data.Einv.reshape(-1)[:n]
    for t in range(2):
        res = solve(mesh, update(data, q=q_seq[t]), x0=x0, z0=z0, y0=y0, **KW5)
        assert res.status == 1 and res.iters == int(r.iters[t])
        assert torch.equal(res.x, r.x[t])
        x0, z0, y0 = res.x * Dinv, res.z, res.y * data.c * Einv
    again = roll(mesh, data, q_seq[-1:], x0=r.x_carry, z0=r.z_carry, y0=r.y_carry, **KW5)
    assert int(again.status[0]) == 1 and int(again.iters[0]) <= 25


def test_rollout_restarts_cold_after_infeasible_step():
    """An infeasible step zeroes the carries; the next step solves cold."""
    n = 64
    P, q, A, l, u = _banded_qp(n, seed=11)
    A = A.tolil()
    A[n // 2, :] = 0.0
    l[n // 2] = u[n // 2] = 5.0
    data = banded_qp_setup(P, q, A.tocsc(), l, u, 4, device='cpu')
    r = banded_mpc_rollout(_mesh(4), data, np.stack([q, q]), eps_abs=1e-6, eps_rel=1e-6,
                           max_iter=2000)
    infeasible = (int(SolverStatus.OSQP_PRIMAL_INFEASIBLE),
                  int(SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE))
    assert int(r.status[0]) in infeasible and int(r.status[1]) in infeasible
    assert int(r.iters[0]) == int(r.iters[1])
    assert torch.count_nonzero(r.x_carry) == 0 and torch.count_nonzero(r.y_carry) == 0
