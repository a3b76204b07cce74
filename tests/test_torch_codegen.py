"""The port's code generation against the JAX package's, on the CPU in
float64: ``export_workspace``, the emitted C project, the compiled embedded
module on tests/test_codegen.py's cases (from port models), and
``export_aot`` (a ``torch.export`` program) against ``osqp_tpu``'s
``export_aot`` in every mode and sparse format.

Tolerances: the two packages scale the same data with the same Ruiz
arithmetic in float64, so workspace arrays and emitted literals agree to
1e-12 of each array's largest magnitude; the embedded solves are held to
test_codegen.py's decimals against the port's live solves; the exported
solves give the JAX package's statuses and iterations exactly and x and y
within 1e-8, and the port's own host loop (``OSQP.solve`` after the same
q, l and u) bit for bit.
"""

import os
import re
import sys

import numpy as np
import numpy.testing as nptest
import pytest
import scipy.sparse as sp
import torch

import osqp_tpu
from osqp_tpu.codegen import driver as jdriver

import osqp_tpu_torch
from osqp_tpu_torch.codegen import driver as tdriver

import problems

REL = 1e-12


def _vec_problem():
    """test_codegen.py's vectors problem (l = -inf)."""
    P = sp.diags([11.0, 0.0], format='csc')
    q = np.array([3.0, 4.0])
    A = sp.csc_matrix([[-1, 0], [0, -1], [-1, -3], [2, 5], [3, 4]], dtype=float)
    u = np.array([0.0, 0.0, -15.0, 100.0, 80.0])
    return P, q, A, -np.inf * np.ones(5), u


def _mat_problem():
    P, q, A, l, u = _vec_problem()
    return sp.diags([11.0, 0.1], format='csc'), q, A, l, u


def _sparse_problem(n=2000):
    """test_codegen.py's n = 2000 banded QP of the sparse emitter."""
    rng = np.random.default_rng(0)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.7), np.full(n - 1, -0.7)],
                 [0, 1, -1]).tocsc()
    A = (sp.eye(n) + sp.diags([np.full(n - 2, 0.4)], [2], shape=(n, n))).tocsc()
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    return P, q, A, u - 2 * s0, u


def _zero_slot_problem():
    """test_codegen.py's P with two explicit stored zeros (reserved slots)."""
    n = 6
    rows = [0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 1, 2, 3, 4, 5, 0, 3]
    cols = [0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 3, 0]
    vals = [2.0] * 6 + [-0.5] * 5 + [-0.5] * 5 + [0.0, 0.0]
    P = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    return P, np.arange(1.0, n + 1), sp.eye(n, format='csc'), -np.ones(n), np.ones(n)


def _f32_problem(n=300):
    rng = np.random.default_rng(2)
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.6), np.full(n - 1, -0.6)],
                 [0, 1, -1]).tocsc()
    return P, rng.standard_normal(n), sp.eye(n, format='csc'), -np.ones(n), np.ones(n)


_VEC_OPTS = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8, rho=0.01, alpha=1.6,
                 max_iter=10000, warm_starting=True)
_MAT_OPTS = dict(verbose=False, eps_abs=1e-8, eps_rel=1e-8, alpha=1.6, max_iter=3000,
                 warm_starting=True)
_SPARSE_OPTS = dict(verbose=False, eps_abs=1e-5, eps_rel=1e-5)


def _port(prob, sparse=False, **opts):
    P, q, A, l, u = prob
    m = osqp_tpu_torch.OSQP(device='cpu', sparse=sparse)
    m.setup(P=P, q=q, A=A, l=l, u=u, **opts)
    return m


def _jax(prob, sparse=False, **opts):
    P, q, A, l, u = prob
    m = osqp_tpu.OSQP(algebra='jax', sparse=sparse)
    m.setup(P=P, q=q, A=A, l=l, u=u, **opts)
    return m


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max(initial=0.0)
    assert np.abs(got - want).max(initial=0.0) <= rel * scale, (got, want)


# --- export_workspace and the emitted files --------------------------------

_WS_CASES = {
    'vectors_dense': (_vec_problem, False, _VEC_OPTS),
    'matrices_dense': (_mat_problem, False, _MAT_OPTS),
    'banded_sparse': (_sparse_problem, True, _SPARSE_OPTS),
    'zero_slots': (_zero_slot_problem, False, dict(verbose=False)),
}


@pytest.mark.parametrize('case', list(_WS_CASES))
def test_export_workspace_matches_jax(case):
    """Every array within 1e-12 of its largest entry, the settings and the
    exact P (triu) and A patterns, explicit zeros included, identical."""
    build, sparse, opts = _WS_CASES[case]
    got = tdriver.export_workspace(_port(build(), sparse, **opts)._solver)
    want = jdriver.export_workspace(_jax(build(), sparse, **opts)._solver)
    assert set(got) == set(want)
    assert (got['n'], got['m'], got['is_sparse']) == (want['n'], want['m'], want['is_sparse'])
    assert got['is_sparse'] == sparse
    for k in ('P', 'A'):
        assert (got[k] is None) == sparse
        if not sparse:
            _close(got[k], want[k])
    for k in ('q', 'l', 'u', 'D', 'E', 'rho_vec', 'c'):
        _close(got[k], want[k])
    assert vars(got['settings']) == vars(want['settings'])
    for k in ('P_triu', 'A_pattern'):
        g, w = got[k].tocsc(), want[k].tocsc()
        for attr in ('indptr', 'indices', 'data'):
            nptest.assert_array_equal(getattr(g, attr), getattr(w, attr))


_DECL = re.compile(r'^(.+?) = (.+);$')


def _literals(text):
    """workspace.c as {declaration: numbers}; other lines as themselves."""
    out = {}
    for line in text.splitlines():
        m = _DECL.match(line)
        if m is None:
            out[line] = None
        else:
            out[m.group(1)] = np.array([float(v) for v in m.group(2).strip('{}').split(',')])
    return out


_GEN_CASES = {
    'vectors_dense': (_vec_problem, False, _VEC_OPTS,
                      dict(extension_name='vec_em', prefix='foo')),
    'matrices_dense': (_mat_problem, False, _MAT_OPTS,
                       dict(parameters='matrices', extension_name='mat_em', prefix='bar')),
    'flags_on': (_vec_problem, False, _VEC_OPTS,
                 dict(extension_name=None, printing_enable=True, profiling_enable=True,
                      interrupt_enable=True, derivatives_enable=True)),
    'matrices_sparse': (_sparse_problem, True, _SPARSE_OPTS,
                        dict(parameters='matrices', extension_name='sparse_em')),
    'zero_slots_sparse': (_zero_slot_problem, False, dict(verbose=False),
                          dict(parameters='matrices', embedded_algebra='sparse')),
    'float_sparse': (_f32_problem, False, dict(verbose=False, eps_abs=1e-4, eps_rel=1e-4),
                     dict(use_float=True, embedded_algebra='sparse')),
}


@pytest.mark.parametrize('case', list(_GEN_CASES))
def test_emitted_files_match_jax(case, tmp_path):
    """The same files; every one but workspace.c the JAX package's text with
    the generator's name changed; workspace.c's declarations identical and
    its literals within 1e-12 of each array's largest."""
    build, sparse, opts, kw = _GEN_CASES[case]
    got_dir = tdriver.generate(_port(build(), sparse, **opts), str(tmp_path / 'port'), **kw)
    want_dir = jdriver.generate(_jax(build(), sparse, **opts), str(tmp_path / 'jax'), **kw)
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        got = open(os.path.join(got_dir, name)).read()
        want = open(os.path.join(want_dir, name)).read()
        if not name.endswith('workspace.c'):
            assert 'osqp_tpu_torch.codegen' in got or name.endswith('module.c')
            assert got.replace('osqp_tpu_torch.codegen', 'osqp_tpu.codegen') == want, name
            continue
        g, w = _literals(got), _literals(want)
        assert list(g) == list(w)
        for decl, vals in w.items():
            if vals is not None:
                _close(g[decl], vals)


# --- the compiled embedded module on port models ---------------------------


def _compile(model, folder, ext, **kw):
    model_dir = model.codegen(str(folder), extension_name=ext, force_rewrite=True,
                              compile=True, **kw)
    sys.path.insert(0, model_dir)
    try:
        return __import__(ext)
    finally:
        sys.path.remove(model_dir)


def _ref_x(prob, sparse=False, **opts):
    return _port(prob, sparse, **opts).solve(raise_error=False).x


@pytest.fixture(scope='module')
def vec_module(tmp_path_factory):
    model = _port(_vec_problem(), **_VEC_OPTS)
    return _compile(model, tmp_path_factory.mktemp('cg_vec'), 'vec_emosqp_torch', prefix='foo')


@pytest.mark.parametrize('case', ['solve', 'update_q', 'update_bounds', 'bad_bounds'])
def test_vectors_module(vec_module, case):
    """test_codegen.py's vectors cases: the solve, update_data_vec of q and
    of the bounds (against the port's live solve of the updated problem, 4
    decimals), and bounds with l > u rejected."""
    mod = vec_module
    P, q, A, l, u = _vec_problem()
    if case == 'solve':
        x, y, status, niter, _ = mod.solve()
        nptest.assert_array_almost_equal(x, [0.0, 5.0], decimal=5)
        nptest.assert_array_almost_equal(y, [1.66666667, 0.0, 1.33333333, 0.0, 0.0], decimal=5)
        assert status == 1 and niter > 0
    elif case == 'update_q':
        q_new = np.array([10.0, 20.0])
        mod.update_data_vec(q=q_new)
        x, *_ = mod.solve()
        mod.update_data_vec(q=q)
        nptest.assert_array_almost_equal(x, _ref_x((P, q_new, A, l, u), **_VEC_OPTS), decimal=4)
    elif case == 'update_bounds':
        l_new, u_new = -100.0 * np.ones(5), 1000.0 * np.ones(5)
        mod.update_data_vec(l=l_new, u=u_new)
        x, *_ = mod.solve()
        mod.update_data_vec(l=l, u=u)
        nptest.assert_array_almost_equal(x, _ref_x((P, q, A, l_new, u_new), **_VEC_OPTS),
                                         decimal=4)
    else:
        with pytest.raises(ValueError):
            mod.update_data_vec(l=np.ones(5), u=-np.ones(5))


@pytest.fixture(scope='module')
def mat_module(tmp_path_factory):
    model = _port(_mat_problem(), **_MAT_OPTS)
    mod = _compile(model, tmp_path_factory.mktemp('cg_mat'), 'mat_emosqp_torch',
                   parameters='matrices', prefix='bar')
    return mod, model


@pytest.mark.parametrize('case', ['solve', 'update_P', 'update_A'])
def test_matrices_module(mat_module, case):
    """test_codegen.py's matrices cases: the solve against the model's, and
    update_data_mat of P (with indices) and of A against the port's live
    solve of the updated problem, 4 decimals."""
    mod, model = mat_module
    P, q, A, l, u = _mat_problem()
    if case == 'solve':
        x, y, *_ = mod.solve()
        r = model.solve(raise_error=False)
        nptest.assert_array_almost_equal(x, r.x, decimal=4)
        nptest.assert_array_almost_equal(y, r.y, decimal=4)
    elif case == 'update_P':
        P_new = sp.eye(2, format='csc')
        Px = sp.triu(P_new).tocsc().data
        mod.update_data_mat(P_x=Px, P_i=np.arange(len(Px), dtype=np.int32))
        x, *_ = mod.solve()
        mod.update_data_mat(P_x=sp.triu(P).tocsc().data)
        nptest.assert_array_almost_equal(x, _ref_x((P_new, q, A, l, u), **_MAT_OPTS), decimal=4)
    else:
        A_new = sp.csc_matrix([[-1, 0], [0, -1], [-2, -2], [2, 5], [3, 4]], dtype=float)
        mod.update_data_mat(A_x=A_new.data)
        x, *_ = mod.solve()
        mod.update_data_mat(A_x=A.tocsc().data)
        nptest.assert_array_almost_equal(x, _ref_x((P, q, A_new, l, u), **_MAT_OPTS), decimal=4)


def _tiny_model():
    P, q, A, l, u = _vec_problem()
    return _port((P, q, A, l, u), verbose=False, eps_abs=1e-6, eps_rel=1e-6)


def test_defines_change_emitted_c(tmp_path):
    """The printing, profiling, interrupt and derivatives flags alter the
    emitted C."""
    model = _tiny_model()
    model.codegen(str(tmp_path / 'off'), extension_name=None, force_rewrite=True)
    src_off = (tmp_path / 'off' / 'emosqp_solver.c').read_text()
    for flag in ('PRINTING', 'PROFILING', 'INTERRUPT', 'DERIVATIVES'):
        assert f'#define EMB_{flag} 0' in src_off
    model.codegen(str(tmp_path / 'on'), extension_name=None, force_rewrite=True,
                  printing_enable=True, profiling_enable=True, interrupt_enable=True,
                  derivatives_enable=True)
    src_on = (tmp_path / 'on' / 'emosqp_solver.c').read_text()
    for flag in ('PRINTING', 'PROFILING', 'INTERRUPT', 'DERIVATIVES'):
        assert f'#define EMB_{flag} 1' in src_on
    assert 'osqp_request_interrupt' in src_on
    assert 'osqp_request_interrupt' in (tmp_path / 'on' / 'workspace.h').read_text()


@pytest.mark.parametrize('use_float', [False, True])
def test_defines_compile_both_widths(tmp_path, use_float, capfd):
    """All flags on compile in both float widths and solve; printing emits
    progress rows, profiling a positive run time."""
    mod = _compile(_tiny_model(), tmp_path / f'flags_{int(use_float)}',
                   f'em_flags_torch_{int(use_float)}', use_float=use_float,
                   printing_enable=True, profiling_enable=True, interrupt_enable=True)
    x, y, status, niter, run_time = mod.solve()
    nptest.assert_array_almost_equal(x, [0.0, 5.0], decimal=3 if use_float else 5)
    assert status == 1 and run_time > 0
    out = capfd.readouterr().out
    assert 'iter' in out and 'status' in out


@pytest.fixture(scope='module')
def sparse_module(tmp_path_factory):
    model = _port(_sparse_problem(), True, **_SPARSE_OPTS)
    folder = tmp_path_factory.mktemp('cg_sparse')
    mod = _compile(model, folder, 'sparse_emosqp_torch', parameters='matrices')
    return mod, model, folder


@pytest.mark.parametrize('case', ['workspace_is_O_nnz', 'solve_and_updates'])
def test_sparse_module(sparse_module, case):
    """The n = 2000 sparse-mode model through the sparse emitter (auto ->
    sparse): CSR data baked, no dense matrix or factor, about 1 MB of
    literals; its solve, a q update and a P update through the baked CSR
    index maps against the port's live solves."""
    mod, model, folder = sparse_module
    P, q, A, l, u = _sparse_problem()
    if case == 'workspace_is_O_nnz':
        src = (folder / 'workspace.c').read_text()
        assert 'P_data' in src and 'At_data' in src and 'diag_M' in src
        assert 'double L[' not in src and ' P[' not in src
        assert os.path.getsize(folder / 'workspace.c') < 5_000_000
        return
    x, _, status, _, _ = mod.solve()
    assert status == 1
    nptest.assert_allclose(x, model.solve(raise_error=False).x, atol=1e-2)
    mod.update_data_vec(q=q + 0.1)
    x2, _, s2, _, _ = mod.solve()
    model.update(q=q + 0.1)
    assert s2 == 1
    nptest.assert_allclose(x2, model.solve(raise_error=False).x, atol=5e-3)
    Px_new = sp.triu(P, format='csc').data * 1.2
    mod.update_data_mat(P_x=Px_new)
    x3, _, s3, _, _ = mod.solve()
    model.update(Px=Px_new)
    assert s3 == 1
    nptest.assert_allclose(x3, model.solve(raise_error=False).x, atol=5e-3)
    mod.update_data_vec(q=q)
    mod.update_data_mat(P_x=sp.triu(P, format='csc').data)
    model.update(q=q, Px=sp.triu(P, format='csc').data)


@pytest.mark.parametrize('sparse,embedded_algebra', [(False, 'dense'), (False, 'sparse'),
                                                     (True, 'sparse')])
def test_explicit_zero_pattern_slots(tmp_path, sparse, embedded_algebra):
    """Explicit stored zeros of P survive into the baked pattern and index
    maps: filling the reserved slot through update_data_mat solves like the
    port's live update."""
    model = _port(_zero_slot_problem(), sparse, verbose=False, eps_abs=1e-8, eps_rel=1e-8)
    mod = _compile(model, tmp_path, f'zero_slot_torch_{int(sparse)}_{embedded_algebra}',
                   parameters='matrices', embedded_algebra=embedded_algebra)
    P = _zero_slot_problem()[0]
    Ptriu = sp.triu(P, format='csc')
    Px = Ptriu.data.copy()
    ct = np.repeat(np.arange(P.shape[0]), np.diff(Ptriu.indptr))
    Px[np.where((Ptriu.indices == 0) & (ct == 3))[0][0]] = 0.3
    mod.update_data_mat(P_x=Px)
    x, _, status, _, _ = mod.solve()
    model.update(Px=Px)
    assert status == 1
    nptest.assert_allclose(x, model.solve(raise_error=False).x, atol=1e-5)


def test_sparse_use_float_compiles_and_solves(tmp_path):
    """The float32 sparse emitter converges: solved (or solved inaccurate)
    near the port's live float64 solve, short of the iteration cap."""
    model = _port(_f32_problem(), verbose=False, eps_abs=1e-4, eps_rel=1e-4)
    mod = _compile(model, tmp_path, 'emf32s_torch', use_float=True, embedded_algebra='sparse')
    x, _, status, niter, _ = mod.solve()
    assert status in (1, 2), status
    nptest.assert_allclose(x, model.solve(raise_error=False).x, atol=1e-2)
    assert niter < 4000


def test_codegen_capability_and_bad_parameters():
    model = _tiny_model()
    assert model.has_capability('OSQP_CAPABILITY_CODEGEN')
    with pytest.raises(AssertionError, match='Unknown parameters'):
        model.codegen('unused', parameters='all')
    with pytest.raises(ValueError, match='embedded_algebra'):
        model.codegen('unused', embedded_algebra='blocked')


# --- export_aot ------------------------------------------------------------


def _mpc_like_qp(T=14, seed=4):
    """tests/test_spmv.py's banded MPC-cascade QP (test_torch_spmv_formats.py
    holds it to exact counts in every format)."""
    rng = np.random.default_rng(seed)
    n = 2 * T
    P = sp.diags([np.full(n, 2.0), np.full(n - 1, -0.6), np.full(n - 1, -0.6)],
                 [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = sp.eye(n, format='csc') + sp.diags([np.full(n - 2, 0.3)], [-2], shape=(n, n))
    return P, q, A.tocsc(), -np.ones(n) * 2, np.ones(n) * 2


_AOT_CASES = {
    # name: (problem, sparse format or None for dense mode, solver_type, eps)
    'dense_direct': (problems.basic_qp, None, 'direct', 1e-6),
    'dense_indirect': (problems.basic_qp, None, 'indirect', 1e-6),
    'dia': (_mpc_like_qp, 'dia', 'indirect', 1e-7),
    'ell': (_mpc_like_qp, 'ell', 'indirect', 1e-7),
    'bsr': (_mpc_like_qp, 'bsr', 'indirect', 1e-7),
    'csr': (_mpc_like_qp, 'bcoo', 'indirect', 1e-7),
    'primal_infeasible': (problems.primal_infeasible, None, 'direct', 1e-6),
}
# save/load round trips (about 4 s each): the Cholesky refactorization
# inside a cond, and a program holding a custom operator
_ROUND_TRIP = ('dense_direct', 'dia')


@pytest.mark.parametrize('case', list(_AOT_CASES))
def test_export_aot_matches_jax(case, tmp_path, monkeypatch):
    """The exported program against ``osqp_tpu``'s ``export_aot`` on the
    same model: status and iterations equal, x and y within 1e-8 (NaN for
    the primal-infeasible problem); against the port's own host loop after
    ``update(q, l, u)`` with the same vectors: the same status, iterations,
    CG steps and rho updates and the same x and y bit for bit; after a
    ``torch.export`` save/load round trip (two of the cases), the same
    outputs bit for bit."""
    build, fmt, solver_type, eps = _AOT_CASES[case]
    P, q, A, l, u = build()
    kw = dict(verbose=False, eps_abs=eps, eps_rel=eps, solver_type=solver_type)
    sparse = fmt is not None
    if sparse:
        monkeypatch.setenv('OSQP_TPU_SPARSE_FORMAT', fmt)
    j = _jax((P, q, A, l, u), sparse, **kw)
    t = osqp_tpu_torch.OSQP(device='cpu', sparse=sparse, sparse_format=fmt or 'auto')
    t.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    if sparse:
        assert t._solver._sparse_fmt_P == t._solver._sparse_fmt_A == fmt

    compiled = tdriver.export_aot(t)
    assert isinstance(compiled.program, torch.export.ExportedProgram)
    got = compiled.solve(q, l, u)
    xj, yj, sj, itj = jdriver.export_aot(j)(q, l, u)
    assert int(got.status) == int(sj)
    assert int(got.iters) == int(itj)
    if case == 'primal_infeasible':
        assert int(got.status) == osqp_tpu_torch.constant('OSQP_PRIMAL_INFEASIBLE')
        assert torch.isnan(got.x).all() and torch.isnan(got.y).all()
    else:
        assert int(got.status) == 1
    for a, b in ((got.x, xj), (got.y, yj)):
        nptest.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)
    x4, y4, s4, it4 = compiled(q, l, u)  # the JAX package's four outputs
    assert (int(s4), int(it4)) == (int(got.status), int(got.iters))

    t.update(q=q, l=l, u=u)
    live = t.solve(raise_error=False)
    assert (int(got.status), int(got.iters), int(got.cg_iters), int(got.rho_updates)) == \
        (live.info.status_val, live.info.iter, live.info.cg_iters, live.info.rho_updates)
    assert (int(got.cg_iters) > 0) == (solver_type == 'indirect')
    nptest.assert_array_equal(got.x.numpy(), live.x)
    nptest.assert_array_equal(got.y.numpy(), live.y)

    if case not in _ROUND_TRIP:
        return
    path = tmp_path / 'solve.pt2'
    torch.export.save(compiled.program, str(path))
    loaded = tdriver.AotSolve(torch.export.load(str(path)), torch.float64, 'cpu')
    again = loaded.solve(q, l, u)
    for a, b in zip(again, got):
        assert torch.equal(a, b) or (torch.isnan(a).all() and torch.isnan(b).all())
