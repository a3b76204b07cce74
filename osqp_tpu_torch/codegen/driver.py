"""Embedded code generation from a port ``OSQP``, and its exported solve.

The port's counterpart of ``osqp_tpu/codegen/driver.py`` (reference
behaviour: ``OSQP.codegen(folder, parameters='vectors'|'matrices', ...)``
emits a self-contained C project with the problem data and factorization
baked into a statically allocated workspace, renders a Python extension
wrapper, and optionally compiles it in place).

Two artifacts, as in the JAX package:

1. ``generate``: the plain-C embedded solver (``{prefix}workspace.c/h``,
   ``{prefix}emosqp_solver.c`` and a CMakeLists) and the CPython extension
   wrapper (``{extension_name}_module.c`` and a setup.py).  The emitted text
   is the JAX package's (``ctemplates``), the workspace is read from the
   port's ``backend.Solver`` in float64 whatever the model's working dtype.
2. ``export_aot``: the counterpart of the JAX package's ahead-of-time
   compiled solve, a ``torch.export`` program of ``solve(q, l, u)`` with the
   problem structure, scaling, rho state and factorization held as buffers
   (``solver.core_graph``).  On the card its sparse products launch the
   hand-written kernels through the ``ops.library`` operators.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import ctemplates
from ..utils.patterns import triu_to_full


def _adaptive_interval(stg):
    from ..constants import ADAPTIVE_RHO_FIXED

    interval = int(stg.adaptive_rho_interval) or ADAPTIVE_RHO_FIXED
    ct = max(int(stg.check_termination), 1)
    # align to check boundaries like the host solvers (epoch semantics)
    return -(-interval // ct) * ct


def _constr_types(ws):
    from ..constants import MIN_SCALING, OSQP_INFTY, RHO_TOL

    l, u = ws['l'], ws['u']
    loose = (l < -OSQP_INFTY * MIN_SCALING) & (u > OSQP_INFTY * MIN_SCALING)
    eq = (~loose) & (u - l < RHO_TOL)
    t = np.zeros(max(ws['m'], 1), dtype=np.int8)
    t[: ws['m']][loose] = -1
    t[: ws['m']][eq] = 1
    return t


def _carray(name, arr, ctype, const=False):
    arr = np.atleast_1d(np.asarray(arr)).ravel()
    if arr.size == 0:
        return f'{ctype} {name}[1] = {{0}};'
    vals = ', '.join(f'{v:.17g}' if ctype != 'int' else str(int(v)) for v in arr)
    return f'{ctype} {name}[{arr.size}] = {{{vals}}};'


def _f64(t):
    return t.detach().cpu().numpy().astype(np.float64)


def export_workspace(solver):
    """The scaled workspace of a ``backend.Solver`` as float64 numpy arrays.

    Dense mode exports the scaled P and A; a sparse-mode solver holds them
    as sparse operators, so only the flag is exported (``generate`` rebuilds
    the scaled CSR operands from the pattern matrices).  The patterns are
    the exact ones the update path validates against: ``sp.triu`` of the
    full P could drop explicit stored zeros (reserved update slots) and
    desynchronize the baked index maps from the user's data order.

    The 'ldl' algebra exports its scaled P and A dense, as the JAX package
    reads its numpy algebra's workspace."""
    if getattr(solver, 'ALGEBRA', None) == 'ldl':
        return dict(
            n=solver.n, m=solver.m, P=solver._P_s.toarray(),
            A=solver._A_s.toarray() if solver.m else np.zeros((0, solver.n)), is_sparse=False,
            q=_f64(solver._data.q), l=_f64(solver._data.l), u=_f64(solver._data.u),
            D=_f64(solver._scal.D), E=_f64(solver._scal.E), c=float(solver._scal.c),
            rho_vec=_f64(solver._rho.rho_vec), settings=solver._stg,
            P_triu=solver._P_triu_pattern.copy(), A_pattern=solver._A_pattern.copy(),
        )
    sparse_mode = bool(solver._is_sparse)
    return dict(
        n=solver.n,
        m=solver.m,
        P=None if sparse_mode else _f64(solver._data.P),
        A=None if sparse_mode else _f64(solver._data.A),
        is_sparse=sparse_mode,
        q=_f64(solver._data.q),
        l=_f64(solver._data.l),
        u=_f64(solver._data.u),
        D=_f64(solver._scal.D),
        E=_f64(solver._scal.E),
        c=float(solver._scal.c),
        rho_vec=_f64(solver._rho.rho_vec),
        settings=solver._stg,
        P_triu=solver._P_triu_pattern.copy(),
        A_pattern=solver._A_pattern.copy(),
    )


def _scale_pattern_csc(S, rowscale, colscale, mult=1.0):
    """rowscale[i]*S[i,j]*colscale[j]*mult with the exact nnz pattern kept
    (explicit zeros included: diags@S@diags matmuls may prune them, which
    would desynchronize the update_data_mat index maps)."""
    S = sp.csc_matrix(S, copy=True)
    cols = np.repeat(np.arange(S.shape[1]), np.diff(S.indptr))
    S.data = S.data * rowscale[S.indices] * colscale[cols] * mult
    return S


def _csr_pos_map(S):
    """dict {(row, col): data position} for a CSR matrix."""
    S = S.tocsr()
    S.sort_indices()
    pos = {}
    for i in range(S.shape[0]):
        for k in range(S.indptr[i], S.indptr[i + 1]):
            pos[(i, int(S.indices[k]))] = k
    return pos


def generate(model, folder, parameters='vectors', extension_name='emosqp',
             force_rewrite=False, use_float=False, prefix='', compile=False,
             printing_enable=False, profiling_enable=False,
             interrupt_enable=False, derivatives_enable=False,
             embedded_algebra='auto'):
    """Emit the embedded C project for the port ``OSQP`` ``model``.

    The enable flags compile the corresponding subsystem in or out of the
    emitted C (printing = progress rows via printf, profiling =
    clock_gettime run_time, interrupt = cooperative interrupt flag polled at
    termination checks, derivatives = reserved define, always emitted for
    parity).

    ``embedded_algebra`` selects the emitted linear algebra:

    - ``'dense'``  - dense P/A and a baked Cholesky factor; O(n^2) statics.
    - ``'sparse'`` - CSR P/A/A' and a Jacobi-PCG KKT solve; O(nnz) statics.
    - ``'auto'``   - sparse when the model runs in sparse mode or the dense
      workspace would exceed ~200k entries.

    Returns the folder, with a trailing separator."""
    ws = export_workspace(model._solver)
    mode = 1 if parameters == 'vectors' else 2
    n, m = ws['n'], ws['m']
    stg = ws['settings']

    if embedded_algebra not in ('auto', 'dense', 'sparse'):
        raise ValueError(
            f"embedded_algebra must be 'auto', 'dense' or 'sparse', "
            f"got {embedded_algebra!r}"
        )
    if embedded_algebra == 'auto':
        embedded_algebra = (
            'sparse' if (ws.get('is_sparse') or n * n + m * n > 200_000)
            else 'dense'
        )
    sparse_mode = embedded_algebra == 'sparse'

    cfloat = 'float' if use_float else 'double'
    npy_float = 'NPY_FLOAT32' if use_float else 'NPY_FLOAT64'

    folder = os.path.abspath(folder)
    os.makedirs(folder, exist_ok=True)

    # triu-CSC pattern in data order (row, col per data index)
    P_triu = ws['P_triu'].tocsc()
    P_rows = P_triu.indices
    P_cols = np.repeat(np.arange(n), np.diff(P_triu.indptr))
    A_csc = ws['A_pattern'].tocsc()
    A_rows = A_csc.indices
    A_cols = np.repeat(np.arange(n), np.diff(A_csc.indptr))

    if sparse_mode:
        # scaled CSR operands (full symmetric P, A, A') built from the
        # original pattern matrices so explicit stored zeros survive (a
        # csr_matrix(dense) rebuild would drop them and KeyError the
        # update_data_mat index maps below)
        P_full_pat = triu_to_full(P_triu)
        D, E, c = ws['D'], ws['E'], ws['c']
        P_csr = _scale_pattern_csc(P_full_pat, D, D, c).tocsr()
        A_csr = (_scale_pattern_csc(A_csc, E, D).tocsr() if m
                 else sp.csr_matrix((0, n)))
        P_csr.sort_indices()
        A_csr.sort_indices()
        At_csr = A_csr.T.tocsr()
        At_csr.sort_indices()
        diag_M = (np.asarray(P_csr.diagonal()).ravel() + stg.sigma
                  + (np.asarray((A_csr.multiply(A_csr)).T @ ws['rho_vec']).ravel()
                     if m else 0.0))
        L = None
    else:
        if ws.get('P') is None:
            raise ValueError(
                "dense embedded_algebra on a sparse-mode model; pass "
                "embedded_algebra='sparse'"
            )
        # bake the Cholesky factor of M = P + sigma I + A' diag(rho) A
        M = ws['P'] + stg.sigma * np.eye(n)
        if m:
            M = M + ws['A'].T @ (ws['rho_vec'][:, None] * ws['A'])
        L = np.linalg.cholesky(M)

    tokens = {
        '@PREFIX@': prefix,
        '@PREFIX_UPPER@': (prefix or 'OSQP_TPU_').upper(),
        '@N@': str(n),
        '@M@': str(m),
        '@M_OR_1@': str(max(m, 1)),
        '@MODE@': str(mode),
        '@FLOAT@': cfloat,
        '@NPY_FLOAT@': npy_float,
        '@EXT_NAME@': extension_name or 'emosqp',
        '@PROFILING@': '1' if profiling_enable else '0',
        '@PRINTING@': '1' if printing_enable else '0',
        '@INTERRUPT@': '1' if interrupt_enable else '0',
        '@DERIVATIVES@': '1' if derivatives_enable else '0',
        # f32: 1e-7 sits at the f32 rounding floor and stagnates CG into
        # its full iteration cap; 2e-6 is reliably reachable
        '@CG_TOL@': '2e-6' if use_float else '1e-12',
        '@CG_STAGNATION@': '1' if use_float else '0',
        '@CG_MAX_ITER@': str(max(2 * n, 100)),
    }
    if sparse_mode:
        tokens['@EXTRA_WORK@'] = f'    emb_float_t xt[{n}];\n'
        tokens['@MATRIX_DECLS@'] = '\n'.join([
            f'extern {cfloat} {prefix}P_data[];',
            f'extern int {prefix}P_indices[];',
            f'extern int {prefix}P_indptr[];',
            f'extern {cfloat} {prefix}A_data[];',
            f'extern int {prefix}A_indices[];',
            f'extern int {prefix}A_indptr[];',
            f'extern {cfloat} {prefix}At_data[];',
            f'extern int {prefix}At_indices[];',
            f'extern int {prefix}At_indptr[];',
            f'extern {cfloat} {prefix}diag_M[];',
        ])
    else:
        tokens['@EXTRA_WORK@'] = ''
        tokens['@MATRIX_DECLS@'] = '\n'.join([
            f'extern {cfloat} {prefix}P[];',
            f'extern {cfloat} {prefix}A[];',
            f'extern {cfloat} {prefix}L[];',
        ])
    if mode == 2:
        tokens['@PATTERN_DECLS@'] = (
            f'#define {prefix}P_nnz {len(P_rows)}\n'
            f'#define {prefix}A_nnz {len(A_rows)}\n'
            f'extern int {prefix}P_pat_row[];\n'
            f'extern int {prefix}P_pat_col[];\n'
            f'extern int {prefix}A_pat_row[];\n'
            f'extern int {prefix}A_pat_col[];\n'
            + (
                f'extern int {prefix}P_map1[];\n'
                f'extern int {prefix}P_map2[];\n'
                f'extern int {prefix}A_map[];\n'
                f'extern int {prefix}At_map[];\n'
                if sparse_mode else ''
            )
        )
    else:
        tokens['@PATTERN_DECLS@'] = ''

    def render(template):
        out = template
        for k, v in tokens.items():
            out = out.replace(k, v)
        return out

    # workspace.c: baked data definitions
    defs = [
        f'#include "{prefix}workspace.h"',
        '',
        f'{prefix}Settings {prefix}settings = {{'
        f'{stg.eps_abs:.17g}, {stg.eps_rel:.17g}, {stg.eps_prim_inf:.17g}, '
        f'{stg.eps_dual_inf:.17g}, {stg.alpha:.17g}, {stg.sigma:.17g}, '
        f'{stg.rho:.17g}, {int(stg.max_iter)}, '
        f'{max(int(stg.check_termination), 1)}, {int(bool(stg.warm_starting))}, '
        f'{int(bool(stg.adaptive_rho))}, {_adaptive_interval(stg)}}};',
        f'{prefix}Workspace {prefix}work;',
    ]
    if sparse_mode:
        defs += [
            _carray(f'{prefix}P_data', P_csr.data, cfloat),
            _carray(f'{prefix}P_indices', P_csr.indices, 'int'),
            _carray(f'{prefix}P_indptr', P_csr.indptr, 'int'),
            _carray(f'{prefix}A_data', A_csr.data, cfloat),
            _carray(f'{prefix}A_indices', A_csr.indices, 'int'),
            _carray(f'{prefix}A_indptr', A_csr.indptr, 'int'),
            _carray(f'{prefix}At_data', At_csr.data, cfloat),
            _carray(f'{prefix}At_indices', At_csr.indices, 'int'),
            _carray(f'{prefix}At_indptr', At_csr.indptr, 'int'),
            _carray(f'{prefix}diag_M', diag_M, cfloat),
        ]
    else:
        defs += [
            _carray(f'{prefix}P', ws['P'], cfloat),
            _carray(f'{prefix}A', ws['A'], cfloat),
            _carray(f'{prefix}L', L, cfloat),
        ]
    defs += [
        _carray(f'{prefix}q', ws['q'], cfloat),
        _carray(f'{prefix}l', ws['l'], cfloat),
        _carray(f'{prefix}u', ws['u'], cfloat),
        _carray(f'{prefix}rho_vec', ws['rho_vec'], cfloat),
        _carray(f'{prefix}rho_inv_vec', 1.0 / ws['rho_vec'] if m else np.zeros(0), cfloat),
        _carray(f'{prefix}D', ws['D'], cfloat),
        _carray(f'{prefix}Dinv', 1.0 / ws['D'], cfloat),
        _carray(f'{prefix}E', ws['E'], cfloat),
        _carray(f'{prefix}Einv', 1.0 / ws['E'] if m else np.zeros(0), cfloat),
        f'{cfloat} {prefix}c_scale = {ws["c"]:.17g};',
        f'{cfloat} {prefix}cinv = {1.0 / ws["c"]:.17g};',
        _carray(f'{prefix}sol_x', np.zeros(n), cfloat),
        _carray(f'{prefix}sol_y', np.zeros(max(m, 1)), cfloat),
        _carray(f'{prefix}constr_type', _constr_types(ws), 'signed char'),
    ]
    if mode == 2:
        defs += [
            _carray(f'{prefix}P_pat_row', P_rows, 'int'),
            _carray(f'{prefix}P_pat_col', P_cols, 'int'),
            _carray(f'{prefix}A_pat_row', A_rows, 'int'),
            _carray(f'{prefix}A_pat_col', A_cols, 'int'),
        ]
        if sparse_mode:
            # user-data-order (triu CSC) index -> CSR data positions
            p_pos = _csr_pos_map(P_csr)
            a_pos = _csr_pos_map(A_csr)
            at_pos = _csr_pos_map(At_csr)
            P_map1 = [p_pos[(int(r), int(c))] for r, c in zip(P_rows, P_cols)]
            P_map2 = [p_pos[(int(c), int(r))] if r != c else -1
                      for r, c in zip(P_rows, P_cols)]
            A_map = [a_pos[(int(r), int(c))] for r, c in zip(A_rows, A_cols)]
            At_map = [at_pos[(int(c), int(r))] for r, c in zip(A_rows, A_cols)]
            defs += [
                _carray(f'{prefix}P_map1', P_map1, 'int'),
                _carray(f'{prefix}P_map2', P_map2, 'int'),
                _carray(f'{prefix}A_map', A_map, 'int'),
                _carray(f'{prefix}At_map', At_map, 'int'),
            ]

    solver_template = ctemplates.SOLVER_SPARSE_C if sparse_mode else ctemplates.SOLVER_C
    files = {
        f'{prefix}workspace.h': render(ctemplates.WORKSPACE_H),
        f'{prefix}workspace.c': '\n'.join(defs) + '\n',
        f'{prefix}emosqp_solver.c': render(solver_template),
        'CMakeLists.txt': render(ctemplates.CMAKELISTS),
    }
    if extension_name is not None:
        files[f'{extension_name}_module.c'] = render(ctemplates.MODULE_C).replace(
            "'(NNiid)'", '"(NNiid)"'
        )
        files['setup.py'] = render(ctemplates.SETUP_PY)

    for name, content in files.items():
        path = os.path.join(folder, name)
        if os.path.exists(path) and not force_rewrite:
            raise ValueError(f'{path} exists; pass force_rewrite=True')
        with open(path, 'w') as f:
            f.write(content)

    if extension_name is not None and compile:
        subprocess.check_call(
            [sys.executable, 'setup.py', 'build_ext', '--inplace'],
            cwd=folder,
            stdout=subprocess.DEVNULL,
        )

    if not folder.endswith(os.path.sep):
        folder += os.path.sep
    return folder


# ---------------------------------------------------------------------------
# export_aot: the solve as a torch.export program
# ---------------------------------------------------------------------------


class AotResult(NamedTuple):
    x: torch.Tensor  # unscaled primal (NaN if infeasible)
    y: torch.Tensor  # unscaled dual (NaN if infeasible)
    status: torch.Tensor  # int32
    iters: torch.Tensor  # int32
    cg_iters: torch.Tensor  # int32, PCG steps (0 in direct mode)
    rho_updates: torch.Tensor  # int32


class AotSolve:
    """An exported solve: ``self(q, l, u) -> (x, y, status, iters)``, as the
    JAX package's compiled executable returns them; ``solve(q, l, u)``
    returns those with the CG steps and rho updates (``AotResult``).
    ``program`` is the ``torch.export.ExportedProgram``, which
    ``torch.export.save`` and ``load`` serialize.  Inputs may be tensors or
    arrays; they are taken as ``dtype`` on ``device``, the example inputs'
    dtype and device."""

    def __init__(self, program, dtype, device):
        self.program = program
        self.dtype = dtype
        self.device = torch.device(device)
        self._module = program.module()

    def solve(self, q, l, u) -> AotResult:
        args = (torch.as_tensor(v, dtype=self.dtype, device=self.device) for v in (q, l, u))
        return AotResult(*self._module(*args))

    def __call__(self, q, l, u):
        return tuple(self.solve(q, l, u)[:4])


def export_aot(model, dtype=None):
    """The counterpart of the JAX package's ``export_aot``: the fixed-shape
    solve ``solve(q, l, u) -> (x, y, status, iters)`` of the port ``OSQP``
    ``model`` as a ``torch.export`` program on the model's device, with the
    problem structure, scaling, rho state and factorization baked in as
    buffers.  It solves from zero iterates, in the model's working dtype;
    ``dtype`` is the dtype of the q, l and u it takes (default: the model's).
    Returns an ``AotSolve``.  The exported loop covers the 'torch' algebra;
    an 'ldl' model raises ``ValueError``."""
    from ..solver.core_graph import ExportedSolve

    solver = model._solver
    if getattr(solver, 'ALGEBRA', None) != 'torch':
        raise ValueError("export_aot exports the 'torch' algebra's solve loop only")
    dt_in = solver._dtype if dtype is None else dtype
    module = ExportedSolve(solver)
    dev = solver._device
    example = tuple(torch.zeros((k,), dtype=dt_in, device=dev)
                    for k in (solver.n, solver.m, solver.m))
    program = torch.export.export(module, example, strict=False)
    return AotSolve(program, dt_in, dev)
