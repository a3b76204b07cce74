"""Huge-QP mode: ONE sparse QP whose rows are split over a mesh.

Counterpart of ``osqp_tpu/parallel/bigqp.py``.  The rows of the sparse P and
A are split into J contiguous blocks, one a shard, with the matching slices
of z, y, l, u and rho; x and q are replicated.  The reduced-KKT (Schur)
operator ``M v = P v + sigma v + A' rho (A v)`` is never formed: each CG step
applies it with one ``all_gather`` (of the local ``P v`` row slices) and one
``psum`` (of the local ``A' rho A v`` partials).  The math is the vector-rho
ADMM of the single-device indirect solver (the loop in ``_admm``), so the
mesh only changes where each row block lives.

The JAX package keeps each block as a padded BCOO; here each is the port's
``ops.spmv.CooMatrix`` (``torch.sparse`` CSR, cuSPARSE on the card), built
once per (mesh, data) from the padded arrays with the zero pads dropped: the
same correspondence as the single-QP path's BCOO fallback.  No hand-written
kernel runs on this path (the JAX package runs none on it either).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..constants import OSQP_INFTY
from ..device import resolve_device
from ..ops.spmv import CooMatrix, _csr_tensor
from ..settings import np_dtype
from ..solver.core import _inf_norm
from ..utils.scaling_host import ruiz_scale_scipy
from . import _admm
from ._admm import _RHO_MIN, host_bounds, host_typing, pad_blocks
from .mesh import Parts, each


class BigQPData(NamedTuple):
    """Host-prepared sharded problem (leading axis J = number of shards),
    on one device; the solve distributes it over the mesh."""

    pdata: torch.Tensor  # (J, nnzP) padded local P row-block values
    pidx: torch.Tensor  # (J, nnzP, 2) int32 (local row, global col)
    adata: torch.Tensor  # (J, nnzA)
    aidx: torch.Tensor  # (J, nnzA, 2)
    q: torch.Tensor  # (n,) scaled, replicated
    l: torch.Tensor  # (J, m_loc) scaled row slices (padding: -INFTY)
    u: torch.Tensor  # (J, m_loc) (padding: +INFTY)
    rho_vec: torch.Tensor  # (J, m_loc) (padding: RHO_MIN, loose rows)
    types: torch.Tensor  # (J, m_loc) int8: -1 loose, 0 ineq, 1 eq
    diag_M: torch.Tensor  # (n,) CG preconditioner diag(P + sigma I + A' rho A)
    D: torch.Tensor  # (n,) Ruiz scalers (replicated)
    Dinv: torch.Tensor
    E: torch.Tensor  # (J, m_loc) (padding: 1.0)
    Einv: torch.Tensor
    c: torch.Tensor  # () cost scaling
    cinv: torch.Tensor
    n: int
    m: int
    n_loc: int  # padded P row-block height
    m_loc: int  # padded A row-block height
    sigma: float = 1e-6
    rho0: float = 0.1
    rho_is_vec: bool = True


class BigQPResult(NamedTuple):
    """The JAX package's fields, on the mesh's first device, then the host
    counts of the port's loop."""

    x: torch.Tensor  # (n,) unscaled primal (NaN if infeasible)
    y: torch.Tensor  # (m,) unscaled dual (NaN if infeasible)
    z: torch.Tensor  # (m,) scaled z iterate (for warm restarts)
    status: int
    iters: int
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    obj_val: torch.Tensor
    rho: torch.Tensor
    rho_updates: int
    prim_inf_cert: torch.Tensor  # (m,) unscaled delta_y certificate
    dual_inf_cert: torch.Tensor  # (n,) unscaled delta_x certificate
    status_polish: int  # 1 accepted, -1 rejected, 0 not attempted
    cg_iters: int = 0  # CG steps, polish included
    host_syncs: int = 0
    cg_cap_hits: int = 0  # CG solves stopped by cg_max_iter


def _pad_rows_coo(S, J, blk, nnz_pad):
    """Split a scipy sparse matrix into J contiguous row blocks of height
    ``blk``; return (J, nnz_pad) data and (J, nnz_pad, 2) [local row, col]
    indices, zero-padded (zero data at index (0, 0))."""
    S = S.tocoo()
    block = S.row // blk
    data = np.zeros((J, nnz_pad), S.dtype)
    idx = np.zeros((J, nnz_pad, 2), np.int32)
    for j in range(J):
        sel = block == j
        k = int(sel.sum())
        if k > nnz_pad:
            raise ValueError('nnz_pad too small')
        data[j, :k] = S.data[sel]
        idx[j, :k, 0] = S.row[sel] - j * blk
        idx[j, :k, 1] = S.col[sel]
    return data, idx


def scale_host(P_sp, q, A_sp, l, u, scaling):
    """Ruiz scaling on the host (float64), or the identity."""
    n, m = P_sp.shape[0], A_sp.shape[0]
    if scaling > 0:
        return ruiz_scale_scipy(P_sp, A_sp, q, l, u, scaling)
    return (sp.csc_matrix(P_sp, dtype=np.float64), sp.csc_matrix(A_sp, dtype=np.float64),
            np.asarray(q, np.float64), np.asarray(l, np.float64), np.asarray(u, np.float64),
            np.ones(n), np.ones(m), 1.0)


def big_qp_setup(P_sp, q, A_sp, l, u, J, *, scaling=10, sigma=1e-6, rho=0.1,
                 rho_is_vec=True, dtype=torch.float64, device=None) -> BigQPData:
    """Host-side preparation: Ruiz scaling, rho typing, row partitioning.

    ``J`` is the number of shards (the mesh axis' size).  P must be the FULL
    symmetric matrix (not triu).  The data lands on ``device`` (CUDA unless
    given; raises without CUDA)."""
    device = resolve_device(device)
    n, m = P_sp.shape[0], A_sp.shape[0]
    P_s, A_s, q_s, l_s, u_s, D, E, c = scale_host(P_sp, q, A_sp, l, u, scaling)
    types, rho_vec, rho0 = host_typing(l_s, u_s, rho, rho_is_vec)

    n_loc = -(-n // J)
    m_loc = -(-m // J)
    nnzP = max(-(-int(P_s.nnz) // J) * 2, 8)
    nnzA = max(-(-int(A_s.nnz) // J) * 2, 8)
    pdata, pidx = _pad_rows_coo(P_s, J, n_loc, nnzP)
    adata, aidx = _pad_rows_coo(A_s, J, m_loc, nnzA)

    def padm(v, fill):
        return np.pad(v, (0, J * m_loc - m), constant_values=fill).reshape(J, m_loc)

    # CG preconditioner diagonal, computed once on the host (O(nnz))
    A_csc = A_s.tocsc()
    gram = np.asarray((A_csc.multiply(A_csc)).T @ rho_vec).ravel()
    diag_M = np.asarray(P_s.diagonal()).ravel() + sigma + gram

    f = np_dtype(dtype)

    def t(v, dt=f):
        return torch.as_tensor(np.asarray(v, dt), device=device)

    return BigQPData(
        pdata=t(pdata), pidx=t(pidx, np.int32), adata=t(adata), aidx=t(aidx, np.int32),
        q=t(q_s), l=t(padm(l_s, -OSQP_INFTY)), u=t(padm(u_s, OSQP_INFTY)),
        rho_vec=t(padm(rho_vec, _RHO_MIN)), types=t(padm(types, -1), np.int8),
        diag_M=t(diag_M), D=t(D), Dinv=t(1.0 / D), E=t(padm(E, 1.0)),
        Einv=t(padm(1.0 / E, 1.0)), c=t(c), cinv=t(1.0 / c),
        n=n, m=m, n_loc=n_loc, m_loc=m_loc, sigma=float(sigma), rho0=rho0,
        rho_is_vec=bool(rho_is_vec))


def _csr(data, idx, shape, device):
    """A CSR tensor from one shard's padded COO arrays, pads dropped and
    duplicates summed."""
    keep = data != 0
    rows, cols = idx[keep, 0].long(), idx[keep, 1].long()
    with warnings.catch_warnings():  # "sparse invariant checks are disabled"
        warnings.simplefilter('ignore', UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), data[keep], shape,
                                      check_invariants=False).coalesce()
    ij = coo.indices()
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(torch.bincount(ij[0], minlength=shape[0]), 0)
    return _csr_tensor(crow, ij[1].contiguous(), coo.values(), shape)


def _local_blocks(mesh, data: BigQPData, axis):
    """Each shard's P and A row blocks as CooMatrix operators on its
    device, built once per mesh and data matrices."""
    mesh.check(data.pdata)
    n, n_loc, m_loc = data.n, data.n_loc, data.m_loc

    def build():
        P_loc, A_loc = [], []
        for j, d in enumerate(mesh.device_list):
            j_ax = mesh.coords(j)[axis]
            pd, pi = data.pdata[j_ax].to(d), data.pidx[j_ax].to(d)
            ad, ai = data.adata[j_ax].to(d), data.aidx[j_ax].to(d)
            P_loc.append(CooMatrix(_csr(pd, pi, (n_loc, n), d),
                                   _csr(pd, pi.flip(1), (n, n_loc), d),
                                   torch.zeros(0, dtype=pd.dtype, device=d), (n_loc, n)))
            A_loc.append(CooMatrix(_csr(ad, ai, (m_loc, n), d),
                                   _csr(ad, ai.flip(1), (n, m_loc), d),
                                   torch.zeros(0, dtype=ad.dtype, device=d), (m_loc, n)))
        return Parts(P_loc), Parts(A_loc)

    return mesh.memo((data.pdata, data.pidx, data.adata, data.aidx), build)


def _bigqp_ops(mesh, data, axis):
    P_loc, A_loc = _local_blocks(mesh, data, axis)
    At_loc = A_loc.map(lambda a: a.T)
    n = data.n

    def pmax_inf(v):
        return mesh.pmax(v.map(_inf_norm), axis)

    return _admm.Operators(
        Pmv=lambda v: mesh.all_gather(P_loc @ v, axis, size=n),
        Amv=lambda v: A_loc @ v,
        Atmv=lambda w: mesh.psum(At_loc @ w, axis),
        gram=lambda rho: mesh.psum(each(lambda a, r: a.gram_diag(r), A_loc, rho), axis),
        dot_x=lambda a, b: each(torch.dot, a, b),
        max_x=lambda v: v.map(_inf_norm),
        max_y=pmax_inf,
        sum_y=lambda v: mesh.psum(v.map(torch.sum), axis))


def _check_mesh(mesh, J, axis):
    if mesh.shape[axis] != J or mesh.size != J:
        raise ValueError(f'the data has {J} shards; the mesh must be 1-D along {axis!r} with '
                         f'{J} shards, got {mesh.shape}')


def _make_bigqp_run(mesh, data: BigQPData, *, axis='mp', **settings):
    """The solver for this (mesh, data, settings): ``run(q, x, z, y)`` over
    Parts (q and x replicated, z and y row slices), returning an
    ``_admm.RunOut``.  Settings (eps, max_iter, check_every, adaptive rho,
    cg_tol, cg_max_iter, polish, sigma) and their defaults are the JAX
    package's."""
    _check_mesh(mesh, data.l.shape[0], axis)
    rows = lambda t: mesh.shards(t, axis)  # noqa: E731
    prob = _admm.Problem(
        q=mesh.replicate(data.q), l=rows(data.l), u=rows(data.u), rho_vec=rows(data.rho_vec),
        types=rows(data.types), diag_M=mesh.replicate(data.diag_M),
        D=mesh.replicate(data.D), Dinv=mesh.replicate(data.Dinv), E=rows(data.E),
        Einv=rows(data.Einv), c=mesh.replicate(data.c), cinv=mesh.replicate(data.cinv))
    return _admm.make_run(mesh, _bigqp_ops(mesh, data, axis), prob, n=data.n,
                          dtype=data.q.dtype, data_sigma=data.sigma, rho0=data.rho0,
                          **settings), prob


def _bigqp_inits(mesh, data, x0, z0, y0, axis):
    x = pad_blocks(x0, data.n, data.q)
    return (mesh.replicate(x), mesh.shards(pad_blocks(z0, data.m, data.l), axis),
            mesh.shards(pad_blocks(y0, data.m, data.l), axis))


def _result(mesh, out, axis, m, x_rows):
    """A BigQPResult on the mesh's first device from a run's Parts (x
    replicated unless ``x_rows``, y, z and the primal certificate rows)."""
    rows = lambda v, k: mesh.join(v, (axis,))[:k]  # noqa: E731
    x = rows(out.x_out, x_rows) if x_rows else out.x_out[0].clone()
    dual = rows(out.dual_cert, x_rows) if x_rows else out.dual_cert[0].clone()
    return BigQPResult(
        x=x, y=rows(out.y_out, m), z=rows(out.z, m), status=out.status, iters=out.iters,
        pri_res=out.pri[0], dua_res=out.dua[0], obj_val=out.obj[0], rho=out.rho[0],
        rho_updates=out.rho_updates, prim_inf_cert=rows(out.prim_cert, m), dual_inf_cert=dual,
        status_polish=out.status_polish, cg_iters=out.cg_iters, host_syncs=out.host_syncs,
        cg_cap_hits=out.cg_cap_hits)


@torch.no_grad()
def big_qp_solve(mesh, data: BigQPData, *, x0=None, z0=None, y0=None, axis='mp',
                 **settings) -> BigQPResult:
    """Solve the sharded QP.  ``x0``/``z0``/``y0`` warm-start with scaled
    iterates (length n, m, m: a previous result's z, its x and y scaled
    back, or zeros).  Returns unscaled x and y like the single-device
    solver.  Settings are ``_make_bigqp_run``'s."""
    run, prob = _make_bigqp_run(mesh, data, axis=axis, **settings)
    out = run(prob.q, *_bigqp_inits(mesh, data, x0, z0, y0, axis))
    return _result(mesh, out, axis, data.m, None)


# ---------------------------------------------------------------------------
# MPC workload surface: vector updates + warm rollout
# (ref update semantics osqppurepy/_osqp.py:1312-1429)
# ---------------------------------------------------------------------------


def _host_gram(data: BigQPData, rho_pad):
    """gram[col] = sum_entries A[row, col]^2 * rho[row], on the host from
    the padded row-block COO arrays (padding entries carry zero data)."""
    ad = data.adata.cpu().numpy().astype(np.float64)     # (J, nnzA)
    ai = data.aidx.cpu().numpy().astype(np.int64)        # (J, nnzA, 2)
    gram = np.zeros(data.n)
    vals = (ad * ad) * np.take_along_axis(np.asarray(rho_pad, np.float64), ai[:, :, 0], axis=1)
    np.add.at(gram, ai[:, :, 1].ravel(), vals.ravel())
    return gram


def _host(t):
    return t.cpu().numpy().astype(np.float64)


def big_qp_update_vec(data: BigQPData, q=None, l=None, u=None) -> BigQPData:
    """Update q, l and u without re-running setup: rescale with the cached
    Ruiz scalers; on bound changes re-type the constraints, rebuild the
    typed rho vector from the setup-time rho and refresh the CG
    preconditioner diagonal (O(nnz) host work).  Returns a new BigQPData
    with the same matrices (their cached blocks stay valid)."""
    J, m_loc = data.l.shape
    n, m = data.n, data.m
    dt, dev = data.q.dtype, data.q.device

    def padm(v, fill):
        return np.pad(np.asarray(v, np.float64), (0, J * m_loc - m),
                      constant_values=fill).reshape(J, m_loc)

    def t(v, dtype=dt):
        return torch.as_tensor(np.asarray(v), device=dev).to(dtype)

    if q is not None:
        q = np.asarray(q, np.float64).ravel()
        if q.shape != (n,):
            raise ValueError(f'q must have shape ({n},)')
        data = data._replace(q=t(float(data.c) * (_host(data.D) * q)))

    if l is None and u is None:
        return data

    E = _host(data.E).reshape(-1)[:m]
    l_new, u_new = host_bounds(_host(data.l).reshape(-1)[:m], _host(data.u).reshape(-1)[:m],
                               E, l, u, m)
    types, rho_vec, _ = host_typing(l_new, u_new, data.rho0, data.rho_is_vec)
    rho_pad = padm(rho_vec, _RHO_MIN)
    diag_M = _host(data.diag_M) - _host_gram(data, _host(data.rho_vec)) + _host_gram(data, rho_pad)
    return data._replace(
        l=t(padm(l_new, -OSQP_INFTY)), u=t(padm(u_new, OSQP_INFTY)), rho_vec=t(rho_pad),
        types=t(padm(types, -1), torch.int8), diag_M=t(diag_M))


class BigQPRollout(NamedTuple):
    """Per-step results of a warm MPC rollout, on the mesh's first device,
    plus the final scaled iterates (feed them back as x0/z0/y0); then the
    port's per-step duals and host counts."""

    x: torch.Tensor        # (T, n) unscaled per-step solutions
    iters: torch.Tensor    # (T,)
    status: torch.Tensor   # (T,)
    obj_val: torch.Tensor  # (T,)
    x_carry: torch.Tensor  # (n,) scaled
    z_carry: torch.Tensor  # (J, m_loc) scaled
    y_carry: torch.Tensor
    y: torch.Tensor = None  # (T, m) unscaled per-step duals
    cg_iters: tuple = ()  # per step
    host_syncs: tuple = ()  # per step


@torch.no_grad()
def big_qp_mpc_rollout(mesh, data: BigQPData, q_seq, *, x0=None, z0=None, y0=None,
                       axis='mp', **settings) -> BigQPRollout:
    """Warm MPC rollout on the row-sharded mode: a host loop over a (T, n)
    sequence of UNSCALED cost vectors, carrying the scaled iterates between
    steps; results stay on the device.  An infeasible step, or a NaN in x,
    zeroes the carried iterates (a cold restart next step); a non-finite or
    blown-up (> 1e30) element is zeroed.  A max-iter step's iterates carry
    on."""
    n = data.n
    run, prob = _make_bigqp_run(mesh, data, axis=axis, **settings)
    qs = torch.as_tensor(q_seq, dtype=data.q.dtype, device=data.q.device)
    if qs.dim() != 2 or qs.shape[1] != n:
        raise ValueError(f'q_seq must have shape (T, {n})')
    # c * (D * q): the order of update_vec's scaling, so a rollout step is
    # the update-and-solve loop's bit for bit
    q_scaled = data.c * (data.D[None] * qs)
    x, z, y = _bigqp_inits(mesh, data, x0, z0, y0, axis)
    xs, ys, its, sts, objs, cgs, syncs = [], [], [], [], [], [], []
    for q_t in q_scaled:
        out = run(mesh.replicate(q_t), x, z, y)
        x, y, z = _admm.clean_carry(mesh, out.x_out, out.status, out.x_out * prob.Dinv,
                                    out.y_out * prob.c * prob.Einv, out.z)
        xs.append(out.x_out[0].clone())
        ys.append(mesh.join(out.y_out, (axis,))[:data.m])
        its.append(out.iters)
        sts.append(out.status)
        objs.append(out.obj[0])
        cgs.append(out.cg_iters)
        syncs.append(out.host_syncs)
    d0 = mesh.device_list[0]
    return BigQPRollout(
        x=torch.stack(xs), iters=torch.tensor(its, device=d0),
        status=torch.tensor(sts, dtype=torch.int32, device=d0), obj_val=torch.stack(objs),
        y=torch.stack(ys), cg_iters=tuple(cgs), host_syncs=tuple(syncs),
        x_carry=x[0].clone(), z_carry=mesh.join(z.map(lambda v: v[None]), (axis,)),
        y_carry=mesh.join(y.map(lambda v: v[None]), (axis,)))
