"""Distributed BANDED huge-QP mode: halo-exchange DIA over a mesh.

Counterpart of ``osqp_tpu/parallel/banded.py``.  Everything is split into
contiguous row blocks of L rows, x included; each shard keeps its block's
DIA bands and, for every product, receives only W-wide halos from its two
neighbours (``Mesh.halo_window``), W being the bandwidth.  Communication per
CG step is O(W) per shard (two halo exchanges, P v and A v sharing one, and
two ``psum``s of one or two scalars) instead of ``bigqp``'s O(n); the math is
the same vector-rho ADMM (the loop in ``_admm``).

m != n is handled by padding both to J*L: extra rows are loose (rho =
RHO_MIN, bounds +-INFTY) and extra variables are free with unit curvature
(P_ii = 1, q_i = 0, no coupling), which pins them to 0.

**Where a TPU kernel runs.**  The local product on the halo window,
``sum_d bands[d] * w[W + o_d : W + o_d + L]``, is the DIA matvec of K2
(``tools/proto_dia_pallas.py``): ``dia_matvec(bands (D, L), offsets + W,
window (L + 2W,))`` with ``m_out = L`` and ``n_in = L + 2W``.  Every
``Pmv``, ``Amv``, ``Atmv`` and ``gram`` goes through
``ops.dia_matvec.dia_matvec``: the hand-written kernel on the card (it
raises rather than fall back), its plain version on the CPU, which sums in
offset order as the JAX package's slices do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..constants import OSQP_INFTY
from ..device import resolve_device
from ..ops.dia_matvec import dia_matvec
from ..ops.spmv import _dia_arrays
from ..settings import np_dtype
from ..solver.core import _inf_norm
from . import _admm
from ._admm import _RHO_MIN, host_bounds, host_typing, pad_blocks
from .bigqp import BigQPResult, _check_mesh, _host, _result, scale_host
from .mesh import each


class BandedQPData(NamedTuple):
    """Host-prepared sharded banded problem (leading axis J = #shards), on
    one device.

    Band arrays are (J, D, L): shard j holds the bands of its L global rows.
    All vectors are (J, L) row slices.  Offsets are host tuples.
    """

    p_bands: torch.Tensor   # (J, Dp, L)
    a_bands: torch.Tensor   # (J, Da, L)
    at_bands: torch.Tensor  # (J, Dt, L)  bands of A'
    a2t_bands: torch.Tensor  # (J, Dt, L) bands of (A')^2 elementwise (gram diag)
    q: torch.Tensor         # (J, L) scaled
    l: torch.Tensor         # (J, L) (padding: -INFTY)
    u: torch.Tensor         # (J, L) (padding: +INFTY)
    rho_vec: torch.Tensor   # (J, L) (padding: RHO_MIN)
    types: torch.Tensor     # (J, L) int8: -1 loose, 0 ineq, 1 eq
    diag_M: torch.Tensor    # (J, L) CG preconditioner diag
    D: torch.Tensor         # (J, L) Ruiz scalers (padding: 1.0)
    Dinv: torch.Tensor
    E: torch.Tensor         # (J, L) (padding: 1.0)
    Einv: torch.Tensor
    c: torch.Tensor
    cinv: torch.Tensor
    offsets_p: tuple
    offsets_a: tuple
    offsets_at: tuple
    n: int
    m: int
    L: int
    sigma: float = 1e-6
    rho0: float = 0.1
    rho_is_vec: bool = True


def _pad_square(S, n_rows, n_cols, N, extra_diag=0.0):
    """Embed an (n_rows, n_cols) sparse matrix into the top-left of (N, N),
    optionally adding ``extra_diag`` on the padded tail of the diagonal."""
    C = S.tocoo()
    data, rows, cols = C.data, C.row, C.col
    if extra_diag and N > n_rows:
        tail = np.arange(n_rows, N)
        data = np.concatenate([data, np.full(N - n_rows, extra_diag)])
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
    return sp.coo_matrix((data, (rows, cols)), shape=(N, N))


def _split_bands(bands, offsets, J, L):
    """(D, N) global bands -> (J, D, L) row blocks (N = J*L)."""
    D = bands.shape[0]
    if D == 0:
        return np.zeros((J, 1, L), bands.dtype), (0,)
    return bands.reshape(D, J, L).transpose(1, 0, 2), offsets


def _halo(offsets_p, offsets_a, offsets_at):
    """The halo width W: the largest |offset| of the three operators."""
    return max((max(abs(o) for o in offs) if offs else 0)
               for offs in (offsets_p, offsets_a, offsets_at))


def banded_qp_setup(P_sp, q, A_sp, l, u, J, *, scaling=10, sigma=1e-6, rho=0.1,
                    rho_is_vec=True, dtype=torch.float64, device=None) -> BandedQPData:
    """Host-side preparation: Ruiz scaling, rho typing, padding to J*L, DIA
    band extraction and row-block splitting; the data lands on ``device``
    (CUDA unless given; raises without CUDA).

    P must be the FULL symmetric matrix (not triu).  Raises if the bandwidth
    exceeds the shard height L (use fewer shards or ``bigqp``)."""
    device = resolve_device(device)
    n, m = P_sp.shape[0], A_sp.shape[0]
    P_s, A_s, q_s, l_s, u_s, D, E, c = scale_host(P_sp, q, A_sp, l, u, scaling)
    types, rho_vec, rho0 = host_typing(l_s, u_s, rho, rho_is_vec)

    L = max(-(-n // J), -(-m // J))
    N = J * L
    # dummy variables: unit curvature, no coupling -> pinned to 0
    P_pad = _pad_square(P_s, n, n, N, extra_diag=1.0)
    A_pad = _pad_square(A_s, m, n, N)

    p_bands_g, offs_p = _dia_arrays(P_pad.tocsr(), np.float64)
    a_bands_g, offs_a = _dia_arrays(A_pad.tocsr(), np.float64)
    at_bands_g, offs_at = _dia_arrays(A_pad.T.tocsr(), np.float64)

    W = _halo(offs_p, offs_a, offs_at)
    if W > L:
        raise ValueError(
            f'bandwidth {W} exceeds shard height {L} (n={n}, m={m}, J={J}); '
            'use fewer shards or parallel.bigqp for this problem')

    p_bands, offs_p = _split_bands(p_bands_g, offs_p, J, L)
    a_bands, offs_a = _split_bands(a_bands_g, offs_a, J, L)
    at_bands, offs_at = _split_bands(at_bands_g, offs_at, J, L)
    a2t_bands = at_bands * at_bands

    def padv(v, size, fill):
        return np.pad(np.asarray(v, np.float64), (0, N - size),
                      constant_values=fill).reshape(J, L)

    rho_pad = padv(rho_vec, m, _RHO_MIN)
    # CG preconditioner diagonal diag(P + sigma I + A' rho A), on the host
    A_csc = A_pad.tocsc()
    gram = np.asarray((A_csc.multiply(A_csc)).T @ rho_pad.reshape(-1)).ravel()
    diag_M = np.asarray(P_pad.diagonal()).ravel() + sigma + gram

    f = np_dtype(dtype)

    def t(v, dt=f):
        return torch.as_tensor(np.asarray(v, dt), device=device).contiguous()

    return BandedQPData(
        p_bands=t(p_bands), a_bands=t(a_bands), at_bands=t(at_bands), a2t_bands=t(a2t_bands),
        q=t(padv(q_s, n, 0.0)), l=t(padv(l_s, m, -OSQP_INFTY)), u=t(padv(u_s, m, OSQP_INFTY)),
        rho_vec=t(rho_pad), types=t(padv(types, m, -1), np.int8),
        diag_M=t(diag_M.reshape(J, L)), D=t(padv(D, n, 1.0)), Dinv=t(padv(1.0 / D, n, 1.0)),
        E=t(padv(E, m, 1.0)), Einv=t(padv(1.0 / E, m, 1.0)), c=t(c), cinv=t(1.0 / c),
        offsets_p=offs_p, offsets_a=offs_a, offsets_at=offs_at,
        n=n, m=m, L=L, sigma=float(sigma), rho0=rho0, rho_is_vec=bool(rho_is_vec))


def _banded_ops(mesh, data: BandedQPData, axis):
    """The halo-exchange products (K2 on each shard's window) and the
    psum/pmax reductions of the fully sharded layout."""
    W = max(1, _halo(data.offsets_p, data.offsets_a, data.offsets_at))

    def shifted(offsets):
        # the window's offsets, kept on each shard's device once
        return mesh.replicate(torch.tensor([W + o for o in offsets], dtype=torch.int32,
                                           device=mesh.device_list[0]))

    p_b, a_b, at_b, a2t_b = (mesh.shards(b, axis) for b in (
        data.p_bands, data.a_bands, data.at_bands, data.a2t_bands))
    off_p, off_a, off_at = (shifted(o) for o in (data.offsets_p, data.offsets_a,
                                                 data.offsets_at))

    last = [None, None]  # the last vector exchanged and its windows

    def dia_mv(bands, offsets, v):
        """Local rows of (global DIA) @ (sharded v): one halo exchange (kept
        for the next product of the same v: P v and A v share it), then K2
        on the (L + 2W,) window."""
        if last[0] is not v:
            last[:] = v, mesh.halo_window(v, W, axis)
        return each(dia_matvec, bands, offsets, last[1])

    def vmax(v):
        return mesh.pmax(v.map(_inf_norm), axis)

    def dots(*pairs):
        """The dot products of ``pairs``, each summed over the shards in
        shard order, in one psum."""
        if len(pairs) == 1:
            return [mesh.psum(each(torch.dot, *pairs[0]), axis)]
        flat = [t for pair in pairs for t in pair]
        local = each(lambda *v: torch.stack([torch.dot(a, b) for a, b in zip(v[::2], v[1::2])]),
                     *flat)
        s = mesh.psum(local, axis)
        return [s.map(lambda t, k=k: t[k]) for k in range(len(pairs))]

    return _admm.Operators(
        Pmv=lambda v: dia_mv(p_b, off_p, v),
        Amv=lambda v: dia_mv(a_b, off_a, v),
        Atmv=lambda w: dia_mv(at_b, off_at, w),
        gram=lambda rho: dia_mv(a2t_b, off_at, rho),
        dots=dots,
        max_x=vmax, max_y=vmax,
        sum_y=lambda v: mesh.psum(v.map(torch.sum), axis))


def _make_banded_run(mesh, data: BandedQPData, *, axis='mp', **settings):
    """The solver for this (mesh, data, settings): ``run(q, x, z, y)`` over
    (L,) row blocks, returning an ``_admm.RunOut``.  Settings are
    ``bigqp._make_bigqp_run``'s."""
    _check_mesh(mesh, data.q.shape[0], axis)
    mesh.check(data.q)
    prob = _admm.Problem(
        **{name: mesh.shards(getattr(data, name), axis) for name in (
            'q', 'l', 'u', 'rho_vec', 'types', 'diag_M', 'D', 'Dinv', 'E', 'Einv')},
        c=mesh.replicate(data.c), cinv=mesh.replicate(data.cinv))
    return _admm.make_run(mesh, _banded_ops(mesh, data, axis), prob, n=data.n,
                          dtype=data.q.dtype, data_sigma=data.sigma, rho0=data.rho0,
                          **settings), prob


def _banded_inits(mesh, data, x0, z0, y0, axis):
    return tuple(mesh.shards(pad_blocks(v, k, data.q), axis)
                 for v, k in ((x0, data.n), (z0, data.m), (y0, data.m)))


@torch.no_grad()
def banded_qp_solve(mesh, data: BandedQPData, *, x0=None, z0=None, y0=None, axis='mp',
                    **settings) -> BigQPResult:
    """Solve the banded sharded QP.  Same result contract as
    ``bigqp.big_qp_solve`` (unscaled x and y, statuses, certificates,
    polish); ``x0``/``z0``/``y0`` warm-start with scaled iterates (length n,
    m, m)."""
    run, prob = _make_banded_run(mesh, data, axis=axis, **settings)
    out = run(prob.q, *_banded_inits(mesh, data, x0, z0, y0, axis))
    return _result(mesh, out, axis, data.m, data.n)


# ---------------------------------------------------------------------------
# MPC workload surface: vector updates + warm rollout
# (ref update semantics osqppurepy/_osqp.py:1312-1429)
# ---------------------------------------------------------------------------


def _host_dia_mv(bands_jl, offsets, v, out_len):
    """Host-side DIA matvec on the (J, D, L) band blocks (un-split back to
    global (D, N) bands): the preconditioner diagonal's rebuild on bound
    updates, without the device."""
    b = _host(bands_jl)
    J, D, L = b.shape
    bands_g = b.transpose(1, 0, 2).reshape(D, J * L)
    m = out_len
    vp = np.concatenate([np.zeros(m), np.asarray(v, np.float64), np.zeros(m)])
    acc = np.zeros(m)
    for d, o in enumerate(offsets):
        acc += bands_g[d] * vp[m + o: 2 * m + o]
    return acc


def banded_qp_update_vec(data: BandedQPData, q=None, l=None, u=None) -> BandedQPData:
    """Update q, l and u without re-running setup: rescale the new vectors
    with the cached Ruiz scalers, and on bound changes re-type the
    constraints, rebuild the typed rho vector from the setup-time rho and
    refresh the CG preconditioner diagonal (O(n) host work).  Returns a new
    BandedQPData with the same bands."""
    J, L = data.q.shape
    n, m, N = data.n, data.m, J * L
    dt, dev = data.q.dtype, data.q.device

    def padv(v, size, fill):
        return np.pad(np.asarray(v, np.float64), (0, N - size),
                      constant_values=fill).reshape(J, L)

    def t(v, dtype=dt):
        return torch.as_tensor(np.asarray(v), device=dev).to(dtype)

    if q is not None:
        q = np.asarray(q, np.float64).ravel()
        if q.shape != (n,):
            raise ValueError(f'q must have shape ({n},)')
        D = _host(data.D).reshape(-1)[:n]
        data = data._replace(q=t(padv(float(data.c) * (D * q), n, 0.0)))

    if l is None and u is None:
        return data

    E = _host(data.E).reshape(-1)[:m]
    l_new, u_new = host_bounds(_host(data.l).reshape(-1)[:m], _host(data.u).reshape(-1)[:m],
                               E, l, u, m)
    # padding rows stay loose: their bounds are +-INFTY
    types, rho_vec, _ = host_typing(l_new, u_new, data.rho0, data.rho_is_vec)
    rho_pad = padv(rho_vec, m, _RHO_MIN)
    # preconditioner diag: swap the gram(rho) term for the new rho
    gram_old = _host_dia_mv(data.a2t_bands, data.offsets_at, _host(data.rho_vec).reshape(-1), N)
    gram_new = _host_dia_mv(data.a2t_bands, data.offsets_at, rho_pad.reshape(-1), N)
    diag_M = _host(data.diag_M).reshape(-1) - gram_old + gram_new
    return data._replace(
        l=t(padv(l_new, m, -OSQP_INFTY)), u=t(padv(u_new, m, OSQP_INFTY)), rho_vec=t(rho_pad),
        types=t(padv(types, m, -1), torch.int8), diag_M=t(diag_M.reshape(J, L)))


class BandedRollout(NamedTuple):
    """Per-step results of a warm MPC rollout, on the mesh's first device,
    plus the final scaled iterates (feed them back as x0/z0/y0); then the
    port's per-step duals and host counts."""

    x: torch.Tensor        # (T, n) unscaled per-step solutions
    iters: torch.Tensor    # (T,)
    status: torch.Tensor   # (T,)
    obj_val: torch.Tensor  # (T,)
    x_carry: torch.Tensor  # (J, L) scaled
    z_carry: torch.Tensor
    y_carry: torch.Tensor
    y: torch.Tensor = None  # (T, m) unscaled per-step duals
    cg_iters: tuple = ()  # per step
    host_syncs: tuple = ()  # per step


@torch.no_grad()
def banded_mpc_rollout(mesh, data: BandedQPData, q_seq, *, x0=None, z0=None, y0=None,
                       axis='mp', **settings) -> BandedRollout:
    """Warm MPC rollout on the fully sharded banded mode: a host loop over a
    (T, n) sequence of UNSCALED cost vectors, carrying the scaled iterates
    (x, z, y) between steps; results stay on the device.  An infeasible
    step, or a NaN in x, zeroes the carried iterates (a cold restart next
    step); a non-finite or blown-up (> 1e30) element is zeroed."""
    n = data.n
    J, L = data.q.shape
    run, prob = _make_banded_run(mesh, data, axis=axis, **settings)
    qs = torch.as_tensor(q_seq, dtype=data.q.dtype, device=data.q.device)
    if qs.dim() != 2 or qs.shape[1] != n:
        raise ValueError(f'q_seq must have shape (T, {n})')
    T = qs.shape[0]
    qpad = torch.nn.functional.pad(qs, (0, J * L - n)).reshape(T, J, L)
    # c * (D * q): the order of update_vec's scaling, so a rollout step is
    # the update-and-solve loop's bit for bit
    q_scaled = data.c * (data.D[None] * qpad)
    x, z, y = _banded_inits(mesh, data, x0, z0, y0, axis)
    xs, ys, its, sts, objs, cgs, syncs = [], [], [], [], [], [], []
    for q_t in q_scaled:
        out = run(mesh.shards(q_t, axis), x, z, y)
        x, y, z = _admm.clean_carry(mesh, out.x_out, out.status, out.x_out * prob.Dinv,
                                    out.y_out * prob.c * prob.Einv, out.z)
        xs.append(mesh.join(out.x_out, (axis,))[:n])
        ys.append(mesh.join(out.y_out, (axis,))[:data.m])
        its.append(out.iters)
        sts.append(out.status)
        objs.append(out.obj[0])
        cgs.append(out.cg_iters)
        syncs.append(out.host_syncs)
    d0 = mesh.device_list[0]
    stack = lambda v: mesh.join(v.map(lambda t: t[None]), (axis,))  # noqa: E731
    return BandedRollout(
        x=torch.stack(xs), iters=torch.tensor(its, device=d0),
        status=torch.tensor(sts, dtype=torch.int32, device=d0), obj_val=torch.stack(objs),
        y=torch.stack(ys), cg_iters=tuple(cgs), host_syncs=tuple(syncs),
        x_carry=stack(x), z_carry=stack(z), y_carry=stack(y))
