"""The single-QP solve loop as one traced graph, for ``torch.export``.

Counterpart of ``osqp_tpu/solver/core.py::solve_scaled_impl`` as the JAX
package's ``export_aot`` compiles it: a ``while_loop`` over epochs of
``check_termination`` ADMM iterations (a nested ``while_loop``), each KKT
solve a Cholesky solve (direct mode) or PCG as a third ``while_loop`` with
the JAX package's stop test, a ``cond`` around the termination check, the
CG-tolerance update, a ``cond`` around adaptive rho (a refactorization by
Cholesky in direct mode, the preconditioner's diagonal in indirect mode),
the post-loop 10x check and the unscaling with NaN for infeasible outcomes.
It reuses the arithmetic of ``solver.core``, so a traced solve takes the
steps of ``core.solve_scaled``, the host loop that ``OSQP.solve`` runs.

The loops and branches are ``torch``'s higher-order operators, called
directly: under ``torch.export``'s non-strict tracing each body is traced as
a Python function.  Every tensor a body reads is passed to it (the loop
state, a flat tuple of 0-d and 1-d tensors, and the problem's tensors); only
Python values (settings, shapes) are closed over.  A body returns no input
unchanged (``_fresh`` clones it), and a ``cond``'s branches return equal
strides.  Settings are baked into the graph as constants.

``ExportedSolve`` is the module ``codegen.driver.export_aot`` exports: the
scaled data, scaling, rho state and factor as buffers, and ``forward(q, l,
u)`` solving from zero iterates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op

from ..ops import spmv
from ..ops.library import LibraryOperator
from ..settings import core_settings, np_dtype
from . import core
from .core import (
    _DUAL_INF,
    _DUAL_INF_INACC,
    _MAX_ITER,
    _PRIM_INF,
    _PRIM_INF_INACC,
    _UNSOLVED,
)


# ---------------------------------------------------------------------------
# Structured operands of the higher-order operators
# ---------------------------------------------------------------------------


def _split(tree):
    """The tensors of ``tree`` (nested tuples, NamedTuples and
    ``LibraryOperator``s, with tensors and Python values as leaves) in a
    flat tuple, and ``rebuild(tensors)`` giving ``tree`` back around other
    tensors of the same order."""
    flat = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            flat.append(obj)
            return lambda it: next(it)
        if isinstance(obj, LibraryOperator):
            fns = {k: walk(t) for k, t in obj.tensors.items()}
            return lambda it: obj.with_tensors({k: f(it) for k, f in fns.items()})
        if isinstance(obj, tuple):
            fns = [walk(v) for v in obj]
            if hasattr(obj, '_fields'):
                return lambda it: type(obj)(*(f(it) for f in fns))
            return lambda it: tuple(f(it) for f in fns)
        return lambda it: obj

    fn = walk(tree)
    return tuple(flat), lambda tensors: fn(iter(tensors))


def _fresh(outs, ins):
    """``outs`` with every tensor that is one of ``ins`` cloned: a loop body
    or a branch may not return its input."""
    ids = {id(t) for t in ins}
    return tuple(t.clone() if id(t) in ids else t for t in outs)


def _while(cond_fn, body_fn, carry, ctx):
    """``while cond_fn(ctx, *carry): carry = body_fn(ctx, *carry)`` as one
    ``while_loop``; ``ctx`` is a tree of tensors read by both."""
    consts, rebuild = _split(ctx)
    nc = len(carry)

    def c(*a):
        return cond_fn(rebuild(a[nc:]), *a[:nc])

    def b(*a):
        return _fresh(body_fn(rebuild(a[nc:]), *a[:nc]), a)

    return while_loop_op(c, b, tuple(carry), consts)


def _cond(pred, true_fn, false_fn, operands, ctx):
    """``true_fn(ctx, *operands)`` if ``pred`` else ``false_fn(ctx,
    *operands)``, as one ``cond``; each returns a tuple of tensors."""
    consts, rebuild = _split(ctx)
    no = len(operands)

    def branch(fn):
        def run(*a):
            return _fresh(fn(rebuild(a[no:]), *a[:no]), a)
        return run

    return cond_op(pred, branch(true_fn), branch(false_fn), tuple(operands) + consts)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class LoopState(NamedTuple):
    """The traced loop's carry: 0-d and 1-d tensors only."""

    it: torch.Tensor  # int32
    status: torch.Tensor  # int32
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    xtld: torch.Tensor  # last x_tilde (CG warm start)
    delta_x: torch.Tensor
    delta_y: torch.Tensor
    rho: torch.Tensor  # 0-d
    rho_vec: torch.Tensor
    rho_inv_vec: torch.Tensor
    fac: torch.Tensor  # the Cholesky factor (direct) or diag(M) (indirect)
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    cg_tol: torch.Tensor  # adaptive CG relative tolerance
    cg_iters: torch.Tensor  # int32
    rho_updates: torch.Tensor  # int32


class GraphResult(NamedTuple):
    x: torch.Tensor  # unscaled primal (NaN if infeasible)
    y: torch.Tensor  # unscaled dual (NaN if infeasible)
    status: torch.Tensor
    iters: torch.Tensor
    cg_iters: torch.Tensor
    rho_updates: torch.Tensor


def _i32(v, device):
    return torch.full((), v, dtype=torch.int32, device=device)


def pcg_graph(P, A, sigma, rho_vec, diag, b, x0, rel_tol, max_iter: int):
    """``core.pcg_solve`` as a ``while_loop``: the same start, step and stop
    test (``||r||_2 > tol`` and ``k < max_iter``, before every step).
    Returns ``(x, k)``, ``k`` an int32 0-d tensor."""
    ops = (P, A, rho_vec)
    dinv, tol, x, r, p, rz = core.pcg_start(core.kkt_matvec(P, A, sigma, rho_vec), diag, b, x0,
                                            rel_tol)

    def cond_fn(ctx, x, r, p, rz, k):
        return (torch.sqrt(r @ r) > ctx[4]) & (k < max_iter)

    def body_fn(ctx, x, r, p, rz, k):
        P, A, rho_vec, dinv, _ = ctx
        x, r, p, rz = core.pcg_step(core.kkt_matvec(P, A, sigma, rho_vec), dinv, x, r, p, rz)
        return x, r, p, rz, k + 1

    x, _, _, _, k = _while(cond_fn, body_fn, (x, r, p, rz, _i32(0, b.device)),
                           (*ops, dinv, tol))
    return x, k


def solve_scaled_graph(data: core.QPData, scal: core.Scaling, settings, rho, rho_vec,
                       rho_inv_vec, constr_type, fac, iterates: core.Iterates,
                       indirect: bool) -> GraphResult:
    """The full ADMM loop on already-scaled data as one traced graph
    (``osqp_tpu/solver/core.py::solve_scaled_impl`` from iteration 0 to
    ``settings.max_iter``).

    ``data`` holds dense tensors or ``LibraryOperator``s; ``settings`` is a
    ``CoreSettings`` (host values, baked in); ``rho`` a 0-d tensor with
    ``rho_vec``, ``rho_inv_vec`` and ``constr_type``; ``fac`` the Cholesky
    factor of M (direct) or diag(M) (indirect)."""
    n = data.q.shape[0]
    m = data.l.shape[0]
    x0 = iterates.x
    dev, dtype = x0.device, x0.dtype
    f = np_dtype(dtype)
    ct = settings.check_termination
    iter_cap = settings.iter_cap
    epoch_len = ct if ct > 0 else iter_cap
    interval = settings.adaptive_rho_interval
    epochs_per_adapt = max((interval + epoch_len - 1) // max(epoch_len, 1), 1)
    adaptive = bool(settings.adaptive_rho) and interval > 0
    ctx = (data, scal, constr_type)

    def full(v):
        return torch.full((), v, dtype=dtype, device=dev)

    st = LoopState(
        it=_i32(0, dev), status=_i32(_UNSOLVED, dev),
        x=iterates.x, z=iterates.z, y=iterates.y, xtld=iterates.x.clone(),
        delta_x=x0.new_zeros((n,)), delta_y=x0.new_zeros((m,)),
        rho=rho, rho_vec=rho_vec, rho_inv_vec=rho_inv_vec, fac=fac,
        pri_res=full(float('inf')), dua_res=full(float('inf')), cg_tol=full(f(1e-3)),
        cg_iters=_i32(0, dev), rho_updates=_i32(0, dev),
    )

    # -- one epoch: this_epoch ADMM iterations ------------------------------

    def iterations(ctx, it_end, x, z, y, xtld, delta_x, delta_y, cg_iters, k,
                   rho_vec, rho_inv, fac, cg_tol):
        carry = (x, z, y, xtld, delta_x, delta_y, cg_iters, k)

        def cond_fn(c, x, z, y, xtld, delta_x, delta_y, cg_iters, k):
            return k < c[1]

        def body_fn(c, x, z, y, xtld, delta_x, delta_y, cg_iters, k):
            (data, _, _), _, rho_vec, rho_inv, fac, cg_tol = c
            rhs, b2 = core.kkt_rhs(data, settings, x, z, y, rho_vec, rho_inv)
            if indirect:
                x_tilde, steps = pcg_graph(data.P, data.A, settings.sigma, rho_vec, fac, rhs,
                                           xtld, cg_tol, settings.cg_max_iter)
                cg_iters = cg_iters + steps
            else:
                x_tilde = core._cho_solve(fac, rhs)
            xn, zn, yn, dy = core.admm_update(data, settings, x, z, y, delta_y, x_tilde, b2,
                                              rho_vec, rho_inv)
            return xn, zn, yn, x_tilde, xn - x, dy, cg_iters, k + 1

        return _while(cond_fn, body_fn, carry, (ctx, it_end, rho_vec, rho_inv, fac, cg_tol))

    # -- the termination check ----------------------------------------------

    def check(ctx, x, z, y, delta_x, delta_y, status, pri, dua):
        data, scal, _ = ctx
        status, pri, dua, *_ = core.termination_status(data, scal, x, z, y, delta_x, delta_y,
                                                       settings, False)
        return status, pri, dua

    # -- adaptive rho -------------------------------------------------------

    def refactor(ctx, rho_new, rho, rho_vec, rho_inv, fac, rho_updates):
        data, _, constr_type = ctx
        vec = core.rho_vec_from_types(constr_type, rho_new, settings.rho_is_vec, dtype)
        inv = torch.where(vec > 0, 1.0 / vec, 0.0)
        if indirect:
            fac = core.build_M_diag(data.P, data.A, settings.sigma, vec)
        else:
            fac = core.factorize(data.P, data.A, settings.sigma, vec).L
        return torch.clamp(rho_new, f(core.RHO_MIN), f(core.RHO_MAX)), vec, inv, fac, \
            rho_updates + 1

    def adapt(ctx, x, z, y, rho, rho_vec, rho_inv, fac, rho_updates):
        data = ctx[0]
        rho_new = core.rho_estimate_fn(data, x, z, y, rho)
        tol = settings.adaptive_rho_tolerance
        # host-scalar divisors become tensors: a CUDA tensor divided by a
        # host scalar is multiplied by its reciprocal, which rounds otherwise
        trigger = (rho_new > tol * rho) | (rho_new < rho / full(tol))
        return _cond(trigger, refactor, lambda c, *a: a[1:],
                     (rho_new, rho, rho_vec, rho_inv, fac, rho_updates), ctx)

    # -- the epoch loop -----------------------------------------------------

    def epoch_cond(ctx, *s):
        s = LoopState(*s)
        return (s.it < iter_cap) & (s.status == _UNSOLVED)

    def epoch_body(ctx, *s):
        s = LoopState(*s)
        this_epoch = torch.clamp(iter_cap - s.it, max=epoch_len)
        x, z, y, xtld, delta_x, delta_y, cg_iters, _ = iterations(
            ctx, this_epoch, s.x, s.z, s.y, s.xtld, s.delta_x, s.delta_y, s.cg_iters,
            _i32(0, dev), s.rho_vec, s.rho_inv_vec, s.fac, s.cg_tol)
        it = s.it + this_epoch
        status, pri, dua, cg_tol = s.status, s.pri_res, s.dua_res, s.cg_tol
        if ct > 0:
            do_check = it % ct == 0
            status, pri, dua = _cond(do_check, check, lambda c, *a: a[-3:],
                                     (x, z, y, delta_x, delta_y, status, pri, dua), ctx)
            # adaptive CG tolerance: monotone tightening toward the ADMM
            # residual scale, with a forced 1/cg_tol_reduction cut whenever
            # both residuals stall; only at check epochs
            candidate = settings.cg_tol_fraction * torch.sqrt(pri * dua)
            new_tol = torch.clamp(torch.minimum(cg_tol, candidate), settings.cg_eps_min, f(0.15))
            stalled = (pri > f(0.5) * s.pri_res) & (dua > f(0.5) * s.dua_res)
            reduction = max(settings.cg_tol_reduction, f(1))
            new_tol = torch.where(stalled, torch.clamp(new_tol / full(reduction),
                                                       min=settings.cg_eps_min), new_tol)
            cg_tol = torch.where(do_check, new_tol, cg_tol)
        rho, rho_vec, rho_inv, fac, rho_updates = (s.rho, s.rho_vec, s.rho_inv_vec, s.fac,
                                                   s.rho_updates)
        if adaptive:
            epoch_idx = (it + epoch_len - 1) // epoch_len
            do_adapt = (epoch_idx % epochs_per_adapt == 0) & (status == _UNSOLVED)
            rho, rho_vec, rho_inv, fac, rho_updates = _cond(
                do_adapt, adapt, lambda c, x, z, y, *a: a,
                (x, z, y, rho, rho_vec, rho_inv, fac, rho_updates), ctx)
        return LoopState(it, status, x, z, y, xtld, delta_x, delta_y, rho, rho_vec, rho_inv,
                         fac, pri, dua, cg_tol, cg_iters, rho_updates)

    st = LoopState(*_while(epoch_cond, epoch_body, st, ctx))

    # -- after the loop: the exact, then the 10x check, else MAX_ITER ------

    def finish(ctx, x, z, y, delta_x, delta_y, status):
        data, scal, _ = ctx
        exact = core.termination_status(data, scal, x, z, y, delta_x, delta_y, settings,
                                        False)[0]
        approx = core.termination_status(data, scal, x, z, y, delta_x, delta_y, settings,
                                         True)[0]
        inaccurate = torch.where(approx == _UNSOLVED, _MAX_ITER, approx).to(torch.int32)
        return (torch.where(exact == _UNSOLVED, inaccurate, exact),)

    (status,) = _cond((st.status == _UNSOLVED) & (st.it >= settings.max_iter), finish,
                      lambda c, *a: a[-1:],
                      (st.x, st.z, st.y, st.delta_x, st.delta_y, st.status), ctx)

    # unscale (ref _osqp.py:1098-1115)
    infeasible = ((status == _PRIM_INF) | (status == _PRIM_INF_INACC) | (status == _DUAL_INF)
                  | (status == _DUAL_INF_INACC))
    x_out = torch.where(infeasible, torch.nan, scal.D * st.x)
    y_out = torch.where(infeasible, torch.nan, scal.cinv * (scal.E * st.y)) if m else st.y
    return GraphResult(x=x_out, y=y_out, status=status, iters=st.it, cg_iters=st.cg_iters,
                       rho_updates=st.rho_updates)


def _traced(M):
    """A dense tensor as it is; an eager sparse operator as its
    ``LibraryOperator``."""
    return LibraryOperator.from_spmv(M) if spmv.is_structured(M) else M


class ExportedSolve(torch.nn.Module):
    """The module ``export_aot`` exports: ``forward(q, l, u) -> (x, y,
    status, iters, cg_iters, rho_updates)``, the solve of the set-up problem
    with new q, l and u from zero iterates, in the solver's working dtype.

    The scaled P and A (dense tensors, or the sparse operators' tensors),
    the scaling vectors, the rho state (rho as a 0-d tensor) and the factor
    (the Cholesky factor in direct mode, diag(M) in indirect mode) are
    buffers, taken from the ``backend.Solver`` as its last setup, update or
    solve left them; settings are constants."""

    def __init__(self, solver):
        super().__init__()
        self._dtype = solver._dtype
        self._indirect = bool(solver._indirect)
        self._settings = core_settings(solver._stg, solver._dtype)
        d, sc, rs = solver._data, solver._scal, solver._rho
        fac = solver._factor.diag if self._indirect else solver._factor.L
        rho = torch.full((), rs.rho, dtype=solver._dtype, device=solver._device)
        tree = (_traced(d.P), _traced(d.A), sc, rho, rs.rho_vec, rs.rho_inv_vec,
                rs.constr_type, fac)
        tensors, self._rebuild = _split(tree)
        self._names, seen = [], set()
        for i, t in enumerate(tensors):
            name = f'state_{i}'
            # one buffer per tensor (identity scaling holds D as Dinv too)
            self.register_buffer(name, t.clone() if id(t) in seen else t)
            seen.add(id(t))
            self._names.append(name)

    def forward(self, q, l, u):
        dt = self._dtype
        P, A, sc, rho, rho_vec, rho_inv, constr_type, fac = self._rebuild(
            [getattr(self, k) for k in self._names])
        data = core.QPData(P=P, q=sc.c * (sc.D * q.to(dt)), A=A, l=sc.E * l.to(dt),
                           u=sc.E * u.to(dt))
        zeros = torch.zeros
        kw = dict(dtype=dt, device=data.q.device)
        it = core.Iterates(x=zeros(data.q.shape, **kw), z=zeros(data.l.shape, **kw),
                           y=zeros(data.l.shape, **kw))
        return tuple(solve_scaled_graph(data, sc, self._settings, rho, rho_vec, rho_inv,
                                        constr_type, fac, it, self._indirect))
