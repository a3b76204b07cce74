"""Solver settings and results: the host-side dataclasses and the solver form.

``OracleSettings``, ``Info`` and ``Solution`` are own copies of the
dataclasses of ``osqp_tpu._oracle.solver`` (reference defaults).
``core_settings`` is the host-to-solver conversion of
``osqp_tpu.backends.jax_backend.Solver._core_settings``: every float setting
becomes a numpy scalar of the working dtype, so it enters every expression at
that dtype exactly as the JAX package's traced settings do; integers and flags
stay host values, because the port's epoch loop runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .constants import ADAPTIVE_RHO_FIXED, SolverStatus

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def np_dtype(dtype: torch.dtype):
    """numpy scalar type of a working dtype (float32 or float64)."""
    try:
        return _NP_DTYPES[dtype]
    except KeyError:
        raise TypeError(f'working dtype must be float32 or float64, got {dtype}') from None


@dataclasses.dataclass
class OracleSettings:
    """Dynamic solver settings with reference defaults."""

    rho: float = 0.1
    sigma: float = 1e-6
    scaling: int = 10
    max_iter: int = 4000
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    alpha: float = 1.6
    delta: float = 1e-6
    verbose: bool = False
    scaled_termination: bool = False
    check_termination: int = 25
    check_dualgap: bool = True
    warm_starting: bool = True
    polishing: bool = False
    polish_refine_iter: int = 3
    rho_is_vec: bool = True
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 0
    adaptive_rho_tolerance: float = 5.0
    adaptive_rho_fraction: float = 0.0
    linsys_solver: int = 0
    cg_max_iter: int = 20
    cg_tol_reduction: int = 10
    cg_tol_fraction: float = 0.15
    cg_precond: int = 1
    device: int = 0
    time_limit: float = 0.0


@dataclasses.dataclass
class Info:
    iter: int = 0
    status: str = 'unsolved'
    status_val: int = int(SolverStatus.OSQP_UNSOLVED)
    status_polish: int = 0
    obj_val: float = np.nan
    dual_obj_val: float = np.nan
    prim_res: float = np.inf
    dual_res: float = np.inf
    duality_gap: float = np.nan
    rho_updates: int = 0
    rho_estimate: float = 0.1
    setup_time: float = 0.0
    solve_time: float = 0.0
    update_time: float = 0.0
    polish_time: float = 0.0
    run_time: float = 0.0
    primdual_int: int = 0
    rel_kkt_error: float = 0.0
    # the port's own counters: CG steps and host syncs of the last solve
    cg_iters: int = 0
    host_syncs: int = 0


@dataclasses.dataclass
class Solution:
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    prim_inf_cert: Optional[np.ndarray] = None
    dual_inf_cert: Optional[np.ndarray] = None
    linesearch: Optional[object] = None


class CoreSettings(NamedTuple):
    """Settings as the solver loops read them (the single-QP core and the
    shared engine; the latter ignores the CG fields)."""

    sigma: np.floating
    alpha: np.floating
    eps_abs: np.floating
    eps_rel: np.floating
    eps_prim_inf: np.floating
    eps_dual_inf: np.floating
    check_termination: int  # 0 = never
    scaled_termination: bool
    check_dualgap: bool
    adaptive_rho: bool
    adaptive_rho_interval: int  # effective, aligned to check_termination
    adaptive_rho_tolerance: np.floating
    rho_is_vec: bool
    max_iter: int
    iter_cap: int  # iterations allowed this call: max_iter, or the end of a chunk
    cg_max_iter: int
    cg_tol_fraction: np.floating
    cg_tol_reduction: np.floating  # stall-triggered CG-tolerance division factor
    cg_eps_min: np.floating  # CG tolerance floor: 1e-12 at f64, 1e-7 at f32


def core_settings(stg: OracleSettings, dtype: torch.dtype) -> CoreSettings:
    f = np_dtype(dtype)
    ct = int(stg.check_termination)
    interval = int(stg.adaptive_rho_interval) or ADAPTIVE_RHO_FIXED
    if ct:
        interval = max(interval, ct)
    return CoreSettings(
        sigma=f(stg.sigma),
        alpha=f(stg.alpha),
        eps_abs=f(stg.eps_abs),
        eps_rel=f(stg.eps_rel),
        eps_prim_inf=f(stg.eps_prim_inf),
        eps_dual_inf=f(stg.eps_dual_inf),
        check_termination=ct,
        scaled_termination=bool(stg.scaled_termination),
        check_dualgap=bool(stg.check_dualgap),
        adaptive_rho=bool(stg.adaptive_rho),
        adaptive_rho_interval=interval,
        adaptive_rho_tolerance=f(stg.adaptive_rho_tolerance),
        rho_is_vec=bool(stg.rho_is_vec),
        max_iter=int(stg.max_iter),
        iter_cap=int(stg.max_iter),
        cg_max_iter=int(stg.cg_max_iter),
        cg_tol_fraction=f(stg.cg_tol_fraction),
        cg_tol_reduction=f(stg.cg_tol_reduction),
        cg_eps_min=f(1e-12 if dtype == torch.float64 else 1e-7),
    )


def default_core_settings(dtype: torch.dtype = torch.float64, **over) -> CoreSettings:
    """Solver settings with reference defaults and ``over`` applied
    (counterpart of ``osqp_tpu.batch.default_core_settings``)."""
    return core_settings(OracleSettings(**over), dtype)
