"""Solver constants and status codes (own copy of ``osqp_tpu.constants``).

Numeric status values follow the OSQP v1.0 C enum (sequential, starting at
``OSQP_SOLVED = 1``), so results compare one to one with ``osqp_tpu``.
"""

from __future__ import annotations

import math
from enum import IntEnum

# Algorithm parameter bounds (OSQP reference purepy _osqp.py:24-45)
RHO_MIN = 1e-06
RHO_MAX = 1e06
RHO_EQ_OVER_RHO_INEQ = 1e03
RHO_TOL = 1e-04

MIN_SCALING = 1e-04
MAX_SCALING = 1e04

OSQP_INFTY = 1e30
OSQP_NAN = math.nan

# Iterations between two rows of a verbose solve's console output.
PRINT_INTERVAL = 200

# Adaptive-rho interval used when ``adaptive_rho_interval == 0`` (a fixed
# interval keeps solves deterministic).
ADAPTIVE_RHO_FIXED = 100

# Divergence guard used by the non-convexity residual check.
OSQP_DIVERGENCE = OSQP_INFTY


class SolverStatus(IntEnum):
    OSQP_SOLVED = 1
    OSQP_SOLVED_INACCURATE = 2
    OSQP_PRIMAL_INFEASIBLE = 3
    OSQP_PRIMAL_INFEASIBLE_INACCURATE = 4
    OSQP_DUAL_INFEASIBLE = 5
    OSQP_DUAL_INFEASIBLE_INACCURATE = 6
    OSQP_MAX_ITER_REACHED = 7
    OSQP_TIME_LIMIT_REACHED = 8
    OSQP_NON_CVX = 9
    OSQP_SIGINT = 10
    OSQP_UNSOLVED = 11


class SolverError(IntEnum):
    OSQP_NO_ERROR = 0
    OSQP_DATA_VALIDATION_ERROR = 1
    OSQP_SETTINGS_VALIDATION_ERROR = 2
    OSQP_LINSYS_SOLVER_INIT_ERROR = 3
    OSQP_NONCVX_ERROR = 4
    OSQP_MEM_ALLOC_ERROR = 5
    OSQP_WORKSPACE_NOT_INIT_ERROR = 6
    OSQP_ALGEBRA_LOAD_ERROR = 7
    OSQP_CODEGEN_DEFINES_ERROR = 8
    OSQP_DATA_NOT_INITIALIZED = 9
    OSQP_FUNC_NOT_IMPLEMENTED = 10


class LinsysSolverType(IntEnum):
    OSQP_DIRECT_SOLVER = 0
    OSQP_INDIRECT_SOLVER = 1


class PrecondType(IntEnum):
    OSQP_NO_PRECONDITIONER = 0
    OSQP_DIAGONAL_PRECONDITIONER = 1


class CapabilitiesType(IntEnum):
    OSQP_CAPABILITY_DIRECT_SOLVER = 0x01
    OSQP_CAPABILITY_INDIRECT_SOLVER = 0x02
    OSQP_CAPABILITY_CODEGEN = 0x04
    OSQP_CAPABILITY_UPDATE_MATRICES = 0x08
    OSQP_CAPABILITY_DERIVATIVES = 0x10


_STATUS_STRINGS = {
    SolverStatus.OSQP_SOLVED: 'solved',
    SolverStatus.OSQP_SOLVED_INACCURATE: 'solved inaccurate',
    SolverStatus.OSQP_PRIMAL_INFEASIBLE: 'primal infeasible',
    SolverStatus.OSQP_PRIMAL_INFEASIBLE_INACCURATE: 'primal infeasible inaccurate',
    SolverStatus.OSQP_DUAL_INFEASIBLE: 'dual infeasible',
    SolverStatus.OSQP_DUAL_INFEASIBLE_INACCURATE: 'dual infeasible inaccurate',
    SolverStatus.OSQP_MAX_ITER_REACHED: 'maximum iterations reached',
    SolverStatus.OSQP_TIME_LIMIT_REACHED: 'run time limit reached',
    SolverStatus.OSQP_NON_CVX: 'problem non convex',
    SolverStatus.OSQP_SIGINT: 'interrupted',
    SolverStatus.OSQP_UNSOLVED: 'unsolved',
}


def status_string(status_val: int) -> str:
    return _STATUS_STRINGS.get(SolverStatus(int(status_val)), 'unknown')


# Constants exposed by name, as the reference's extension module exposes them.
_NAMED_CONSTANTS = {
    'OSQP_INFTY': OSQP_INFTY,
    'OSQP_NAN': OSQP_NAN,
    'OSQP_MIN_SCALING': MIN_SCALING,
    'OSQP_MAX_SCALING': MAX_SCALING,
}


def constant(which: str, algebra: str | None = None):
    """The value of the solver constant named ``which``: a named value, or
    the integer of a status, error or capability code.  ``algebra`` is
    accepted for the JAX package's signature and not used (both algebras
    share the constants).  Raises ``RuntimeError`` for an unknown name."""
    if which in _NAMED_CONSTANTS:
        return _NAMED_CONSTANTS[which]
    for enum in (SolverStatus, SolverError, CapabilitiesType):
        if which in enum.__members__:
            return int(enum[which])
    raise RuntimeError(f'Unknown constant {which}')
