"""Algebra registry and dispatch.

The port's own copy of ``osqp_tpu/algebra.py``.  Two algebras, highest
priority first:

* ``torch`` - ``backend.Solver``: dense mode (Cholesky, or PCG) and sparse
  mode (sparse operators, PCG); the counterpart of the JAX package's
  ``jax``, and the default.
* ``ldl``   - ``ldl_backend.Solver``: float64 sparse direct solves by an
  LDL' of the full KKT matrix (K5 and K6 on the card); the counterpart of
  the JAX package's ``numpy``.

The JAX package's environment override (``OSQP_TPU_ALGEBRA_BACKEND``) is an
argument here: ``OSQP(algebra=...)``.  The JAX package's names raise with
the name of their counterpart.
"""

from __future__ import annotations

import importlib

from .constants import constant  # noqa: F401  (re-exported)

_ALGEBRAS = ('torch', 'ldl')  # highest -> lowest priority

_ALGEBRA_MODULES = {
    'torch': 'osqp_tpu_torch.backend',
    'ldl': 'osqp_tpu_torch.ldl_backend',
}

# the JAX package's algebras and their counterparts here
_COUNTERPARTS = {'jax': 'torch', 'numpy': 'ldl'}


def _check(algebra: str):
    if algebra in _COUNTERPARTS:
        raise RuntimeError(f"Algebra {algebra!r} is the JAX package's; its counterpart in "
                           f"osqp_tpu_torch is {_COUNTERPARTS[algebra]!r}")
    if algebra not in _ALGEBRAS:
        raise RuntimeError(f'Unknown algebra {algebra!r}: one of {_ALGEBRAS}')


def algebra_available(algebra: str) -> bool:
    _check(algebra)
    try:
        importlib.import_module(_ALGEBRA_MODULES[algebra])
    except ImportError:
        return False
    return True


def algebras_available():
    return [a for a in _ALGEBRAS if algebra_available(a)]


def default_algebra() -> str:
    for algebra in _ALGEBRAS:
        if algebra_available(algebra):
            return algebra
    raise RuntimeError('No algebra backend available!')


def algebra_module(algebra: str):
    _check(algebra)
    return importlib.import_module(_ALGEBRA_MODULES[algebra])
