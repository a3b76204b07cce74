"""The port's top-level names and solver constants against the JAX
package's: code written for ``osqp_tpu`` finds the same names in
``osqp_tpu_torch`` with the same values."""

import inspect
import math

import pytest

import osqp_tpu
import osqp_tpu_torch
from osqp_tpu import constants as jc
from osqp_tpu_torch import constants as tc

_ENUM_NAMES = [name for enum in (jc.SolverStatus, jc.SolverError, jc.CapabilitiesType)
               for name in enum.__members__]
_WHICH = ['OSQP_INFTY', 'OSQP_NAN', 'OSQP_MIN_SCALING', 'OSQP_MAX_SCALING'] + _ENUM_NAMES


def _same(a, b):
    return (isinstance(a, float) and math.isnan(a) and math.isnan(b)) or a == b


@pytest.mark.parametrize('which', _WHICH)
def test_constant_matches_jax_package(which):
    """``constant(which)`` and ``OSQP.constant(which)`` give the JAX
    package's value for every named value and every status, error and
    capability code (``OSQP_SOLVED`` among them)."""
    want = osqp_tpu.constant(which)
    assert _same(osqp_tpu_torch.constant(which), want)
    assert _same(osqp_tpu_torch.OSQP(device='cpu').constant(which), want)
    assert _same(osqp_tpu.OSQP(algebra='numpy').constant(which), want)


def test_unknown_constant_raises():
    for fn in (osqp_tpu.constant, osqp_tpu_torch.constant,
               osqp_tpu_torch.OSQP(device='cpu').constant):
        with pytest.raises(RuntimeError, match='Unknown constant'):
            fn('OSQP_NO_SUCH_CONSTANT')


@pytest.mark.parametrize('name', ['OSQP_DIVERGENCE', 'PRINT_INTERVAL', 'OSQP_INFTY',
                                  'MIN_SCALING', 'MAX_SCALING', 'RHO_MIN', 'RHO_MAX',
                                  'RHO_EQ_OVER_RHO_INEQ', 'RHO_TOL', 'ADAPTIVE_RHO_FIXED'])
def test_module_constant_matches_jax_package(name):
    assert getattr(tc, name) == getattr(jc, name)


@pytest.mark.parametrize('name', ['OSQP', 'OSQPSettings', 'SolverError', 'SolverStatus',
                                  'OSQPException', 'constant', '__version__'])
def test_top_level_name_matches_jax_package(name):
    """Each top-level name of ``osqp_tpu`` the port carries: the version
    string equal, the enums with the same members and values, the settings
    namespace with the same defaults, the exception comparing equal to its
    error code."""
    got, want = getattr(osqp_tpu_torch, name), getattr(osqp_tpu, name)
    if name == '__version__':
        assert got == want
    elif name in ('SolverError', 'SolverStatus'):
        assert {k: int(v) for k, v in got.__members__.items()} == \
            {k: int(v) for k, v in want.__members__.items()}
    elif name == 'OSQPSettings':
        assert vars(got()) == vars(want())
        assert got(max_iter=7).as_dict() == want(max_iter=7).as_dict()
    elif name == 'OSQPException':
        code = osqp_tpu_torch.SolverError.OSQP_DATA_VALIDATION_ERROR
        assert got(code) == code and issubclass(got, Exception)
    else:
        assert callable(got)


@pytest.mark.parametrize('module, name', [
    ('batch', 'BatchedOSQP'), ('batch', 'batch_qp_solve'), ('batch', 'mpc_rollout'),
    ('batch', 'mpc_rollout_donated'), ('batch', 'default_core_settings'),
    ('nn.layer', 'make_qp_layer'), ('nn.layer', 'QPLayerResult'), ('nn.torch', 'OSQP'),
    ('nn.torch', 'to_numpy')])
def test_batched_and_layer_names_match_jax_package(module, name):
    """The vmap engine's and the layers' names live in the same modules as in
    ``osqp_tpu``; the layer result has the same fields."""
    import importlib

    got = getattr(importlib.import_module(f'osqp_tpu_torch.{module}'), name)
    want = getattr(importlib.import_module(f'osqp_tpu.{module}'), name)
    assert callable(got) and callable(want)
    if name == 'QPLayerResult':
        assert got._fields == want._fields


def test_capabilities_match_jax_package():
    """``backend.capabilities()`` and ``OSQP.capabilities``: direct,
    indirect, matrix updates, derivatives and code generation, as the JAX
    backend reports them."""
    from osqp_tpu.backends import jax_backend
    from osqp_tpu_torch import backend

    assert int(backend.capabilities()) == int(jax_backend.capabilities())
    assert osqp_tpu_torch.OSQP(device='cpu').has_capability('OSQP_CAPABILITY_CODEGEN')
    got = inspect.signature(osqp_tpu_torch.OSQP.codegen)
    want = inspect.signature(osqp_tpu.OSQP.codegen)
    assert got == want


@pytest.mark.parametrize('name', __import__('osqp_tpu.parallel', fromlist=['__all__']).__all__)
def test_parallel_names_match_jax_package(name):
    """Every name of ``osqp_tpu.parallel.__all__`` is in the port's
    ``parallel`` package and its ``__all__``; the result and data tuples
    carry the JAX package's fields in its order (the port's host counts
    follow them)."""
    import osqp_tpu.parallel as jp
    import osqp_tpu_torch.parallel as tp

    assert name in tp.__all__
    got, want = getattr(tp, name), getattr(jp, name)
    assert callable(got)
    if hasattr(want, '_fields'):
        assert got._fields[:len(want._fields)] == want._fields
