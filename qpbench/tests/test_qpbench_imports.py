"""The import check: top-level names compared whole."""

from pathlib import Path

from qpbench import imports

BENCH = Path(__file__).resolve().parents[1]


def test_the_benchmark_is_clean():
    assert imports.violations(BENCH) == []


def test_names_compared_whole():
    assert imports.forbidden_loaded(['jax.numpy', 'osqp_tpu_torch.ops', 'numpy']) == ['jax']
    assert imports.forbidden_loaded(['osqp_tpu.batch', 'osqp_tpu_torch']) == ['osqp_tpu']
    assert imports.forbidden_loaded(['osqp_tpu_torch', 'jaxtyping', 'flaxen']) == []
    assert imports.forbidden_loaded(['flax.linen', 'jaxlib']) == ['flax', 'jaxlib']


def test_violations_found(tmp_path):
    (tmp_path / 'reference').mkdir()
    (tmp_path / 'metrics').mkdir()
    (tmp_path / 'reference' / 'ok.py').write_text('import numpy\nimport torch\n')
    (tmp_path / 'reference' / 'bad.py').write_text('from osqp_tpu_torch import OSQP\n')
    (tmp_path / 'metrics' / 'fine.py').write_text('import osqp_tpu_torch.ops.ldl\n')
    (tmp_path / 'metrics' / 'jax_one.py').write_text('import jax.numpy as jnp\n')
    (tmp_path / 'metrics' / 'pkg.py').write_text('from osqp_tpu.batch import BatchedOSQP\n')
    (tmp_path / 'metrics' / 'smoke.py').write_text('import chip_smoke\n')
    (tmp_path / 'metrics' / 'reads.py').write_text("open('../benchmarks/RESULTS.md')\n")
    found = dict(imports.violations(tmp_path))
    assert set(found) == {'reference/bad.py', 'metrics/jax_one.py', 'metrics/pkg.py',
                          'metrics/smoke.py', 'metrics/reads.py'}
    assert found['reference/bad.py'] == ['osqp_tpu_torch']
    assert found['metrics/pkg.py'] == ['osqp_tpu']
