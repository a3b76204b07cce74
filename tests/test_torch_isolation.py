"""The port stands alone: it imports neither JAX nor anything of osqp_tpu,
and its entry points never drift onto the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import osqp_tpu_torch

PORT = Path(osqp_tpu_torch.__file__).resolve().parent
ROOT = PORT.parent
FORBIDDEN = ('jax', 'jaxlib', 'osqp_tpu')


def _port_files():
    files = sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    return [f for f in files if f.exists()]


@pytest.mark.parametrize('path', _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_osqp_tpu(path):
    """An AST scan of every module of the port and of chip_smoke.py."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, f'{path}: imports {name}'


_CHILD = """
import sys
sys.modules['jax'] = None
sys.modules['osqp_tpu'] = None
import pkgutil, importlib
import numpy as np, torch
import osqp_tpu_torch
for mod in pkgutil.walk_packages(osqp_tpu_torch.__path__, 'osqp_tpu_torch.'):
    importlib.import_module(mod.name)
rng = np.random.default_rng(0)
n, m, B = 4, 6, 5
L = rng.standard_normal((n, n))
P = L @ L.T + 0.1 * np.eye(n)
A = rng.standard_normal((m, n))
q = rng.standard_normal((B, n))
s = osqp_tpu_torch.BatchedOSQP(device='cpu')
s.setup(P, q, A, -np.ones((B, m)), np.ones((B, m)), verbose=False)
r = s.solve()
assert (r.info.status_val == 1).all(), r.info.status_val
import scipy.sparse as sp
nb = 64
Pb = sp.diags([np.full(nb, 2.0), np.full(nb - 1, -0.9), np.full(nb - 1, -0.9)], [0, 1, -1]).tocsc()
Ab = (sp.eye(nb) + sp.diags([np.full(nb - 2, 0.5)], [-2], shape=(nb, nb))).tocsc()
o = osqp_tpu_torch.OSQP(device='cpu', sparse=True)
o.setup(P=Pb, q=rng.standard_normal(nb), A=Ab, l=-1.5 * np.ones(nb), u=1.5 * np.ones(nb),
        verbose=False)
assert o._solver._sparse_fmt_P == o._solver._sparse_fmt_A == 'dia'
assert o.solve(raise_error=True).info.status == 'solved'
o.update_settings(polishing=True, verbose=True, time_limit=1e9)
assert o.solve(raise_error=True).info.status_polish == 1
o = osqp_tpu_torch.OSQP(device='cpu', algebra='ldl')
o.setup(P=sp.triu(Pb, format='csc'), q=rng.standard_normal(nb), A=Ab, l=-1.5 * np.ones(nb),
        u=1.5 * np.ones(nb), verbose=False, polishing=True)
r = o.solve(raise_error=True)
assert r.info.status == 'solved' and r.info.status_polish == 1
Pb = np.stack([P, 2 * P, P + np.eye(n)])
v = osqp_tpu_torch.BatchedOSQP(device='cpu').setup(Pb, q[:3], A, -np.ones(m), np.ones(m))
assert v._engine == 'vmap' and (v.solve().info.status_val == 1).all()
from osqp_tpu_torch.nn.layer import make_qp_layer
args = [torch.tensor(a, requires_grad=True) for a in (Pb, q[:3], np.stack([A] * 3),
                                                       -np.ones((3, m)), np.ones((3, m)))]
make_qp_layer(dtype=torch.float64)(*args).sum().backward()
assert all(a.grad is not None and a.grad.device.type == 'cpu' for a in args)
from osqp_tpu_torch.parallel import banded_qp_setup, banded_qp_solve, make_mesh
Pd = sp.diags([np.full(nb, 2.0), np.full(nb - 1, -0.9), np.full(nb - 1, -0.9)], [0, 1, -1])
r = banded_qp_solve(make_mesh((4,), ('mp',), device='cpu'),
                    banded_qp_setup(Pd.tocsc(), np.ones(nb), Ab, -1.5 * np.ones(nb),
                                    1.5 * np.ones(nb), 4, device='cpu'))
assert r.status == 1, r.status
assert not any(k == 'jax' or k.startswith(('jax.', 'osqp_tpu.')) for k in sys.modules
               if sys.modules[k] is not None)
print('ok')
"""


def test_port_imports_and_solves_without_jax():
    """A fresh interpreter in which importing jax or osqp_tpu fails imports
    every module of the port, solves a tiny batch and a small banded QP in
    sparse mode on the CPU, then the banded QP again with polishing, verbose
    printing and a time limit, the banded QP with a polish on the 'ldl'
    algebra (its symbolic pass built by g++), a batch with per-instance P on the vmap
    engine, a forward and backward pass of the nn layer and the banded QP
    on a 4-shard CPU mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, '-c', _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')


def test_no_device_without_cuda_raises(monkeypatch):
    """BatchedOSQP() with no device raises when CUDA is absent, on either
    engine, and so does the multi-device package's make_mesh()."""
    from osqp_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for engine in ('auto', 'vmap', 'shared'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            osqp_tpu_torch.BatchedOSQP(engine=engine)
    assert osqp_tpu_torch.BatchedOSQP(device='cpu')._device.type == 'cpu'
    for shape, names in (((4,), ('mp',)), ((2, 2), ('dp', 'mp'))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(shape, names)
    assert make_mesh((4,), ('mp',), device='cpu').device_list[0].type == 'cpu'


def test_cuda_tensor_without_kernel_raises_not_falls_back(monkeypatch):
    """The epoch wrapper never swaps in the plain version for a non-CPU
    tensor: on a device it cannot launch on, it raises."""
    from osqp_tpu_torch.ops import shared_epoch as tse

    t = torch.zeros(1, device='meta')
    stg = osqp_tpu_torch.settings.default_core_settings(torch.float32)
    sc = tse.epoch_scalars(stg, np.float32(1), np.float32(1), 1)
    with pytest.raises(ValueError, match='unsupported device'):
        tse.shared_epoch(*([t] * 20), sc)
