"""ELL (padded-row) matvec: the CUDA kernel's wrapper and its plain PyTorch
version.

No Pallas kernel stands behind it.  The JAX package computes every
``EllMatrix @ v``, ``.T @ y`` and ``gram_diag`` as the jnp expression
``jnp.sum(data * v[cols], axis=1)`` (``osqp_tpu/ops/spmv.py:240``), which XLA
fuses into one pass; in eager PyTorch that expression is three launches and an
(m, K) temporary, so the port computes it with one hand-written kernel::

    y[r] = sum_k data[r, k] * v[cols[r, k]],   r < m = data.shape[0].

``ell_matvec`` launches the kernel in ``csrc/ell_matvec.cu`` for CUDA tensors
(and raises if it cannot) and runs ``ell_matvec_plain`` for CPU tensors.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset; a plain counter read by chip_smoke.py.
launches = 0


def ell_matvec_plain(data, cols, v):
    """``(data * v[cols]).sum(1)``: the jnp expression in torch.  Pads (zero
    data at column 0) multiply ``v[0]``."""
    return (data * v[cols]).sum(1)


def group_log2(K: int) -> int:
    """log2 of the lanes the kernel gives one row: the least power of two
    >= K, at most 32."""
    return min(max(int(K) - 1, 0).bit_length(), 5)


def _lib_fn(dtype):
    from ._build import load_library

    lib = load_library('ell_matvec')
    fn = lib.ell_matvec_f32 if dtype == torch.float32 else lib.ell_matvec_f64
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def ell_matvec(data, cols, v):
    """``y = S @ v`` for the ELL matrix ``(data, cols)``.

    ``data``: ``(m, K)``; ``cols``: ``(m, K)`` int32 on the same device, each
    in ``[0, len(v))`` (the kernel does not check); ``v``: ``(n,)``.  CUDA
    tensors: one launch of the Hopper kernel on the current stream.  CPU
    tensors: the plain version.  Returns a new ``(m,)`` tensor."""
    if v.device.type == 'cpu' and data.device.type == 'cpu':
        return ell_matvec_plain(data, cols, v)
    if v.device.type != 'cuda':
        raise ValueError(f'ell_matvec: unsupported device {v.device}')
    dtype = v.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'ell_matvec: dtype must be float32 or float64, got {dtype}')
    if data.dim() != 2 or v.dim() != 1:
        raise ValueError(f'ell_matvec: data must be 2-D and v 1-D, got {tuple(data.shape)} '
                         f'and {tuple(v.shape)}')
    if data.device != v.device or data.dtype != dtype:
        raise ValueError(f'ell_matvec: data must be {dtype} on {v.device}, got '
                         f'{data.dtype} on {data.device}')
    if cols.dtype != torch.int32 or cols.shape != data.shape or cols.device != v.device:
        raise ValueError(f'ell_matvec: cols must be a {tuple(data.shape)} int32 tensor on '
                         f'{v.device}')
    if not (data.is_contiguous() and cols.is_contiguous() and v.is_contiguous()):
        raise ValueError('ell_matvec: data, cols and v must be contiguous')
    m, K = data.shape
    y = torch.empty((m,), dtype=dtype, device=v.device)
    if m == 0 or K == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    global launches
    with torch.cuda.device(v.device):
        err = _lib_fn(dtype)(data.data_ptr(), cols.data_ptr(), v.data_ptr(), y.data_ptr(),
                             m, K, group_log2(K), stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f'ell_matvec: CUDA kernel launch failed with error {err}')
    return y
