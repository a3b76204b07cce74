"""ELL (padded-row) matvec: the CUDA kernel's wrapper and its plain PyTorch
version.

No Pallas kernel stands behind it.  The JAX package computes every
``EllMatrix @ v``, ``.T @ y`` and ``gram_diag`` as the jnp expression
``jnp.sum(data * v[cols], axis=1)`` (``osqp_tpu/ops/spmv.py:240``), which XLA
fuses into one pass; in eager PyTorch that expression is three launches and an
(m, K) temporary, so the port computes it with one hand-written kernel::

    y[r] = sum_k data[r, k] * v[cols[r, k]],   r < m = data.shape[0].

The kernel skips pads: it reads the slots of row r below ``lens[r]``
(``row_lens``, computed once per operator) and sets a row with pads to NaN
where the plain version's ``0 * v[0]`` is NaN.  It gives a row
``2^log2g`` lanes, ``log2g`` chosen once per operator by ``lanes_log2``.

``ell_matvec`` launches the kernel in ``csrc/ell_matvec.cu`` for CUDA tensors
(and raises if it cannot) and runs ``ell_matvec_plain`` for CPU tensors.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Kernel launches since the last reset; a plain counter read by chip_smoke.py.
launches = 0


def ell_matvec_plain(data, cols, v):
    """``(data * v[cols]).sum(1)``: the jnp expression in torch.  Pads (zero
    data at column 0) multiply ``v[0]``."""
    return (data * v[cols]).sum(1)


def row_lens(data, cols):
    """``lens[r]`` = 1 + the last slot k of row r where ``data[r, k] != 0`` or
    ``cols[r, k] != 0`` (0 for a row of pads only), an ``(m,)`` int32 tensor
    on the arrays' device: every slot at or past it is a pad (zero data at
    column 0)."""
    m, K = data.shape
    if m == 0 or K == 0:
        return torch.zeros((m,), dtype=torch.int32, device=data.device)
    slot = torch.arange(1, K + 1, dtype=torch.int32, device=data.device)
    return (((data != 0) | (cols != 0)) * slot).amax(1)


def lanes_log2(lens) -> int:
    """log2 of the lanes per row the kernel takes for rows of lengths
    ``lens``: the power of two nearest their mean on a log scale (8 for a
    mean from 5.66 to 11.3), at most 32; one lane for an empty operator.
    On the ELL family's operators (mean 9.0, 8.0 and 8.0 entries per row) it
    picks 8, the fastest of 4, 8, 16 and 32 on the H100 (PERF.md §6).  A
    host integer (one read of the mean), chosen once per operator."""
    mean = float(lens.float().mean()) if lens.numel() else 0.0
    return min(max(round(math.log2(mean)), 0), 5) if mean > 0 else 0


def _lib_fn(dtype):
    from ._build import load_library

    lib = load_library('ell_matvec')
    fn = lib.ell_matvec_f32 if dtype == torch.float32 else lib.ell_matvec_f64
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def ell_matvec(data, cols, v, lens, log2g):
    """``y = S @ v`` for the ELL matrix ``(data, cols)``.

    ``data``: ``(m, K)``; ``cols``: ``(m, K)`` int32 on the same device, each
    in ``[0, len(v))`` (the kernel does not check); ``v``: ``(n,)``;
    ``lens``: ``row_lens(data, cols)`` (or any ``(m,)`` int32 counts in
    ``[0, K]`` past which every slot is a pad; the kernel does not check);
    ``log2g``: lanes per row, in ``[0, 5]``.  CUDA tensors: one launch of
    the Hopper kernel on the current stream.  CPU tensors: the plain
    version, which reads every slot and ignores ``lens`` and ``log2g``.
    Returns a new ``(m,)`` tensor."""
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
    m, K = data.shape
    if lens.dtype != torch.int32 or tuple(lens.shape) != (m,) or lens.device != v.device:
        raise ValueError(f'ell_matvec: lens must be a ({m},) int32 tensor on {v.device}, got '
                         f'{lens.dtype} {tuple(lens.shape)} on {lens.device}')
    if not (data.is_contiguous() and cols.is_contiguous() and lens.is_contiguous()
            and v.is_contiguous()):
        raise ValueError('ell_matvec: data, cols, lens and v must be contiguous')
    log2g = int(log2g)
    if not 0 <= log2g <= 5:
        raise ValueError(f'ell_matvec: log2g must lie in [0, 5], got {log2g}')
    y = torch.empty((m,), dtype=dtype, device=v.device)
    if m == 0 or K == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    global launches
    with torch.cuda.device(v.device):
        err = _lib_fn(dtype)(data.data_ptr(), cols.data_ptr(), lens.data_ptr(), v.data_ptr(),
                             y.data_ptr(), m, K, log2g, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f'ell_matvec: CUDA kernel launch failed with error {err}')
    return y
