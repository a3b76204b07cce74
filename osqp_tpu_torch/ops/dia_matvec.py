"""DIA (diagonal-storage) matvec: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the TPU kernel ``tools/proto_dia_pallas.py::
make_dia_matvec_pallas`` and of the plain jnp function it prototypes,
``osqp_tpu/ops/spmv.py::_dia_matvec``, which the JAX package's sparse mode
runs for every ``DiaMatrix @ v``, ``.T @ y`` and ``gram_diag``::

    y[r] = sum_d bands[d, r] * v[r + offsets[d]],   r < m_out = bands.shape[1],

with terms whose index falls outside ``[0, len(v))`` dropped.

``dia_matvec`` launches the kernel in ``csrc/dia_matvec.cu`` for CUDA tensors
(and raises if it cannot) and runs ``dia_matvec_plain`` for CPU tensors.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset; a plain counter read by chip_smoke.py.
launches = 0

MAX_BANDS = 1024  # spmv._DIA_MAX_BANDS; the kernel keeps the offsets in shared memory


def _offset_list(offsets):
    if isinstance(offsets, torch.Tensor):
        return [int(o) for o in offsets.tolist()]
    return [int(o) for o in offsets]


def dia_matvec_plain(bands, offsets, v):
    """``spmv._dia_matvec`` in torch: pad ``v`` with ``m_out`` zeros on both
    sides and add the shifted slices times their bands in offset order.
    ``offsets`` is a sequence of ints or an int tensor."""
    D, m = bands.shape
    n = v.shape[0]
    offs = _offset_list(offsets)
    if not offs:
        return torch.zeros((m,), dtype=v.dtype, device=v.device)
    pad = max([m] + [abs(o) for o in offs])
    vp = torch.cat([v.new_zeros((pad,)), v, v.new_zeros((pad,))])
    acc = bands[0] * vp[pad + offs[0]:pad + offs[0] + m]
    for d in range(1, D):
        o = offs[d]
        acc = acc + bands[d] * vp[pad + o:pad + o + m]
    return acc


def _lib_fn(dtype):
    from ._build import load_library

    lib = load_library('dia_matvec')
    fn = lib.dia_matvec_f32 if dtype == torch.float32 else lib.dia_matvec_f64
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
    return fn


def dia_matvec(bands, offsets, v):
    """``y = S @ v`` for the DIA matrix ``(bands, offsets)``.

    ``bands``: ``(D, m_out)``; ``offsets``: ``(D,)`` int32 on the same
    device (a sequence of ints is taken for CPU tensors too); ``v``:
    ``(n_in,)``.  CUDA tensors: one launch of the Hopper kernel on the
    current stream.  CPU tensors: the plain version.  Returns a new
    ``(m_out,)`` tensor."""
    if v.device.type == 'cpu' and bands.device.type == 'cpu':
        return dia_matvec_plain(bands, offsets, v)
    if v.device.type != 'cuda':
        raise ValueError(f'dia_matvec: unsupported device {v.device}')
    dtype = v.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'dia_matvec: dtype must be float32 or float64, got {dtype}')
    if bands.dim() != 2 or v.dim() != 1:
        raise ValueError(f'dia_matvec: bands must be 2-D and v 1-D, got {tuple(bands.shape)} '
                         f'and {tuple(v.shape)}')
    D, m_out = bands.shape
    if not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int32 \
            or tuple(offsets.shape) != (D,) or offsets.device != v.device:
        raise ValueError(f'dia_matvec: offsets must be a ({D},) int32 tensor on {v.device}')
    if bands.device != v.device or bands.dtype != dtype:
        raise ValueError(f'dia_matvec: bands must be {dtype} on {v.device}, got '
                         f'{bands.dtype} on {bands.device}')
    if not (bands.is_contiguous() and v.is_contiguous() and offsets.is_contiguous()):
        raise ValueError('dia_matvec: bands, offsets and v must be contiguous')
    if D > MAX_BANDS:
        raise ValueError(f'dia_matvec: at most {MAX_BANDS} bands, got {D}')
    y = torch.empty((m_out,), dtype=dtype, device=v.device)
    if D == 0 or m_out == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    global launches
    with torch.cuda.device(v.device):
        err = _lib_fn(dtype)(bands.data_ptr(), offsets.data_ptr(), v.data_ptr(),
                             y.data_ptr(), D, m_out, v.shape[0], stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f'dia_matvec: CUDA kernel launch failed with error {err}')
    return y
