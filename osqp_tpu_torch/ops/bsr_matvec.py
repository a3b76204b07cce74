"""BSR (block-ELL) matvec: the CUDA kernel's wrapper and its plain PyTorch
version.

No Pallas kernel stands behind it.  The JAX package computes every
``BsrMatrix @ v``, ``.T @ y`` and ``gram_diag`` as the jnp function
``osqp_tpu/ops/spmv.py::_bsr_matvec`` (``:297``), which XLA fuses on the TPU;
in eager PyTorch its gather lowering is a pad, a gather and a batched product,
so the port computes it with one hand-written kernel::

    y[8 b + r] = sum_k sum_c blocks[b, k, r, c] * v[128 bcols[b, k] + c],

for the rows below ``out_rows``, with v read as zero past its end.  The
block shape (8, 128) is the JAX package's, which its format ladder's costs
assume.

The kernel skips padding blocks: it reads the first ``nblk[b]`` blocks of
block-row b (``block_counts``, computed once per operator) and sets a
block-row with padding to NaN where the plain version's padding blocks times
``v[0 : 128]`` are NaN.

``bsr_matvec`` launches the kernel in ``csrc/bsr_matvec.cu`` for CUDA tensors
(and raises if it cannot) and runs ``bsr_matvec_plain`` for CPU tensors.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset; a plain counter read by chip_smoke.py.
launches = 0

R, C = 8, 128


def bsr_matvec_plain(blocks, bcols, v, out_rows):
    """The gather lowering of ``spmv._bsr_matvec``: pad ``v`` to whole
    block-columns, gather one segment per block, contract with
    ``einsum('bkrc,bkc->br')`` and cut to ``out_rows``."""
    nbr, Kb, r, c = blocks.shape
    n = v.shape[0]
    vp = v.new_zeros((-(-n // c) * c,))
    vp[:n] = v
    vg = vp.view(-1, c)[bcols.reshape(-1)].view(nbr, Kb, c)
    return torch.einsum('bkrc,bkc->br', blocks, vg).reshape(-1)[:out_rows]


def block_counts(blocks, bcols):
    """``nblk[b]`` = 1 + the last slot k of block-row b where ``bcols[b, k]
    != 0`` or block ``(b, k)`` holds a non-zero (0 for a block-row of padding
    only), an ``(nbr,)`` int32 tensor on the arrays' device: every slot at or
    past it is a padding block (a zero block at block-column 0)."""
    nbr, Kb = bcols.shape
    if nbr == 0 or Kb == 0:
        return torch.zeros((nbr,), dtype=torch.int32, device=bcols.device)
    used = (bcols != 0) | blocks.flatten(2).ne(0).any(-1)
    slot = torch.arange(1, Kb + 1, dtype=torch.int32, device=bcols.device)
    return (used * slot).amax(1)


def _lib_fn(dtype):
    from ._build import load_library

    lib = load_library('bsr_matvec')
    fn = lib.bsr_matvec_f32 if dtype == torch.float32 else lib.bsr_matvec_f64
    if fn.argtypes is None:
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, ll, ctypes.c_int, ll, ll, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def bsr_matvec(blocks, bcols, v, out_rows, nblk):
    """``y = S @ v`` for the block-ELL matrix ``(blocks, bcols)``, cut to
    ``out_rows`` rows.

    ``blocks``: ``(nbr, Kb, 8, 128)``; ``bcols``: ``(nbr, Kb)`` int32 on the
    same device, each a block-column of ``v`` (the kernel does not check);
    ``v``: ``(n,)``, read as zero past ``n``; ``nblk``:
    ``block_counts(blocks, bcols)`` (or any ``(nbr,)`` int32 counts in
    ``[0, Kb]`` past which every slot is a padding block; the kernel does
    not check).  CUDA tensors: one launch of the Hopper kernel on the
    current stream.  CPU tensors: the plain version, which reads every
    block and ignores ``nblk``.  Returns a new ``(out_rows,)`` tensor."""
    if v.device.type == 'cpu' and blocks.device.type == 'cpu':
        return bsr_matvec_plain(blocks, bcols, v, out_rows)
    if v.device.type != 'cuda':
        raise ValueError(f'bsr_matvec: unsupported device {v.device}')
    dtype = v.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'bsr_matvec: dtype must be float32 or float64, got {dtype}')
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (R, C) or v.dim() != 1:
        raise ValueError(f'bsr_matvec: blocks must be (nbr, Kb, {R}, {C}) and v 1-D, got '
                         f'{tuple(blocks.shape)} and {tuple(v.shape)}')
    if blocks.device != v.device or blocks.dtype != dtype:
        raise ValueError(f'bsr_matvec: blocks must be {dtype} on {v.device}, got '
                         f'{blocks.dtype} on {blocks.device}')
    nbr, Kb = blocks.shape[:2]
    if bcols.dtype != torch.int32 or tuple(bcols.shape) != (nbr, Kb) \
            or bcols.device != v.device:
        raise ValueError(f'bsr_matvec: bcols must be a ({nbr}, {Kb}) int32 tensor on {v.device}')
    if nblk.dtype != torch.int32 or tuple(nblk.shape) != (nbr,) or nblk.device != v.device:
        raise ValueError(f'bsr_matvec: nblk must be a ({nbr},) int32 tensor on {v.device}, got '
                         f'{nblk.dtype} {tuple(nblk.shape)} on {nblk.device}')
    if not (blocks.is_contiguous() and bcols.is_contiguous() and nblk.is_contiguous()
            and v.is_contiguous()):
        raise ValueError('bsr_matvec: blocks, bcols, nblk and v must be contiguous')
    if blocks.data_ptr() % 16:
        raise ValueError('bsr_matvec: blocks must be 16-byte aligned')
    out_rows = int(out_rows)
    if not 0 <= out_rows <= nbr * R:
        raise ValueError(f'bsr_matvec: out_rows must lie in [0, {nbr * R}], got {out_rows}')
    n = v.shape[0]
    y = torch.empty((out_rows,), dtype=dtype, device=v.device)
    if out_rows == 0 or Kb == 0 or n == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    global launches
    with torch.cuda.device(v.device):
        err = _lib_fn(dtype)(blocks.data_ptr(), bcols.data_ptr(), nblk.data_ptr(), v.data_ptr(),
                             y.data_ptr(), nbr, Kb, n, out_rows, int(v.data_ptr() % 16 == 0),
                             stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f'bsr_matvec: CUDA kernel launch failed with error {err}')
    return y
