"""osqp_tpu_torch: the operator-splitting QP solver on PyTorch and CUDA.

The port of ``osqp_tpu`` to torch tensors on an NVIDIA Hopper GPU.  It imports
nothing of JAX or of ``osqp_tpu``.  Entry points run on CUDA unless the caller
passes ``device='cpu'``.  It holds the batched solver ``BatchedOSQP`` with two
engines: the shared-structure engine (P and A shared by the batch), whose
epoch runs as one hand-written CUDA kernel, and the vmap engine (every
instance its own P and A: batched Cholesky, explicit inverse or PCG; pure
entry points ``batch.batch_qp_solve`` and ``batch.mpc_rollout``); the
single-QP front end (``OSQP``), whose sparse mode runs PCG on DIA, ELL or BSR
operators with hand-written CUDA matvecs (or on cuSPARSE for ragged
patterns), with the adjoint and forward derivatives of its solution; and the
differentiable layers of the ``nn`` package (``nn.torch.OSQP``, the
reference's module API, and ``nn.layer.make_qp_layer``), forward through the
vmap engine, backward one batched adjoint KKT solve.
"""

import torch as _torch

# A QP solver needs true fp32 linear algebra: TF32 keeps about three decimal
# digits and stalls ADMM far above solver tolerances (the same hazard as
# bf16 matmul passes on the TPU).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision('highest')

from .batch import BatchedOSQP  # noqa: E402,F401
from .constants import SolverError, SolverStatus, constant, status_string  # noqa: E402,F401
from .exceptions import OSQPException  # noqa: E402,F401
from .interface import OSQP, OSQPSettings  # noqa: E402,F401

__version__ = '1.0.0.dev0'
