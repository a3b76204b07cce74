"""Multi-device scale-out: the dp x mp batch, the row-sharded huge QP and
the halo-exchange banded QP over a device ``Mesh`` (the counterpart of
``osqp_tpu.parallel``), in one process or over the processes of a
``torch.distributed`` group (``distributed.initialize``, then
``make_mesh(..., group='world')``)."""

from .bigqp import (  # noqa: F401
    BigQPData, BigQPResult, BigQPRollout,
    big_qp_setup, big_qp_solve, big_qp_update_vec, big_qp_mpc_rollout,
)
from .banded import (  # noqa: F401
    BandedQPData, BandedRollout,
    banded_qp_setup, banded_qp_solve, banded_qp_update_vec,
    banded_mpc_rollout,
)
from . import distributed  # noqa: F401
from .distributed import initialize, process_count, process_index, shutdown  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import dp_mp_solve, make_batch_shardings  # noqa: F401

__all__ = [
    'BigQPData', 'BigQPResult', 'BigQPRollout',
    'big_qp_setup', 'big_qp_solve', 'big_qp_update_vec', 'big_qp_mpc_rollout',
    'BandedQPData', 'BandedRollout',
    'banded_qp_setup', 'banded_qp_solve', 'banded_qp_update_vec',
    'banded_mpc_rollout',
    'dp_mp_solve', 'make_batch_shardings',
    'Mesh', 'make_mesh',
    'distributed', 'initialize', 'process_count', 'process_index', 'shutdown',
]
