"""Multi-device scale-out: the dp x mp batch, the row-sharded huge QP and
the halo-exchange banded QP over a single-process device ``Mesh`` (the
counterpart of ``osqp_tpu.parallel``)."""

from .bigqp import (  # noqa: F401
    BigQPData, BigQPResult, BigQPRollout,
    big_qp_setup, big_qp_solve, big_qp_update_vec, big_qp_mpc_rollout,
)
from .banded import (  # noqa: F401
    BandedQPData, BandedRollout,
    banded_qp_setup, banded_qp_solve, banded_qp_update_vec,
    banded_mpc_rollout,
)
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
]
