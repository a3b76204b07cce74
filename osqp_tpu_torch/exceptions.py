"""Exception types (own copy of ``osqp_tpu.exceptions``)."""

from __future__ import annotations


class OSQPException(Exception):
    """Raised when the solver reports an error.

    ``args[0]`` carries the integer :class:`osqp_tpu_torch.constants.SolverError`
    code, and equality against that code is supported, so callers can write
    ``except OSQPException as e: assert e == SolverError.OSQP_DATA_VALIDATION_ERROR``.
    """

    def __init__(self, error_code=None):
        if error_code is not None:
            self.args = (error_code,)

    def __eq__(self, error_code):
        return len(self.args) > 0 and self.args[0] == error_code

    def __hash__(self):
        return hash(self.args)
