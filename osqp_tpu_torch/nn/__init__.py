"""Differentiable QP layers on torch tensors.

``layer.make_qp_layer`` is the counterpart of ``osqp_tpu.nn.layer``'s: a
batched layer whose forward pass is the vmap engine's ``batch_qp_solve`` and
whose backward pass solves the masked adjoint KKT systems of the whole batch
at once.  ``torch.OSQP`` is the counterpart of ``osqp_tpu.nn.torch.OSQP``,
the reference's module API (sparse patterns and their values), on the same
forward and backward.
"""
