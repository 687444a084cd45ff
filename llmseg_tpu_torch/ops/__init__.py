"""Importing the package registers the kernels' ``llmseg::`` custom ops
(``ops.kernels.kernel_op``)."""

from llmseg_tpu_torch.ops import attention, quant  # noqa: F401
