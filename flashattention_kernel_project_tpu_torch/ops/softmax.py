"""Softmax constants shared by the attention kernels' plain versions.

Counterpart of flashattention_kernel_project_tpu/ops/softmax.py, cut to the
constants on the serving path; the row-softmax kernel and the online-softmax
state machine are not ported yet.
"""

NEG_INF = float(-1e30)  # finite -inf stand-in, as the kernels use it
_LOG2E = 1.4426950408889634  # log2(e): the forward softmax runs in the log2 domain
