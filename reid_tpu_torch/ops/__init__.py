"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

`launch_counts()` / `reset_launch_counts()` read and clear the number of
kernel launches each wrapper has made. Importing the package registers the
custom ops `reid_tpu_torch::conv3x3_s8` and `reid_tpu_torch::se_basic_block_s8`
(`qconv`, `qblock`) and `reid_tpu_torch::conv2d_tf32` (`conv_tf32`), which
a loaded serving artifact calls; nothing is built until a kernel first
launches."""

from . import conv_tf32, qblock, qconv  # noqa: F401  registers the ops
from ._lib import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
