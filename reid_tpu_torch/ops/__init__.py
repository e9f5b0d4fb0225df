"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

`launch_counts()` / `reset_launch_counts()` read and clear the number of
kernel launches each wrapper has made."""

from ._lib import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
