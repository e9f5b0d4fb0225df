"""Profiling: per-stage timing and torch.profiler traces.

Counterpart of `reid_tpu/utils/profiling.py`: `StageTimer` is
`utils/timing.StageTimer`, and `trace(log_dir)` records a block with
torch.profiler (host ops, and the card's kernels where there is one) into
a trace that TensorBoard's profiler plugin reads, where the JAX package
takes a jax.profiler trace.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from .timing import StageTimer

__all__ = ["StageTimer", "trace"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block, written to `log_dir` as
    `<host>_<pid>.<time>.pt.trace.json` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
