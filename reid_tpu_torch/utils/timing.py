"""Host-clock stage timing with the device synchronized at each boundary,
and the card-side timing and roofline bound of one kernel call."""

from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import torch

# Dense peaks by card (NVIDIA data sheets): int8 tensor ops/s, f32 flop/s
# outside the tensor cores (an FMA counts two), bytes/s.
PEAKS = {"H100 PCIe": dict(int8=1513e12, fp32=51.2e12, bytes=2.0e12),
         "H100 NVL": dict(int8=1671e12, fp32=60.0e12, bytes=3.9e12),
         "H200": dict(int8=1979e12, fp32=66.9e12, bytes=4.8e12),
         "H100": dict(int8=1979e12, fp32=66.9e12, bytes=3.35e12)}


def peaks(kind: str) -> dict:
    """The published peaks of the card named `kind`."""
    for key, val in PEAKS.items():
        if key in kind:
            return val
    raise RuntimeError(f"no published peaks for {kind!r}")


def bound(ops, nbytes, kind, rate="int8"):
    """The least time in ms: `ops` at the card's `rate` ("int8" tensor ops,
    "fp32" flops with an FMA as two, "fp32_alu" single f32 instructions
    such as an add: half the fp32 flop rate) or `nbytes` at its memory
    rate, whichever is longer; and which of the two it is."""
    pk = peaks(kind)
    per_s = pk["fp32"] / 2 if rate == "fp32_alu" else pk[rate]
    t_ops, t_bytes = ops / per_s * 1e3, nbytes / pk["bytes"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def time_ms(fn, reps=20, warm=3):
    """Median of `reps` CUDA-event timings of fn() after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_queued_ms(fn, reps=20, warm=3):
    """fn() `reps` times back to back, after `warm` calls: (device ms a call,
    CUDA events around the whole run; host ms a call to enqueue them). The
    device figure leaves out the host's launch overhead wherever the host
    enqueues faster than the card runs, which `time_ms` (an idle card
    before every call) includes."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.synchronize()
    return a.elapsed_time(b) / reps, host


class StageTimer:
    """`mark(name)` adds the seconds since the previous mark (or since the
    timer was made) to `timing[name]`, after synchronizing `device`. With
    `timing` None it does nothing, so an untimed run never synchronizes."""

    def __init__(self, timing: Optional[Dict[str, float]], device):
        self.timing = timing
        self.device = torch.device(device)
        self.t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timing is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timing[name] = self.timing.get(name, 0.0) + now - self.t0
        self.t0 = now
