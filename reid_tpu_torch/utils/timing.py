"""Host-clock stage timing with the device synchronized at each boundary."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


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
