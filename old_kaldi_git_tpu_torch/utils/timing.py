"""Host-clock stage timings of the entry points, on request."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class StageClock:
    """Adds each stage's host-clock seconds, up to a device synchronise, to a
    caller's dict; does nothing (no synchronise either) without one."""

    def __init__(self, device: torch.device, timings: Optional[Dict[str, float]]):
        self.device, self.timings = device, timings
        self.t0 = time.perf_counter()

    def add(self, key: str, value: float) -> None:
        if self.timings is not None:
            self.timings[key] = self.timings.get(key, 0) + value

    def lap(self, key: Optional[str]) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if key is not None:
            self.add(key, now - self.t0)
        self.t0 = now
