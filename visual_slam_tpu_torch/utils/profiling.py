"""Stage timers (port of StageTimers in visual_slam_tpu/utils/profiling.py).

Each timed stage ends with a device synchronise when the device is a GPU,
so a stage's time includes its kernels and not only their enqueue. That is
one extra sync per stage; the tracking stage syncs on its own anyway
(ops/pnp.solve_pnp_tracked reads its branch decision on the host).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimers:
    """Per-stage lists of wall times (milliseconds), one entry per call."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ms = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.ms[name].append(1e3 * (time.perf_counter() - t0))

    def summary(self) -> dict:
        return {
            name: {
                "calls": len(v),
                "total_s": float(np.sum(v)) / 1e3,
                "median_ms": float(np.median(v)),
            }
            for name, v in sorted(self.ms.items())
        }

    def rate(self, name: str, units: int) -> float:
        """units per second spent in `name` (e.g. BA iterations/s)."""
        total = float(np.sum(self.ms.get(name, []))) / 1e3
        return units / total if total > 0 else 0.0
