"""Device time of a function on the card: CUDA events and torch.profiler.

Used by chip_smoke.py and the tools; every function here needs a CUDA card.
"""
from __future__ import annotations

import torch


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Time per call of fn() in ms, between CUDA events around `iters`
    back-to-back calls: the device's time, or the host's where launching
    the calls takes longer than running them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(evt) -> float:
    """Device time (us) of one profiler `key_averages()` row."""
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def device_ms(fn, iters=50, tries=3) -> tuple[float, str]:
    """Device time of one fn() call in ms, and how it was measured.

    "profiler": the summed time of every CUDA kernel and copy it runs, from
    torch.profiler, over `iters` calls. A profiler window that recorded no
    device activity is taken again; after `tries` empty windows, "queued"
    (queued_ms)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(device_us(e) for e in prof.key_averages())
        if us > 0:
            return us / 1e3 / iters, "profiler"
    return queued_ms(fn, iters), "queued"


def queued_ms(fn, iters=50) -> float:
    """Device time of one fn() call in ms: CUDA events around `iters` calls
    queued behind a device-side sleep, so they run back to back (includes
    the ~1 us gaps between launches). Needs no profiler, so it cannot miss
    kernels the way a profiler window that drops events does."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # ~0.1 s: the host queues every call meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
