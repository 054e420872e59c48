"""Timing and profiling helpers (counterpart of
``vae_los_angeles_tpu/utils/profiling.py``).

CUDA launches return before the card has run them, so `device_timer`
synchronizes the CUDA device at both ends of the block, where the JAX
helpers block until the arrays are ready. `trace` is the training CLI's
``--profile``: a ``torch.profiler`` session whose Chrome trace
(``*.pt.trace.json``) lands in ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class StepTimer:
    """Wall-clock timer of a ``with`` block (host clock)."""

    def __init__(self):
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def synchronize(device=None):
    """Wait for the CUDA device's queued work (nothing for the CPU)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_initialized():
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(device=None):
    """Times a block including the completion of the device work it queued."""
    synchronize(device)
    timer = StepTimer()
    with timer:
        yield timer
        synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = None):
    """A ``torch.profiler`` session of the block (CPU activities, and CUDA
    ones when ``cuda``, by default when a card is present); its Chrome trace
    is written into ``log_dir`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def bench_line(metric: str, value: float, unit: str, vs_baseline: float) -> str:
    return json.dumps(
        {
            "metric": metric,
            "value": round(float(value), 4),
            "unit": unit,
            "vs_baseline": round(float(vs_baseline), 4),
        }
    )
