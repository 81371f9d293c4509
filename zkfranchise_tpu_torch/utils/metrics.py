"""Structured metrics and tracing: per-stage timers with JSON-lines output
(proofs/s, stage latencies) and an optional torch.profiler trace.  No
secret (key, password, signature) is ever logged.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from . import devices


@dataclass
class Metrics:
    sink: object = None                       # file-like; default stderr
    counters: dict = field(default_factory=dict)
    timers: dict = field(default_factory=dict)

    def _emit(self, record: dict) -> None:
        out = self.sink or sys.stderr
        record["ts"] = time.time()
        print(json.dumps(record), file=out, flush=True)

    @contextlib.contextmanager
    def stage(self, name: str, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timers[name] = self.timers.get(name, 0.0) + dt
            self._emit({"kind": "stage", "stage": name,
                        "seconds": round(dt, 6), **labels})

    def count(self, name: str, value: float = 1, **labels) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        self._emit({"kind": "counter", "name": name, "value": value,
                    **labels})

    def throughput(self, name: str, items: int, seconds: float,
                   **labels) -> None:
        self._emit({"kind": "throughput", "name": name, "items": items,
                    "seconds": round(seconds, 6),
                    "per_second": round(items / seconds, 3) if seconds else 0,
                    **labels})


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Wraps a block in a torch.profiler trace (CPU and, with a card, CUDA
    activity) when log_dir is given, and writes it there as a Chrome trace;
    the counterpart of a jax.profiler.trace block."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def force(device=None) -> None:
    """Wait until all work queued on `device` (default: the card; raises
    if there is none) has finished.  Kernel launches return before the
    device is done, so every host-clock timing of device work must pass
    through here before it reads the clock.  Nothing to wait for on the
    CPU."""
    dev = devices.resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(store: dict, name: str, device=None):
    """Times a block of device work honestly: the exit waits for the
    device (see force()) before reading the clock, and adds the seconds to
    store[name]."""
    dev = devices.resolve(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        force(dev)
        store[name] = store.get(name, 0.0) + time.perf_counter() - t0
