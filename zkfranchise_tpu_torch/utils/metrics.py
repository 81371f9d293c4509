"""Structured metrics and tracing: spans with JSON-lines output (slice
latencies, proofs/s) and an optional torch.profiler trace.  No secret
(key, password, signature) is ever logged.

A span records into the active Metrics: inside a ``recording(m)`` block
(ProofStream.run makes its own Metrics active) that is ``m``; anywhere
else the process-wide ``PROCESS``, which keeps only its totals (``timers``,
seconds by span name) and writes no record.  A span opened inside another
names it as its parent and carries its labels, so the spans of one slice
all carry the slice's ``base`` and ``batch``.  ``note`` adds values to the
record of the innermost open span alone (the step's ``step.finalize``
carries the witness's SMT counts so).

Only the spans in PROFILED also open a ``torch.profiler.record_function``
range, and only while a profiler is collecting: their bodies are host
work alone.  A range around work on the card shows on the device's
timeline as an annotation, which a trace's reader would take for device
work.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _profiler

from . import devices

# spans whose body does no work on the card (the stream's numpy and files,
# the key's ingest on the host): the ones that open a profiler range
PROFILED = frozenset({"stream.arrays", "stream.files", "ingest.read_zkey",
                      "ingest.permute", "ingest.pk_from_zkey",
                      "ingest.arrays_from_zkey"})

_ids = itertools.count(1)
# (id, labels, notes) of the innermost open span, or None
_open: contextvars.ContextVar = contextvars.ContextVar("metrics_open",
                                                       default=None)


@dataclass
class Metrics:
    sink: object = None                       # file-like; default stderr
    timers: dict = field(default_factory=dict)
    writes: bool = True                       # False: totals only

    def _emit(self, record: dict) -> None:
        out = self.sink or sys.stderr
        record["ts"] = time.time()
        print(json.dumps(record), file=out, flush=True)

    @contextlib.contextmanager
    def _timed(self, kind: str, name: str, labels: dict):
        """Times the block, adds its seconds to timers[name] and writes
        its record, also when the block raises."""
        parent = _open.get()
        if parent is not None:
            labels = {**parent[1], **labels}
        sid = next(_ids)
        notes: dict = {}
        token = _open.set((sid, labels, notes))
        ranged = None
        if name in PROFILED and _profiler._is_profiler_enabled:
            ranged = torch.profiler.record_function(name)
            ranged.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if ranged is not None:
                ranged.__exit__(None, None, None)
            _open.reset(token)
            self.timers[name] = self.timers.get(name, 0.0) + t1 - t0
            if self.writes and kind == "stage":
                self._emit({"kind": "stage", "stage": name,
                            "seconds": round(t1 - t0, 6), "id": sid,
                            "t0": t0, "t1": t1, **labels, **notes})
            elif self.writes:
                self._emit({"kind": "span", "name": name, "id": sid,
                            "parent": parent and parent[0], "t0": t0,
                            "t1": t1, **labels, **notes})

    def span(self, name: str, **labels):
        """A span of this Metrics: {"kind": "span", "name", "id", "parent",
        "t0", "t1", **labels}; t0 and t1 are perf_counter readings."""
        return self._timed("span", name, labels)

    def stage(self, name: str, **labels):
        """A span written as a stage record: {"kind": "stage", "stage",
        "seconds", "id", "t0", "t1", **labels}.  The stream's prove_batch
        is the only one."""
        return self._timed("stage", name, labels)


PROCESS = Metrics(writes=False)
_active: contextvars.ContextVar = contextvars.ContextVar("metrics_active",
                                                         default=PROCESS)


@contextlib.contextmanager
def recording(m: Metrics):
    """Makes `m` the active Metrics inside the block."""
    token = _active.set(m)
    try:
        yield
    finally:
        _active.reset(token)


def span(name: str, **labels):
    """A span of the active Metrics (see the module's docstring)."""
    return _active.get().span(name, **labels)


def note(**values) -> None:
    """Adds values to the record of the innermost open span, written when
    it closes (its children do not carry them); nothing outside a span."""
    current = _open.get()
    if current is not None:
        current[2].update(values)


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
