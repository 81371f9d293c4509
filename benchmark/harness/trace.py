"""The traced run: torch.profiler over a steady stretch, and what the
benchmark reads from it.

Only a run with ``--trace 1`` profiles, and only after its measured window,
which therefore runs as in any other run.  The stretch is the cell's own
traffic on a stream of its own: in a closed loop two calls of
``ProofStream.run`` (two full slices), in an open loop STRETCH_S of
arrivals, of which the calls that start after a third are profiled until
PROFILE_S of proving has been traced.  Each call is marked ``bench.run``,
each ``prove_batch`` of the program ``bench.prove_batch``, so that device
time, idle gaps and the host's activity in them line up on the profiler's
own clock.  Waits for arrivals between calls are not proving and are left
out of the traced window.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import work

PROFILE_S = 2.0
STRETCH_S = 8.0
CLOSED_CALLS = (0, 1)
TOP = 10


@dataclass
class Reading:
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)   # [name, seconds]
    idle_gaps: list = field(default_factory=list)    # [label, seconds]
    family_s: dict = field(default_factory=dict)     # family: seconds
    family_n: dict = field(default_factory=dict)     # family: kernels
    other_s: dict = field(default_factory=dict)      # uncounted: seconds
    slices: list = field(default_factory=list)       # sizes profiled
    eager: dict = field(default_factory=dict)        # counters' diff


class Tracer:
    """Starts and stops the profiler at the loop's call boundaries."""

    def __init__(self, loop: str, counters, records):
        """counters() reads the program's launch counters; records() the
        stream's Metrics records so far."""
        self.loop = loop
        self.counters, self.records = counters, records
        self.prof = None
        self.done = False
        self.traced_s = self.stop_s = 0.0
        self.before = self.after = None
        self._range = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start
        (CUPTI's initialisation) does not land in the stretch."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def hook(self, call: int, phase: str, now: float = 0.0) -> None:
        if self.done:
            return
        if phase == "start":
            if self.prof is None and self._wants(call, now):
                self._start()
            if self.prof is not None:
                self._enter()
        else:
            if self.prof is None:
                return
            self._exit()
            if self._enough(call):
                self._stop()

    def _wants(self, call: int, now: float) -> bool:
        if self.loop == "closed":
            return call == CLOSED_CALLS[0]
        return now >= STRETCH_S / 3

    def _enough(self, call: int) -> bool:
        if self.loop == "closed":
            return call >= CLOSED_CALLS[1]
        return self.traced_s >= PROFILE_S

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.before = (self.counters(), len(self.records()))
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def _enter(self) -> None:
        import time

        from torch.profiler import record_function
        self._range = record_function("bench.run")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def _exit(self) -> None:
        import time
        self._range.__exit__(None, None, None)
        self.traced_s += time.perf_counter() - self._t0

    def _stop(self) -> None:
        import time

        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t0
        self.after = (self.counters(), len(self.records()))
        self.done = True

    def finish(self) -> None:
        """Stops a profile the window left running."""
        if self.prof is not None and not self.done:
            self._stop()


def events(prof) -> list:
    """[(name, on device, start ns, end ns)] of a stopped profile."""
    try:
        raw = prof.profiler.kineto_results.events()
        out = []
        for e in raw:
            dev = str(e.device_type()).endswith("CUDA")
            out.append((e.name(), dev, e.start_ns(),
                        e.start_ns() + e.duration_ns()))
        return out
    except AttributeError:
        out = []
        for e in prof.events():
            dev = str(e.device_type).endswith("CUDA")
            out.append((e.name, dev, int(e.time_range.start * 1e3),
                        int(e.time_range.end * 1e3)))
        return out


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)",
                                                "anon")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def reduce(events: list) -> Reading:
    """Device busy time, kernel time by name and by counter family, and
    the idle gaps with the host's activity in them, over the ``bench.run``
    ranges of a profile."""
    r = Reading()
    runs = _merge([(s, e) for n, dev, s, e in events
                   if not dev and n == "bench.run"])
    proves = [(s, e) for n, dev, s, e in events
              if not dev and n == "bench.prove_batch"]
    host = [(n, s, e) for n, dev, s, e in events
            if not dev and not n.startswith("bench.")]
    # a marked range also shows on the device as an annotation: not work
    device = [(n, s, e) for n, dev, s, e in events
              if dev and not n.startswith("bench.")]
    by_name: dict = {}
    gaps: list = []
    for lo, hi in runs:
        r.window_s += (hi - lo) / 1e9
        inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                  if e > lo and s < hi]
        for n, s, e in inside:
            sec = (e - s) / 1e9
            short = short_name(n)
            by_name[short] = by_name.get(short, 0.0) + sec
            fam = work.family(n)
            if fam is None:
                r.other_s[short] = r.other_s.get(short, 0.0) + sec
            else:
                r.family_s[fam] = r.family_s.get(fam, 0.0) + sec
                r.family_n[fam] = r.family_n.get(fam, 0) + 1
        merged = _merge([(s, e) for _, s, e in inside])
        r.busy_s += sum(e - s for s, e in merged) / 1e9
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps += [(ge - gs, gs, ge) for gs, ge in zip(edges[0::2], edges[1::2])
                 if ge > gs]
    r.device_ops = sorted(([n, s] for n, s in by_name.items()),
                          key=lambda x: -x[1])[:TOP]
    r.idle_gaps = [[_label(gs, ge, proves, host), length / 1e9]
                   for length, gs, ge in sorted(gaps, reverse=True)[:TOP]]
    return r


def _label(gs: int, ge: int, proves: list, host: list) -> str:
    """Where the host was in an idle gap: inside the program's
    prove_batch or in the stream around it, and the host operation that
    covers at least half of the gap ("python" where the profiler saw
    none: Python that calls no operation)."""
    mid = (gs + ge) // 2
    where = "prove_batch" if any(s <= mid < e for s, e in proves) \
        else "stream"
    best, most = "python", (ge - gs) / 2
    for n, s, e in host:
        overlap = min(e, ge) - max(s, gs)
        if overlap >= most:
            best, most = n, overlap
    return f"{where}:{best}"


def roofline(reading: Reading, captured: dict, sms: int,
             sm_mhz: float, domain: int) -> tuple:
    """(share of the roofline in %, or None; detail) over the counted
    kernels of the stretch: the sum of their launches' bounds over the
    sum of their device time.  The launches are the captured steps' of
    each profiled slice and the eager ones the counters saw in the
    stretch (finalize's).  A family whose kernel events in the trace do
    not match its launches is left out, and said so."""
    expected: dict = {}

    def add(launches: dict) -> None:
        for fam, keys in launches.items():
            for key, n in keys.items():
                expected.setdefault(fam, {})
                expected[fam][key] = expected[fam].get(key, 0) + n

    for size in reading.slices:
        add(captured[size])
    add(reading.eager)
    bound, device, detail = 0.0, 0.0, {"families": {}, "left_out": {}}
    for fam, keys in expected.items():
        launches = sum(keys.values())
        seen = reading.family_n.get(fam, 0)
        fam_bound = sum(n * work.bound_s(*work.launch_work(fam, key), sms,
                                         sm_mhz) for key, n in keys.items())
        if seen != launches:
            detail["left_out"][fam] = {"launches": launches,
                                       "kernel_events": seen}
            continue
        bound += fam_bound
        device += reading.family_s.get(fam, 0.0)
        detail["families"][fam] = {
            "launches": launches, "bound_s": fam_bound,
            "device_s": reading.family_s.get(fam, 0.0)}
    total = sum(reading.family_s.values()) + sum(reading.other_s.values())
    counted = sum(v["device_s"] for v in detail["families"].values())
    detail["uncounted_share_pct"] = 100 * (1 - counted / total) \
        if total else None
    detail["uncounted_s"] = dict(sorted(reading.other_s.items(),
                                        key=lambda x: -x[1])[:TOP])
    return (100 * bound / device if device else None), detail
