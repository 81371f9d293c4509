"""The one traffic generator, and the loops that drive the stream with it.

A traffic mix is a data file of parameters (``traffic/<name>.json``):

- ``"loop": "closed"`` -- a backlog.  Before each call of
  ``ProofStream.run`` one batch of voters is appended, so the queue never
  holds less than one batch and the stream proves only full batches.  The
  window closes at the end of the first call that ends at or after
  ``--seconds``; no slice is cut in two.
- ``"loop": "open"`` -- independent voters arriving at ``rate_per_s``.
  The number of arrivals is the rate times the window; the gaps between
  them are exponential, as in a Poisson process, in one fixed order: every
  seed offers the same arrivals, and seeds differ in the voters only, so
  that the queueing, which sets the tails, is the same in every run
  (schedule).  Whenever
  the stream is idle, every voter that is due is appended and ``run`` is
  called; it proves full batches and then its power-of-two ladder.  After
  the window no voter is due, and the stream drains what is.

Voters are taken from the pool in order, cycling.  The loops read the
host clock only between calls of the program.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    loop: str
    seconds: float
    start: float                   # perf_counter at the window's start
    wall_start: float              # time.time() at the same moment
    end: float = 0.0               # closed: the last call's end
    handed: int = 0                # voters handed to the stream
    left: float = 0.0              # when the loop returned, s after start
    due: list = field(default_factory=list)      # open: offsets, s
    calls: list = field(default_factory=list)    # (t0, t1, proofs)


def schedule(params: dict, seconds: float) -> list:
    """The due times (seconds after the window's start) of an open loop:
    rate x window arrivals whose gaps are the exponential distribution's
    quantiles at (i + 1/2) / n, in one shuffled order for every seed,
    scaled so the last is due inside the window."""
    count = round(params["rate_per_s"] * seconds)
    gaps = [-math.log(1 - (i + 0.5) / count) for i in range(count)]
    random.Random(0).shuffle(gaps)
    scale = seconds / (sum(gaps) + 1.0)
    due, t = [], 0.0
    for g in gaps:
        t += g * scale
        due.append(t)
    return due


# an open loop stops waiting for its stream this long after the window
# closed: voters still without a proof then count as failed
DRAIN_LIMIT_S = 60.0


def _nothing(call: int, phase: str, elapsed: float) -> None:
    pass


def closed_loop(stream, pool: list, batch: int, seconds: float, seed: int,
                hook=_nothing, max_calls: int = 0) -> Window:
    voters: list = []
    w = Window("closed", seconds, time.perf_counter(), time.time())
    while True:
        n = len(voters)
        voters.extend(pool[(n + j) % len(pool)] for j in range(batch))
        hook(len(w.calls), "start", time.perf_counter() - w.start)
        t0 = time.perf_counter()
        made = stream.run(voters, seed=seed)
        t1 = time.perf_counter()
        hook(len(w.calls), "end", time.perf_counter() - w.start)
        w.calls.append((t0, t1, made))
        if t1 - w.start >= seconds or len(w.calls) == max_calls:
            break
    w.end, w.handed = t1, len(voters)
    w.left = t1 - w.start
    return w


def open_loop(stream, pool: list, due: list, seconds: float, seed: int,
              hook=_nothing) -> Window:
    voters: list = []
    w = Window("open", seconds, time.perf_counter(), time.time(), due=due)
    proven = 0
    while True:
        if time.perf_counter() - w.start > seconds + DRAIN_LIMIT_S:
            break
        now = time.perf_counter() - w.start
        while len(voters) < len(due) and due[len(voters)] <= now:
            voters.append(pool[len(voters) % len(pool)])
        if proven < len(voters):
            hook(len(w.calls), "start", time.perf_counter() - w.start)
            t0 = time.perf_counter()
            made = stream.run(voters, seed=seed)
            t1 = time.perf_counter()
            hook(len(w.calls), "end", time.perf_counter() - w.start)
            w.calls.append((t0, t1, made))
            proven += made
            if made <= 0:
                break
            continue
        if len(voters) == len(due):
            break
        time.sleep(max(0.0, due[len(voters)] - (time.perf_counter() -
                                                 w.start)))
    w.end = w.start + seconds
    w.handed = len(voters)
    w.left = time.perf_counter() - w.start
    return w
