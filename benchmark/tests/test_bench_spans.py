"""The readers of the program's own spans on records made by hand: the
means of the window's spans (full slices only in a backlog, every slice
in an open loop), the set-up spans from the process's totals, and None
where the program records no such span (a program without them)."""
from pathlib import Path

import pytest

from benchmark.harness import cell, spec, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
WINDOW = {"stream.arrays_ms.backlog": "stream.arrays",
          "stream.files_ms.backlog": "stream.files",
          "step.enqueue_ms.backlog": "step.enqueue",
          "step.wait_ms.backlog": "step.wait",
          "step.finalize_ms.backlog": "step.finalize"}
SETUP = {"setup.ingest.read_zkey_s": "ingest.read_zkey",
         "setup.ingest.pk_s": "ingest.pk_from_zkey",
         "setup.ingest.arrays_s": "ingest.arrays_from_zkey"}


def _read(name, run):
    return spec.reader(BENCH, name, ROOT).read(run)


def _run(loop, records, batch=16):
    w = traffic.Window(loop, 30.0, start=0.0, wall_start=1000.0)
    return cell.Run(cell=None, seed=1, setup_s=30.0, spans={}, window=w,
                    records=records, attempted=0, failed=set(), done={},
                    batch=batch)


def _slice(base, batch, seconds):
    """A slice's records as the stream writes them; seconds: span name ->
    its length."""
    out, t = [], 10.0 + base
    for name in ("stream.arrays", "step.enqueue", "step.wait",
                 "step.finalize", "stream.files"):
        out.append({"kind": "span", "name": name, "id": len(out),
                    "parent": None, "t0": t, "t1": t + seconds[name],
                    "base": base, "batch": batch, "ts": 0.0})
        t += seconds[name]
    out.append({"kind": "stage", "stage": "prove_batch", "seconds": 1.0,
                "base": base, "batch": batch, "ts": 0.0})
    return out


def _seconds(scale):
    return {"stream.arrays": 0.020 * scale, "stream.files": 0.010 * scale,
            "step.enqueue": 0.030 * scale, "step.wait": 0.9 * scale,
            "step.finalize": 0.050 * scale}


def test_window_readers_take_the_mean_of_full_slices():
    records = _slice(0, 16, _seconds(1)) + _slice(16, 16, _seconds(3)) + \
        _slice(32, 8, _seconds(10))             # not full: left out
    run = _run("closed", records)
    for name, span in WINDOW.items():
        assert _read(name, run) == pytest.approx(
            1e3 * (_seconds(1)[span] + _seconds(3)[span]) / 2), name
    assert _read("step.enqueue_ms.arrivals", run) is None


def test_arrivals_enqueue_is_over_every_slice():
    records = _slice(0, 16, _seconds(1)) + _slice(16, 4, _seconds(2)) + \
        _slice(20, 1, _seconds(6))
    run = _run("open", records)
    assert _read("step.enqueue_ms.arrivals", run) == \
        pytest.approx(1e3 * 0.030 * 9 / 3)
    for name in WINDOW:
        assert _read(name, run) is None


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_window_readers_find_nothing_without_spans(loop):
    """A program whose stream records only prove_batch (and a throughput
    record a slice, as before the spans)."""
    records = [{"kind": "stage", "stage": "prove_batch", "seconds": 1.0,
                "base": 16 * i, "batch": 16, "ts": 0.0} for i in range(3)]
    records += [{"kind": "throughput", "name": "proofs", "items": 16,
                 "seconds": 1.0, "per_second": 16.0, "ts": 0.0}]
    run = _run(loop, records)
    for name in [*WINDOW, "step.enqueue_ms.arrivals"]:
        assert _read(name, run) is None


def test_setup_readers_read_the_process_totals(monkeypatch):
    from zkfranchise_tpu_torch.utils import metrics
    run = _run("closed", [])
    monkeypatch.setattr(metrics.PROCESS, "timers",
                        {"ingest.read_zkey": 2.5,
                         "ingest.pk_from_zkey": 1.25,
                         "ingest.arrays_from_zkey": 4.0,
                         "step.wait": 9.0})
    assert [_read(name, run) for name in SETUP] == [2.5, 1.25, 4.0]
    monkeypatch.setattr(metrics.PROCESS, "timers", {})
    assert [_read(name, run) for name in SETUP] == [None] * 3
    # a program without the process's totals
    monkeypatch.delattr(metrics, "PROCESS")
    assert [_read(name, run) for name in SETUP] == [None] * 3
