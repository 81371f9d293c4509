"""The metrics' readers on runs made by hand: the rate counts every proof
over all the elapsed time, the tails are taken over every voter, and the
traced stretch is read from the profiler's events as it should be."""
import statistics
from pathlib import Path

import pytest

from benchmark.harness import cell, spec, trace, traffic, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)


def _read(name, run):
    return spec.reader(BENCH, name, ROOT).read(run)


def _run(window, records=(), failed=(), done=None, batch=4, reading=None):
    return cell.Run(cell=None, seed=1, setup_s=3.5,
                    spans={"key_ingest": 1.25, "capture": 2.0},
                    window=window, records=list(records),
                    attempted=window.handed or len(window.due),
                    failed=set(failed), done=done or {}, reading=reading,
                    batch=batch)


def _record(start, seconds, base, batch, wall=1000.0):
    return {"kind": "stage", "stage": "prove_batch", "seconds": seconds,
            "base": base, "batch": batch, "ts": wall + start + seconds}


def _records(*slices):
    """The stream's records of these slices: a stage record and, as
    ProofStream writes it, a throughput record after each."""
    out = []
    for s in slices:
        r = _record(*s)
        out += [r, {"kind": "throughput", "name": "proofs",
                    "items": r["batch"], "seconds": r["seconds"] + 0.01,
                    "ts": r["ts"]}]
    return out


def test_rate_counts_all_proofs_over_all_elapsed_time():
    w = traffic.Window("closed", 10.0, start=100.0, wall_start=1000.0)
    w.calls = [(100.0, 104.0, 4), (104.5, 108.0, 4), (108.1, 112.0, 4)]
    w.end, w.handed = 112.0, 12
    run = _run(w, _records((0.1, 3.5, 0, 4), (4.6, 3.0, 4, 4),
                           (8.2, 3.5, 8, 4)))
    assert _read("proofs_per_s", run) == pytest.approx(12 / 12.0)
    assert _read("step.slice_ms.backlog", run) == pytest.approx(1e3 * 10 / 3)
    assert _read("stream.host_ms_per_proof.backlog", run) == \
        pytest.approx(1e3 * (11.4 - 10.0) / 12)
    assert _read("latency_p95_ms", run) is None


def test_tails_are_over_every_voter():
    due = [0.1 * i for i in range(40)]
    w = traffic.Window("open", 4.0, start=0.0, wall_start=1000.0, due=due)
    w.handed, w.left = 40, 9.0
    done = {i: d + 0.5 for i, d in enumerate(due)}
    done[7] = due[7] + 3.0
    done[21] = due[21] + 4.0
    failed = {13}                       # a wrong proof waits until the end
    run = _run(w, failed=failed, done=done)
    lat = [1e3 * ((9.0 if i in failed else done[i]) - d)
           for i, d in enumerate(due)]
    assert _read("latency_p50_ms", run) == pytest.approx(
        statistics.quantiles(lat, n=100, method="inclusive")[49])
    assert _read("latency_p95_ms", run) == pytest.approx(
        statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert _read("latency_p95_ms", run) > 3000
    assert _read("proofs_per_s", run) is None


def test_queue_wait_reads_each_voters_slice():
    due = [0.0, 0.2, 0.4, 0.6]
    w = traffic.Window("open", 1.0, start=0.0, wall_start=1000.0, due=due)
    w.handed = 4
    run = _run(w, _records((0.0, 0.5, 0, 1), (0.5, 0.5, 1, 2),
                           (1.0, 0.3, 3, 1)))
    waits = [0.0, 300.0, 100.0, 400.0]
    assert _read("stream.queue_wait_p95_ms.arrivals", run) == pytest.approx(
        statistics.quantiles(waits, n=100, method="inclusive")[94])
    assert _read("step.slice_ms.arrivals", run) == pytest.approx(1e3 * 1.3 / 3)


def test_setup_spans():
    w = traffic.Window("closed", 1.0, start=0.0, wall_start=0.0)
    run = _run(w)
    assert _read("setup_s", run) == 3.5
    assert _read("setup.key_ingest_s", run) == 1.25
    assert _read("setup.capture_s", run) == 2.0


def _ev(name, dev, s, e):
    return (name, dev, int(s * 1e9), int(e * 1e9))


def test_trace_reduction_busy_gaps_and_families():
    events = [
        _ev("bench.run", False, 0.0, 1.0), _ev("bench.run", True, 0.0, 1.0),
        _ev("bench.prove_batch", False, 0.0, 0.9),
        _ev("aten::copy_", False, 0.6, 0.8),
        _ev("void mont_mul_kernel(int const*)", True, 0.1, 0.3),
        _ev("void add_kernel<PaddG1, true>(int const*)", True, 0.25, 0.5),
        _ev("Memcpy DtoH (Device -> Pageable)", True, 0.9, 0.95),
        _ev("void mont_mul_kernel(int const*)", True, 1.5, 1.6),   # outside
    ]
    r = trace.reduce(events)
    assert r.window_s == pytest.approx(1.0)
    assert r.busy_s == pytest.approx(0.45)
    assert r.family_n == {"mont_mul": 1, "padd/g1": 1}
    assert r.family_s["padd/g1"] == pytest.approx(0.25)
    assert r.idle_gaps[0][0] == "prove_batch:aten::copy_"
    assert r.idle_gaps[0][1] == pytest.approx(0.4)
    assert [g[0] for g in r.idle_gaps].count("stream:python") == 1
    assert r.device_ops[0][0] == "add_kernel<PaddG1, true>"


def test_roofline_leaves_out_a_family_whose_events_miss():
    r = trace.Reading(family_s={"mont_mul": 2e-3, "padd/g1": 1e-3},
                      family_n={"mont_mul": 2, "padd/g1": 3},
                      other_s={"at::copy": 1e-3}, slices=[4])
    captured = {4: {"mont_mul": {"full*col/R8192/T4": 2},
                    "padd/g1": {"g1/B1/T4": 2}}}
    pct, detail = trace.roofline(r, captured, 132, 1980.0, 0)
    b, m = work.launch_work("mont_mul", "full*col/R8192/T4")
    assert pct == pytest.approx(100 * 2 * work.bound_s(b, m, 132, 1980.0)
                                / 2e-3)
    assert list(detail["left_out"]) == ["padd/g1"]
    assert detail["uncounted_share_pct"] == pytest.approx(50.0)


def test_work_counts_match_the_programs_tools():
    # the multiply-adds of PERF.md's bounds (tools/__init__.py)
    assert work.add_mads("padd", "g1") == 11091
    assert work.add_mads("padd_aa", "g1") == 7431
    assert work.add_mads("padd", "g2") == 31758
    assert work.add_mads("padd_aa", "g2") == 21702
    assert work.MAD_MONT == 915
    nbytes, mads = work.launch_work("ntt_level", "n16384/T128")
    assert nbytes >= 4 * 21 * 2 * 16384 * 128
    assert mads == 915 * 8192 * 128
