"""The reader of msm.leaves_pct.backlog on runs made by hand: the share of
the MSMs' sum-tree leaves that the window's full slices planned, against
the full tables'."""
from pathlib import Path

import pytest

from benchmark.harness import cell, spec, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
NAME = "msm.leaves_pct.backlog"


def _read(run):
    return spec.reader(BENCH, NAME, ROOT).read(run)


def _run(window, records, batch=4):
    return cell.Run(cell=None, seed=1, setup_s=3.5,
                    spans={"key_ingest": 1.25, "capture": 2.0},
                    window=window, records=list(records),
                    attempted=window.handed or len(window.due),
                    failed=set(), done={}, reading=None, batch=batch)


def _finalize(batch, **counts):
    return {"kind": "span", "name": "step.finalize", "id": 0, "parent": None,
            "t0": 0.0, "t1": 0.02, "base": 0, "batch": batch, "ts": 0.0,
            **counts}


CUT = {"msm_leaves": 280576, "msm_leaves_full": 475136}
FULL = {"msm_leaves": 475136, "msm_leaves_full": 475136}


def _closed():
    return traffic.Window("closed", 30.0, start=0.0, wall_start=1000.0)


def test_msm_leaves_share_over_full_slices():
    """A cut slice at nl160 plans 280,576 of the full tables' 475,136
    leaves a window: 59.05 %."""
    run = _run(_closed(), [_finalize(4, **CUT), _finalize(4, **CUT)])
    assert _read(run) == pytest.approx(100 * 280576 / 475136)
    assert round(_read(run), 2) == 59.05


def test_msm_leaves_share_leaves_out_slices_not_full():
    """A slice on the full tables counts all its leaves; a slice smaller
    than the batch is left out."""
    run = _run(_closed(), [_finalize(4, **CUT), _finalize(4, **FULL),
                           _finalize(2, msm_leaves=1, msm_leaves_full=475136)])
    assert _read(run) == pytest.approx(
        100 * (280576 + 475136) / (2 * 475136))


def test_msm_leaves_share_is_none_without_counts_or_in_an_open_loop():
    """A program that notes no leaves, as the parent does, gives None, and
    so does an open-loop window."""
    assert _read(_run(_closed(), [_finalize(4, smt_hashed=3)])) is None
    assert _read(_run(_closed(), [])) is None
    opened = traffic.Window("open", 30.0, start=0.0, wall_start=1000.0)
    assert _read(_run(opened, [_finalize(4, **CUT)])) is None
