"""The voters are fixed by the seed, the arrivals are the same for every
seed, and the reference's own statement holds for every voter made."""
import math

from benchmark.harness import traffic, voters
from benchmark.reference import census


def test_pool_fixed_by_seed():
    a = voters.pool(16, 24, 2**31 + 77)
    assert voters.pool(16, 24, 2**31 + 77) == a
    assert voters.pool(16, 24, 2**31 + 78)[0] != a[0]


def test_statement_holds_for_every_voter():
    inputs, signals = voters.pool(8, 20, 5)
    assert len({d["address"] for d in inputs}) == 20
    for d, s in zip(inputs, signals):
        got, holds = census.signals(d)
        assert holds and [str(x) for x in got] == s
        assert len(d["censusSiblings"]) == len(d["sikSiblings"]) == 9


def test_small_trees_redraw_colliding_paths():
    inputs, _ = voters.pool(6, 48, 3)       # 48 of 64 six-bit paths
    paths = {int(d["address"]) & 63 for d in inputs}
    assert len(paths) == 48


def test_schedule_fixed_by_seed():
    params = {"rate_per_s": 12.5}
    due = traffic.schedule(params, 30)
    assert due == traffic.schedule(params, 30)
    assert len(due) == 375 and due == sorted(due)
    assert 0 <= due[0] and due[-1] < 30


def test_every_seed_offers_the_same_gaps():
    """One order of the exponential gaps for every seed: the queueing, and
    with it the tails, do not move with the seed."""
    params = {"rate_per_s": 9.0}
    due = traffic.schedule(params, 30)
    gaps = [y - x for x, y in zip([0.0] + due, due)]
    assert gaps != sorted(gaps) and gaps != sorted(gaps, reverse=True)
    n = len(gaps)
    want = sorted(-math.log(1 - (i + 0.5) / n) for i in range(n))
    scale = 30 / (sum(want) + 1.0)
    assert [round(g / scale, 9) for g in sorted(gaps)] == \
        [round(g, 9) for g in want]
