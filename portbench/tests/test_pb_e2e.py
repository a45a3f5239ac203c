"""Latency and tune arithmetic on a fake run with set delays, and which
block a change reached."""

from types import SimpleNamespace

import pytest

from pbench import e2e
from pbench.drive import Record, deliveries


def _run(n_blocks=10, period=0.2, listeners=(0, 1), delay=0.25):
    rec = Record()
    handed = []
    got = {}
    for b in range(n_blocks):
        due = 100.0 + (b + 1) * period
        handed.append((b % 3, due, due + 0.001))
        rec.routing[b] = {h: ("pfbi:ssb", h) for h in listeners}
        rec.active[b] = ["pfbi:ssb"]
        rec.waterfall_ran[b] = False
        for h in listeners:
            rec.audio[h].append((b, due + delay + 0.01 * h, b"x"))
    drv = SimpleNamespace(rec=rec, source=SimpleNamespace(handed=handed),
                          first_window_block=2)
    return drv, deliveries(rec)


def test_latency_is_callback_minus_due():
    drv, got = _run()
    blocks = e2e.window_blocks(drv, 100.0, 10 * 0.2, realtime=True)
    assert blocks == list(range(2, 10))
    lat, due, missing = e2e.latency(drv, got, blocks)
    assert (due, missing) == (16, 0)
    assert sorted(round(x, 9) for x in lat) == sorted([0.25] * 8 + [0.26] * 8)
    assert e2e.p95(lat) == pytest.approx(0.26)


def test_a_missing_delivery_counts():
    drv, got = _run()
    del got[1][5]
    _, due, missing = e2e.latency(drv, got, list(range(2, 10)))
    assert (due, missing) == (16, 1)


def test_tune_counts_from_the_scheduled_time_to_the_first_block_after():
    drv, got = _run()
    drv.rec.control = [
        {"listener": 0, "first": 4, "scheduled": 100.5},     # block 4 due 101.0
        {"listener": 1, "first": 99, "scheduled": 101.0},    # never heard
        {"listener": 1, "first": 3, "scheduled": None},      # set-up: not counted
    ]
    times, changes, unheard = e2e.tune(drv, got, 100.0, 2.0)
    assert (changes, unheard) == (2, 1)
    assert times[0] == pytest.approx(101.0 + 0.25 - 100.5)
    assert times[1] == max(times)          # an unheard change is the longest


def test_a_change_made_during_a_dispatch_may_have_reached_that_block():
    from pbench.drive import Driver
    drv = SimpleNamespace(rec=Record(), dials={})
    drv.dials = __import__("collections").defaultdict(list)
    drv.rec.dispatch = {0: (10.0, 10.1), 1: (10.2, 10.3), 2: (10.4, 10.5)}
    drv.rec.n_dispatch = 3
    drv.rec.control = [
        {"listener": 1, "hz": 5.0, "requested": 10.15, "done": 10.16},   # between 0 and 1
        {"listener": 1, "hz": 6.0, "requested": 10.25, "done": 10.26},   # during 1
        {"listener": 2, "hz": 7.0, "requested": 10.55, "done": 10.56},   # after the last
    ]
    Driver.resolve(drv)
    assert [c["firsts"] for c in drv.rec.control] == [(1,), (1, 2), (3,)]
    assert [c["first"] for c in drv.rec.control] == [1, 2, 3]
    assert drv.ambiguous == 1
    assert drv.dials[1] == [(0, (1,), 5.0), (1, (1, 2), 6.0)]


def test_batched_deliveries_map_to_their_blocks():
    rec = Record()
    for b in (2, 2, 2, 5, 5, 5):
        rec.audio[7].append((b, 1.0, b""))
    assert sorted(deliveries(rec)[7]) == [0, 1, 2, 3, 4, 5]
