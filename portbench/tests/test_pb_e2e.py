"""Latency and tune arithmetic on a fake run with set delays, and which
block a change reached."""

from collections import defaultdict
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


def _driver():
    """A Driver with nothing but its record, for what it works out after a run."""
    from pbench.drive import Driver
    drv = Driver.__new__(Driver)
    drv.rec, drv.dials = Record(), defaultdict(list)
    return drv


def test_a_change_made_during_a_dispatch_may_have_reached_that_block():
    from pbench.drive import Driver
    drv = _driver()
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


def test_a_call_made_during_a_dispatch_leaves_its_listener_unjudged_there():
    """Routing comes from what the benchmark's thread read after each call
    returned: a block whose dispatch began after the call has the new slot;
    one whose dispatch the call overlapped keeps the old one, and the
    listener that moved is unjudged around that block (the block before,
    whose delivery may read the new slot, to the first certain to have it),
    while the other listener and the other blocks are judged."""
    from pbench.check import delivery_faults, misrouted, unresolved
    drv = _driver()
    rec = drv.rec
    rec.dispatch = {b: (10.0 + 0.2 * b, 10.1 + 0.2 * b) for b in range(6)}
    rec.n_dispatch = 6
    rec.active = {b: {"pfbi:ssb": None} for b in range(6)}
    rec.complete = {b: (0.0, 0.0) for b in range(6)}
    rec.moves = [(1, 9.0, 9.1, ("pfbi:ssb", 3)), (2, 9.1, 9.2, ("pfbi:ssb", 5)),
                 (1, 10.45, 10.46, ("pfbi:ssb", 7))]        # during block 2's dispatch
    rec.control = [{"kind": "retune", "listener": 1, "left": 1, "hz": 5.0,
                    "requested": 10.45, "done": 10.46}]
    drv.resolve()
    assert [rec.routing[b][1] for b in range(6)] == [("pfbi:ssb", 3)] * 3 + [("pfbi:ssb", 7)] * 3
    assert all(rec.routing[b][2] == ("pfbi:ssb", 5) for b in range(6))
    assert rec.active[0] == ["pfbi:ssb"]
    assert rec.control[0]["firsts"] == (2, 3)
    pairs, slots = unresolved(rec)
    assert pairs == {(1, 1), (1, 2), (1, 3)}
    assert slots == {("pfbi:ssb", 3), ("pfbi:ssb", 7)}
    assert misrouted(rec) == 0
    # the moved listener's deliveries around the change are not due; the rest are
    got = {1: {b: (0.0, b"") for b in (0, 4, 5)}, 2: {b: (0.0, b"") for b in range(6)}}
    assert delivery_faults(rec, got) == 0
    del got[1][4]
    assert delivery_faults(rec, got) == 1


def test_two_listeners_on_one_slot_are_misrouted():
    drv = _driver()
    rec = drv.rec
    rec.dispatch = {b: (10.0 + 0.2 * b, 10.1 + 0.2 * b) for b in range(4)}
    rec.moves = [(1, 9.0, 9.1, ("pfbi:ssb", 3)), (2, 9.1, 9.2, ("pfbi:ssb", 5)),
                 (1, 10.25, 10.26, ("pfbi:ssb", 5))]         # onto 2's slot, between 1 and 2
    from pbench.check import misrouted
    drv.route()
    assert misrouted(rec) == 2                               # blocks 2 and 3


def test_batched_deliveries_map_to_their_blocks():
    rec = Record()
    for b in (2, 2, 2, 5, 5, 5):
        rec.audio[7].append((b, 1.0, b""))
    assert sorted(deliveries(rec)[7]) == [0, 1, 2, 3, 4, 5]
