"""The realtime source's schedule and backlog, the saturating source."""

import time

import numpy as np

from pbench.source import LoopSource


def _source(block=100, fs=1000.0, loop=3):
    src = LoopSource(np.zeros((loop * block, 2), np.uint8), fs)
    src.block_size = block
    return src


def test_realtime_releases_each_block_when_its_last_sample_is_due():
    src = _source()                        # a block is 0.1 s
    t0 = time.perf_counter()
    src.window("realtime", t0, 0.35)
    assert src.read_block(timeout=0.03) is None          # not yet due
    x = src.read_block(timeout=0.5)
    got = time.perf_counter() - t0
    assert x is not None and 0.095 <= got < 0.2
    assert abs(src.handed[-1][1] - (t0 + 0.1)) < 1e-9


def test_realtime_backlog_is_waiting_and_late_is_recorded():
    src = _source()
    t0 = time.perf_counter()
    src.window("realtime", t0, 1.0)
    time.sleep(0.33)                       # three blocks are due by now
    for _ in range(3):
        assert src.read_block(timeout=0.0) is not None
    assert src.read_block(timeout=0.0) is None
    assert [round(d - t0, 6) for _, d, _ in src.handed] == [0.1, 0.2, 0.3]
    assert src.late[0] > src.late[2] >= 0.0


def test_realtime_stops_at_the_window_and_loops_the_wire():
    src = _source(loop=2)
    src.window("realtime", time.perf_counter() - 10.0, 0.45)
    n = 0
    while src.read_block(timeout=0.0) is not None:
        n += 1
    assert n == 4
    assert [h[0] for h in src.handed] == [0, 1, 0, 1]


def test_saturate_hands_blocks_at_once_until_stop():
    src = _source()
    t0 = time.perf_counter()
    src.window("saturate", t0, 0.05)
    n = 0
    while src.read_block(timeout=0.0) is not None:
        n += 1
    assert n > 10
    assert time.perf_counter() - t0 < 0.2
