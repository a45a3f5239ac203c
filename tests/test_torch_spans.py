"""The runtime's span log (``core/metrics.py`` ``SpanLog``, ``SpanMetric``;
``runtime/device.py`` ``DeviceRuntime.spans``) on the CPU.

A small runtime (1.024 MS/s, a listener on the filterbank and one at a
channel edge on a full-rate bank, the waterfall) runs its own loop on the
test's thread, fed by a source that pauses past the loop's read timeout
between blocks and retunes both listeners from inside a read, so that
the first dispatch after each change is known.  Held here: one
``dispatch``, ``hold`` and ``complete`` a block with its children inside,
a hold ended by a read that timed out, each retune's ``apply`` closing at
the next dispatch, the log's bound, the profiler's ranges on the log's
clock, the per-block gauge and the registry's view.
"""

import json
import time

import numpy as np
import pytest
import torch

from openwebrx_tpu_torch.core.metrics import CODE_BITS, Metrics, SpanLog
from openwebrx_tpu_torch.runtime.device import DeviceRuntime

RATE = 1.024e6          # 32 filterbank channels of 32 kHz for SSB
TIMEOUT = 0.06          # the loop's read timeout while a block is in flight
BLOCKS = 6
PFB_DIAL, EDGE_DIAL = 100e3, 44e3          # channel 3 + 4 kHz; channel 1 + 12 kHz
RETUNES = {2: (130e3, 76e3), 4: (100e3, 44e3)}   # before block k: (pfb, edge)


class PausingSource:
    """Hands ``blocks`` uint8 blocks, each after the first to the read
    after one that timed out (it waits its whole timeout); before block
    ``k`` of ``RETUNES`` it retunes both listeners, on the reading thread.
    Once all are handed, it stops the runtime."""

    def __init__(self, blocks=BLOCKS, name="spans-test"):
        self.id = name
        self.block_size = None
        self.blocks = blocks
        self.handed = 0
        self.paused = False
        self.rt = self.handles = None
        self.changed = {}          # block → the change numbers made before it
        self.rng = np.random.default_rng(7)

    def get_sample_rate(self):
        return RATE

    def start(self):
        pass

    def read_block(self, timeout=1.0):
        if self.handed and not self.paused:
            time.sleep(timeout)
            self.paused = True
            return None
        if self.handed >= self.blocks:
            self.rt._running = False
            return None
        self.paused = False
        k = self.handed
        if k in RETUNES:
            # no other control call runs: the changes are numbered in order
            before = self.rt.spans["control"].count
            for h, hz in zip(self.handles, RETUNES[k]):
                h.set_offset(hz)
            self.changed[k] = [before, before + 1]
        self.handed += 1
        return self.rng.integers(120, 136, (self.block_size, 2), dtype=np.uint8)


def _runtime(src):
    rt = DeviceRuntime(src, fft_size=1024, compression="none", fft_compression="none",
                       capacity=4,
                       target_seconds=0.05, device="cpu")
    src.rt = rt
    pfb, edge = rt.open_channel("usb", PFB_DIAL), rt.open_channel("usb", EDGE_DIAL)
    assert pfb.bucket_key == "pfbi:ssb" and edge.bucket_key == "ssb"
    src.handles = (pfb, edge)
    rt.subscribe_waterfall(lambda payload: None)
    return rt


def _run_loop(rt):
    """The runtime's loop on this thread until the source has run out."""
    rt._running = True
    rt._loop()


def _by_id(rt, name):
    rec = rt.spans[name].records()
    return {int(r["id"]): r for r in rec}, rec


@pytest.fixture(scope="module")
def looped():
    src = PausingSource()
    rt = _runtime(src)
    _run_loop(rt)
    return rt, src


class TestBlockSpans:
    def test_each_block_has_one_dispatch_hold_and_complete_with_children(self, looped):
        rt, _ = looped
        for name in ("dispatch", "hold", "complete"):
            ids = sorted(int(i) for i in rt.spans[name].records()["id"])
            assert ids == list(range(BLOCKS)), name
        for parent, children in (("dispatch", ("upload",)),
                                 ("complete", ("fetch", "deliver"))):
            by_id, _ = _by_id(rt, parent)
            for child in children:
                rec = rt.spans[child].records()
                assert len(rec) == BLOCKS, child
                for r in rec:
                    p = by_id[int(r["id"])]
                    assert r["parent"] >> CODE_BITS == p["seq"] - 1
                    assert rt.spans.find(int(r["parent"])).name == parent
                    assert p["start"] <= r["start"] <= r["end"] <= p["end"], child

    def test_a_hold_past_the_read_timeout_was_ended_by_a_timed_out_read(self, looped):
        rt, _ = looped
        reads = rt.spans["read"]
        read = {int(r["seq"]) - 1: r for r in reads.records()}
        holds = rt.spans["hold"].records()
        # every block is held until a read times out: the next comes later
        for h in holds:
            cause = read[int(h["parent"]) >> CODE_BITS]
            assert reads.outcomes[cause["outcome"]] == "timeout"
            assert cause["id"] == -1
            assert h["end"] - h["start"] >= TIMEOUT
            assert cause["end"] <= h["end"]
        blocks = [r for r in reads.records() if reads.outcomes[r["outcome"]] == "block"]
        assert sorted(int(r["id"]) for r in blocks) == list(range(BLOCKS))

    def test_a_retune_applies_at_the_next_dispatch_on_either_bank(self, looped):
        rt, src = looped
        dispatch, _ = _by_id(rt, "dispatch")
        control, _ = _by_id(rt, "control")
        apply, _ = _by_id(rt, "apply")
        assert sorted(src.changed) == sorted(RETUNES)
        for k, changes in src.changed.items():
            for cid in changes:              # the filterbank's, then the full-rate bank's
                a, c = apply[cid], control[cid]
                assert a["ref"] == k
                assert a["parent"] >> CODE_BITS == c["seq"] - 1
                assert a["start"] == c["end"]
                assert a["end"] == dispatch[k]["start"] > a["start"]
                locks = [r for r in rt.spans["lock"].records() if r["id"] == cid]
                assert locks and all(c["start"] <= r["start"] <= r["end"] <= c["end"]
                                     for r in locks)

    def test_the_stall_of_one_block_shows_in_its_own_proc_block_ms(self):
        src = PausingSource(blocks=0, name="spans-test-gauge")
        rt = _runtime(src)
        seen = []

        def audio(wire, hd):
            if len(seen) == 3:
                time.sleep(0.05)
        src.handles[0].audio_cb = audio
        for _ in range(5):
            rt._process_block(np.full((rt.block, 2), 128, np.uint8))
            seen.append(rt.gauges["proc_block_ms"])
        assert rt.gauges["blocks"] == 5
        dispatch, _ = _by_id(rt, "dispatch")
        complete, _ = _by_id(rt, "complete")
        for k, ms in enumerate(seen):        # each block's own time, not an average
            own = 1e3 * (dispatch[k]["end"] - dispatch[k]["start"]
                         + complete[k]["end"] - complete[k]["start"])
            assert abs(ms - own) <= 1e-3, (k, ms, own)
        assert seen[3] >= 50.0 and complete[3]["end"] - complete[3]["start"] >= 0.05, seen
        rate = rt.block / (seen[4] / 1e3)
        assert abs(rt.gauges["samples_per_s"] - rate) <= 1e-3 * rate
        assert abs(rt.gauges["realtime_factor"] - rate / RATE) <= 0.01


class TestLog:
    def test_a_hundred_thousand_spans_stay_within_the_bound(self):
        log = SpanLog("spans-test-bound", {"x": ()})
        metric = log["x"]
        size = metric._rec.nbytes
        t0 = time.perf_counter()
        for i in range(100_000):
            with metric(rid=i):
                pass
        rec = metric.records()
        assert metric.capacity >= 65536 and len(rec) == metric.capacity
        assert metric._rec.nbytes == size
        assert metric.count == 100_000
        assert list(rec["id"][[0, -1]]) == [100_000 - metric.capacity, 99_999]
        # the first spans were overwritten: a window from before them reads nothing
        assert metric.durations(t0, time.perf_counter()) is None
        assert len(metric.durations(float(rec["start"][0]), time.perf_counter())) \
            == metric.capacity

    def test_the_registry_shows_each_span_count_and_sum(self, looped):
        rt, _ = looped
        m = Metrics.shared()
        tree = m.get_hierarchical()["device"][rt.source.id]["span"]
        json.dumps(tree)
        prom = m.render_prometheus().splitlines()
        for name in ("read", "dispatch", "hold", "complete", "deliver", "control", "apply"):
            metric = rt.spans[name]
            assert tree[name] == {"count": metric.count, "sum": metric.sum} and metric.count
            flat = f"device.{rt.source.id}.span.{name}".replace(".", "_")
            assert f"# TYPE {flat} summary" in prom
            assert f"{flat}_count {metric.count}" in prom
            assert f"{flat}_sum {metric.sum}" in prom


def test_the_profiler_trace_holds_the_ranges_on_the_log_clock(tmp_path):
    src = PausingSource(blocks=3, name="spans-test-profiled")
    rt = _runtime(src)
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("spans-test.first"):   # the first range's set-up
            pass
        marks = []
        for i in range(5):
            with record_function(f"spans-test.marker{i}"):
                marks.append(time.perf_counter())
        _run_loop(rt)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    # the trace's clock against perf_counter: a marker's start, read inside it
    # (a thread switch in between only makes the difference larger)
    offset = min(t - float(next(e["ts"] for e in events
                                if e.get("name") == f"spans-test.marker{i}")) * 1e-6
                 for i, t in enumerate(marks))
    for name in ("dispatch", "read", "deliver"):
        ranges = sorted(float(e["ts"]) * 1e-6 + offset for e in events
                        if e.get("name") == f"owrx.{name}" and e.get("ph") == "X")
        starts = sorted(float(s) for s in rt.spans[name].records()["start"])
        assert len(ranges) == len(starts) > 0, name
        assert np.max(np.abs(np.asarray(ranges) - np.asarray(starts))) < 1e-3, name
    # no profiler, no range: the flag the spans read is off again
    assert not torch.autograd.profiler._is_profiler_enabled
