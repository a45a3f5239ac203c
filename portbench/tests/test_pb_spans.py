"""The readers of the program's own spans (``portbench/metrics/runtime.span.*``)
on the CPU: the tiny data-only cell of ``test_pb_cell.py`` runs with the
``Driver`` object kept, its ``Run`` is built as ``pbench/cell.py`` builds it, and
each reader reads the runtime's span log through the registry.  A reader of
what only a card records (``CARD_ONLY``) reads nothing here.  The per-layer
``delivery.latency_p95_ms.rt`` reads the benchmark's own clock instead."""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from pbench import e2e
from pbench.cell import BENCH, ROOT, reader, window_spans
from pbench.drive import deliveries
from pbench.readers import Run
from test_pb_cell import _run, root  # noqa: F401  (the tiny cell's checkout)

SPAN_READERS = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                if m["name"].startswith("runtime.span.")]
# the ``stage`` span: the upload's copy into pinned memory, on a card only
CARD_ONLY = {"runtime.span.stage_p95_ms.rt"}


@pytest.fixture(scope="module")
def ran(root):  # noqa: F811
    """The tiny cell's run → its ``Run``, the ``Driver`` and the window's start."""
    kept = {}

    def keep(drv):
        window = drv.window

        def timed(*args, **kwargs):
            kept["t0"], traced = window(*args, **kwargs)
            return kept["t0"], traced
        drv.window = timed
        kept["drv"] = drv
    result = _run(root, hooks=keep)
    assert result["correct"], result["checks"]
    drv, t0 = kept["drv"], kept["t0"]
    # as pbench/cell.py builds it for the readers (the tiny cell: 2 s, saturate)
    blocks = e2e.window_blocks(drv, t0, 2.0, False)
    _, changes, _ = e2e.tune(drv, {}, t0, 2.0)
    lat, _, _ = e2e.latency(drv, deliveries(drv.rec), blocks)
    run = Run(spans=window_spans(drv.rec, blocks, t0 + 2.0), blocks=len(blocks),
              changes=changes, latencies=lat)
    return SimpleNamespace(run=run, drv=drv, t0=t0)


@pytest.fixture
def run(ran):
    return ran.run


def test_every_span_metric_has_a_reader():
    files = sorted(f.name[:-3] for f in (BENCH / "metrics").glob("runtime.span.*.py"))
    assert SPAN_READERS and sorted(SPAN_READERS) == files
    assert CARD_ONLY <= set(SPAN_READERS)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_each_reader_reads_a_finite_number(run, name):
    assert run.blocks and run.changes
    value = reader(name)(run)
    if name in CARD_ONLY:
        assert value is None, (name, value)
    else:
        assert value is not None and math.isfinite(value) and value >= 0, (name, value)


@pytest.mark.parametrize("inner, outer", [("deliver", "complete"), ("control", "control")])
def test_the_program_span_lies_inside_the_benchmark_span(ran, inner, outer):
    """Each of the program's ``deliver`` spans (``runtime.span.deliver_ms.rt``)
    lies inside the benchmark's stamps of that block's ``_complete_block``,
    and each ``control`` span (``runtime.span.control_ms.rt``) inside the
    benchmark's stamps of one control call."""
    from openwebrx_tpu_torch.core.metrics import Metrics
    run, rec = ran.run, ran.drv.rec
    stamps = run.spans[outer]
    lo, hi = min(a for a, _ in stamps), max(b for _, b in stamps)
    records = Metrics.shared().get(f"device.portbench.span.{inner}").records()
    inside = records[(records["start"] >= lo) & (records["start"] <= hi)]
    assert len(inside) >= len(stamps) > 0
    for r in inside:
        if inner == "deliver":
            a, b = rec.complete[int(r["id"])]
        else:
            a, b = next(((a, b) for a, b in stamps if a <= r["start"] <= b), (None, None))
            assert a is not None, r
        assert a <= r["start"] <= r["end"] <= b, (r, a, b)


def test_the_split_adds_up_to_the_latency(ran):
    """``portbench/split.py``'s pieces of each delivery of the window add up
    to its latency."""
    import split
    got = split.pieces(ran.drv, ran.t0, 2.0, False)
    assert got["latency"] and set(got["block"]) <= set(ran.drv.rec.dispatch)
    total = np.sum([got[k] for k in split.PIECES], axis=0)
    assert np.allclose(total, got["latency"], rtol=0, atol=1e-6)


def test_the_latency_reader_is_the_p95_of_every_delivery(run):
    """``delivery.latency_p95_ms.rt`` (the benchmark's own clock, not a
    span) reads the 95th percentile of callback minus due over every
    delivery of the window, and nothing where none was due."""
    from dataclasses import replace
    read = reader("delivery.latency_p95_ms.rt")
    lat = np.sort(run.latencies)
    assert len(lat) and lat[0] > 0
    want = 1e3 * lat[int(np.ceil(0.95 * (len(lat) - 1)))]
    assert read(run) == pytest.approx(want, rel=0, abs=1e-9)
    assert read(replace(run, latencies=[0.001] * 19 + [0.5])) == pytest.approx(500.0)
    assert read(replace(run, latencies=[])) is None


def test_a_program_without_the_log_reads_nothing(run, monkeypatch):
    from openwebrx_tpu_torch.core.metrics import Metrics
    monkeypatch.setattr(Metrics.shared(), "metrics", {})
    for name in SPAN_READERS:
        assert reader(name)(run) is None, name
