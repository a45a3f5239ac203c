"""The readers of the program's own spans (``portbench/metrics/runtime.span.*``)
on the CPU: the tiny data-only cell of ``test_pb_cell.py`` runs with the
``Driver`` object kept, its ``Run`` is built as ``pbench/cell.py`` builds it, and
each reader reads the runtime's span log through the registry."""

import json
import math

import pytest

from pbench import e2e
from pbench.cell import BENCH, ROOT, reader
from pbench.readers import Run
from test_pb_cell import _run, root  # noqa: F401  (the tiny cell's checkout)

SPAN_READERS = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                if m["name"].startswith("runtime.span.")]


@pytest.fixture(scope="module")
def run(root):  # noqa: F811
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
    rec = drv.rec
    spans = {"dispatch": [rec.dispatch[b] for b in blocks if b in rec.dispatch],
             "wait": [rec.complete[b][:2] for b in blocks if b in rec.complete],
             "deliver": [rec.complete[b][1:] for b in blocks if b in rec.complete],
             "control": [(c["requested"], c["done"]) for c in rec.control
                         if c["scheduled"] is not None and c["scheduled"] <= t0 + 2.0]}
    return Run(spans=spans, blocks=len(blocks), changes=changes)


def test_every_span_metric_has_a_reader():
    assert len(SPAN_READERS) == 7
    for name in SPAN_READERS:
        assert (BENCH / "metrics" / f"{name}.py").is_file(), name


@pytest.mark.parametrize("name", SPAN_READERS)
def test_each_reader_reads_a_finite_number(run, name):
    assert run.blocks and run.changes
    value = reader(name)(run)
    assert value is not None and math.isfinite(value) and value >= 0, (name, value)


@pytest.mark.parametrize("inner, outer", [("runtime.span.deliver_ms.rt", "runtime.deliver_ms.rt"),
                                          ("runtime.span.control_ms.rt", "runtime.control_ms.rt")])
def test_the_program_span_lies_inside_the_benchmark_span(run, inner, outer):
    assert 0 < reader(inner)(run) <= reader(outer)(run)


def test_a_program_without_the_log_reads_nothing(run, monkeypatch):
    from openwebrx_tpu_torch.core.metrics import Metrics
    monkeypatch.setattr(Metrics.shared(), "metrics", {})
    for name in SPAN_READERS:
        assert reader(name)(run) is None, name
