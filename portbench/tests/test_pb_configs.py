"""The configuration's runtime and routing on the CPU: block size, banks,
every listener on a filterbank slot of its own."""

import json
from pathlib import Path

import pytest

from pbench.drive import Driver
from pbench.plan import BUCKET, make_plan

ROOT = Path(__file__).resolve().parents[2]


def _cell(name):
    """A traffic file and its configuration's file."""
    bench = ROOT / "portbench"
    return (json.loads((bench / "configs" / "hf8-web.json").read_text()),
            json.loads((bench / "traffic" / f"{name}.json").read_text()))


@pytest.mark.parametrize("name,block,banks", [
    ("web64.rt", 1638400, {"pfbi:ssb", "pfbi:am", "pfbi:nfm"}),
    ("web8.rt", 1638400, {"pfbi:ssb", "pfbi:am", "pfbi:nfm"}),
])
def test_routing_plan(name, block, banks):
    config, traffic = _cell(name)
    drv = Driver(config, "cpu")
    assert drv.block == block
    plan = make_plan(config, traffic, drv.block, 11, 10.0)
    drv.plan, drv.service = plan, plan.service
    for hid, (mode, station) in plan.listeners.items():
        drv.open(hid, mode, plan.dial(station))
    rt = drv.rt
    assert set(rt.banks) == banks
    seen = set()
    for hid, h in drv.handles.items():
        mode = plan.listeners[hid][0]
        assert h.bucket_key.endswith(":" + BUCKET[mode])
        assert (h.bucket_key, h.slot) not in seen
        seen.add((h.bucket_key, h.slot))
    assert {k: rt.banks[k].capacity for k in banks} == {k: 64 for k in banks}
