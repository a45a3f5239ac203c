"""The control schedule's counts and the stations' placement."""

import json
from pathlib import Path

import pytest

from pbench.plan import (PASSBAND, channel_of, filterbank_channels, make_plan)

BENCH = Path(__file__).resolve().parents[1]


def _load(traffic):
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return json.loads((BENCH / "configs" / "hf8-web.json").read_text()), t


BLOCK = {"hf8-web": 1638400}


@pytest.mark.parametrize("traffic", ["web64.rt", "web8.rt"])
def test_counts_do_not_depend_on_the_seed(traffic):
    cfg, t = _load(traffic)
    plans = [make_plan(cfg, t, BLOCK[cfg["name"]], seed, 10.0) for seed in (1, 2 ** 31 + 5)]
    control = t.get("control", {})
    want = {"retune": int(control.get("retunes_per_s", 0) * 10),
            "swap": int(control.get("join_leave_per_s", 0) * 10),
            "drag": int(control.get("edge_drags_per_s", 0) * 10)}
    want["return"] = want["drag"]
    for p in plans:
        assert {k: sum(e.kind == k for e in p.events) for k in want} == want
        assert len(p.listeners) == sum(g["count"] for g in t["listeners"])
    a, b = plans
    assert [(e.at, e.kind) for e in a.events] == [(e.at, e.kind) for e in b.events]
    assert [s["mode"] for s in a.stations] == [s["mode"] for s in b.stations]
    assert [s["hz"] for s in a.stations] != [s["hz"] for s in b.stations]


def test_changes_fall_between_block_boundaries():
    """Realtime blocks are released every 0.2 s; a change due at a release
    would race the dispatch on every run."""
    for traffic in ("web64.rt", "web8.rt"):
        cfg, t = _load(traffic)
        p = make_plan(cfg, t, BLOCK[cfg["name"]], 3, 10.0)
        period = BLOCK[cfg["name"]] / cfg["sample_rate"]
        for e in p.events:
            phase = (e.at / period) % 1.0
            assert 0.1 <= phase <= 0.9, (traffic, e)


@pytest.mark.parametrize("traffic", ["web64.rt", "web8.rt"])
def test_every_station_fits_its_filterbank_channel(traffic):
    cfg, t = _load(traffic)
    fs = cfg["sample_rate"]
    p = make_plan(cfg, t, BLOCK[cfg["name"]], 9, 10.0)
    for s in p.stations:
        m = filterbank_channels(fs, s["mode"])
        _, fine = channel_of(s["hz"], m, fs)
        lo, hi = PASSBAND[s["mode"]]
        half = 0.4 * fs / m                # the runtime's fit margin
        assert -half <= fine + lo and fine + hi <= half
        grid = fs / p.loop_len
        assert abs(s["hz"] / grid - round(s["hz"] / grid)) < 1e-9
    if t["stations"].get("every_channel"):
        m = filterbank_channels(fs, "usb")
        assert sorted(channel_of(s["hz"], m, fs)[0] for s in p.stations) == list(range(m))


def test_retunes_stay_within_the_listeners_mode():
    cfg, t = _load("web64.rt")
    p = make_plan(cfg, t, BLOCK["hf8-web"], 4, 10.0)
    modes = {hid: mode for hid, (mode, _) in p.listeners.items()}
    for e in p.warm_events + p.events:
        if e.kind == "swap":
            modes[e.new_listener] = e.mode
        elif e.kind in ("retune", "return"):
            assert p.stations[e.station]["mode"] == modes[e.listener]


def test_joins_keep_each_modes_count():
    cfg, t = _load("web64.rt")
    t = dict(t, control={"retunes_per_s": 0, "join_leave_per_s": 3})
    p = make_plan(cfg, t, BLOCK["hf8-web"], 4, 10.0)
    live = {hid: mode for hid, (mode, _) in p.listeners.items()}
    for e in p.events:
        assert live.pop(e.listener) == e.mode
        live[e.new_listener] = e.mode
    assert sorted(live.values()) == sorted(m for m, _ in p.listeners.values())
    assert len(p.events) == 30


def test_an_edge_drag_leaves_the_filterbank_and_comes_back():
    cfg, t = _load("web64.rt")
    fs = cfg["sample_rate"]
    p = make_plan(cfg, t, BLOCK["hf8-web"], 4, 10.0)
    m = filterbank_channels(fs, "usb")
    at = {}
    held = {}
    for e in p.events:
        if e.kind == "drag":
            _, fine = channel_of(e.hz, m, fs)
            # the USB passband crosses the channel's ±0.4 fit margin
            assert fine + PASSBAND["usb"][1] > 0.4 * fs / m
            at[e.listener], held[e.listener] = e.at, e.station
        elif e.kind == "return":
            assert e.at == pytest.approx(at.pop(e.listener) + 0.2)
            assert e.station == held.pop(e.listener)
        else:                      # nobody at the edge is retuned or leaves
            assert e.listener not in at
    assert len(at) == 0
