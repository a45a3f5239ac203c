"""A cell's plan, drawn from its seed: the stations on the air, the
listeners (or service dials) and their dials, and the control schedule.

One general generator reads every traffic file.  A seed changes which
station a listener hears, which listener retunes or leaves and where each
station sits; never how many listeners, stations or control changes there
are, nor when a change is due.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

IF_RATE = {"usb": 12000.0, "lsb": 12000.0, "cw": 12000.0, "am": 12000.0,
           "nfm": 48000.0}
PASSBAND = {"usb": (300.0, 3000.0), "lsb": (-3000.0, -300.0),
            "am": (-4000.0, 4000.0), "nfm": (-4000.0, 4000.0)}
BUCKET = {"usb": "ssb", "lsb": "ssb", "cw": "ssb", "am": "am", "nfm": "nfm"}
# an edge drag's dial lies this far inside its channel's upper edge
EDGE_INSIDE_HZ = 200.0


def filterbank_channels(fs: float, mode: str) -> int:
    """Channels of the filterbank that serves ``mode`` at ``fs``: the
    largest power of two keeping a channel ≥ 24 kHz wide, halved until the
    channel rate reaches the mode's demodulator rate."""
    m = min(4096, 2 ** int(math.log2(fs / 24000)))
    while m >= 8 and fs / m < IF_RATE[mode]:
        m //= 2
    return m


def channel_center(k: int, m: int, fs: float) -> float:
    f = k * fs / m
    return f - fs if f >= fs / 2 else f


def channel_of(hz: float, m: int, fs: float) -> tuple[int, float]:
    """The filterbank channel a dial falls in and its offset from that
    channel's centre."""
    k = int(round(hz * m / fs)) % m
    return k, hz - channel_center(k, m, fs)


@dataclass
class Event:
    at: float                    # seconds after the window opens
    kind: str                    # "retune" | "swap" | "drag" | "return"
    listener: int
    station: int
    mode: str = ""
    new_listener: int = -1
    hz: float | None = None      # a dial off the stations (an edge drag)


@dataclass
class Plan:
    fs: float
    loop_len: int
    stations: list = field(default_factory=list)     # dicts: hz, mode, ...
    listeners: dict = field(default_factory=dict)    # id → (mode, station)
    warm_events: list = field(default_factory=list)
    events: list = field(default_factory=list)
    waterfall: bool = False      # every listener also takes the waterfall
    service: bool = False        # raw-audio service dials, not listeners

    def dial(self, station: int) -> float:
        return self.stations[station]["hz"]

    def by_mode(self, mode: str) -> list[int]:
        return [i for i, s in enumerate(self.stations) if s["mode"] == mode]


def make_plan(config: dict, traffic: dict, block: int, seed: int,
              seconds: float) -> Plan:
    fs = float(config["sample_rate"])
    s64 = int(seed) % (1 << 64)
    rng = np.random.default_rng([s64 & 0xFFFFFFFF, s64 >> 32, 17])
    loop_len = int(traffic["loop_blocks"]) * block
    grid = fs / loop_len
    st = traffic["stations"]
    step = float(st.get("step_hz", 5.0))
    if abs(step / grid - round(step / grid)) > 1e-9:
        raise ValueError(f"station step {step} Hz is off the loop's {grid} Hz grid")
    plan = Plan(fs=fs, loop_len=loop_len,
                waterfall=bool(traffic.get("waterfall")),
                service=bool(traffic.get("service")))
    counts = {mode: int(n) for mode, n in st["per_mode"].items()}
    # one station a cell of the coarsest grid among the modes, skipping
    # the cell at 0 Hz and the one at ±fs/2
    cells_m = min(filterbank_channels(fs, mode) for mode in counts)
    total = sum(counts.values())
    if st.get("every_channel"):
        cells = list(range(cells_m))
    else:
        free = [k for k in range(1, cells_m) if k != cells_m // 2]
        if total > len(free):
            raise ValueError(f"{total} stations for {len(free)} channels")
        cells = list(rng.permutation(free)[:total])
    modes = [mode for mode, n in counts.items() for _ in range(n)]
    fine_max = float(st["fine_hz"])
    for mode, cell in zip(modes, cells):
        tones = st.get(f"tone_hz_{mode}", st["tone_hz"])
        fine = step * int(rng.integers(-int(fine_max / step), int(fine_max / step) + 1))
        tone = step * int(rng.integers(int(tones[0] / step), int(tones[1] / step) + 1))
        plan.stations.append({
            "hz": channel_center(int(cell), cells_m, fs) + fine, "mode": mode,
            "lsb": float(st["lsb"]), "tone_hz": tone,
            "depth": float(st.get("am_depth", 0.5)),
            "deviation_hz": float(st.get("nfm_deviation_hz", 2500.0))})
    nid = 0
    for group in traffic["listeners"]:
        mode = group["mode"]
        own = plan.by_mode(mode)
        for i in range(int(group["count"])):
            plan.listeners[nid] = (mode, own[i % len(own)])
            nid += 1
    control = traffic.get("control", {})
    live = {i: m for i, (m, _) in plan.listeners.items()}
    where = {i: st for i, (_, st) in plan.listeners.items()}
    joins = list(control.get("join_modes", ["usb", "am", "nfm"]))
    m_ssb = filterbank_channels(fs, "usb")
    dragged: list[int] = []              # listeners at an edge dial, oldest first
    n_swap = 0

    def event(at, kind):
        nonlocal nid, n_swap
        free = sorted(set(live) - set(dragged))
        if kind == "retune":
            who = int(rng.choice(free))
            where[who] = int(rng.choice(plan.by_mode(live[who])))
            return Event(at, "retune", who, where[who])
        if kind == "swap":
            mode = joins[n_swap % len(joins)]
            n_swap += 1
            who = int(rng.choice([i for i in free if live[i] == mode]))
            del live[who]
            live[nid], where[nid] = mode, int(rng.choice(plan.by_mode(mode)))
            nid += 1
            return Event(at, "swap", who, where[nid - 1], mode, nid - 1)
        if kind == "drag":
            # just inside the edge of the channel its station is in, so the
            # passband crosses into the next: served full rate
            who = int(rng.choice([i for i in free if BUCKET[live[i]] == "ssb"]))
            dragged.append(who)
            k, _ = channel_of(plan.dial(where[who]), m_ssb, fs)
            edge = channel_center(k, m_ssb, fs) + 0.5 * fs / m_ssb - EDGE_INSIDE_HZ
            return Event(at, "drag", who, where[who], hz=edge)
        who = dragged.pop(0)                      # back to its station
        return Event(at, "return", who, where[who])

    def times(rate, phase, horizon):
        return [(i + phase) / rate for i in range(int(rate * horizon))] if rate else []

    rr = float(control.get("retunes_per_s", 0.0))
    rs = float(control.get("join_leave_per_s", 0.0))
    rd = float(control.get("edge_drags_per_s", 0.0))
    hold = float(control.get("drag_hold_s", 0.2))
    warm = traffic.get("warm", {})
    for i in range(max([int(warm.get(k, 0)) for k in ("retunes", "swaps", "drags")] + [0])):
        for kind, n in (("swap", "swaps"), ("retune", "retunes"), ("drag", "drags"),
                        ("return", "drags")):
            if i < int(warm.get(n, 0)):
                plan.warm_events.append(event(0.0, kind))
    order = {"return": 0, "swap": 1, "drag": 2, "retune": 3}
    due = [(t, "retune") for t in times(rr, float(control.get("retune_phase", 0.5)), seconds)]
    due += [(t, "swap") for t in times(rs, float(control.get("join_leave_phase", 0.25)),
                                        seconds)]
    for t in times(rd, float(control.get("edge_drag_phase", 0.35)), seconds):
        due += [(t, "drag"), (t + hold, "return")]
    plan.events = [event(t, kind) for t, kind in sorted(due, key=lambda e: (e[0], order[e[1]]))]
    return plan
