"""``correct``: the numbers the comparison gives and the limits they are
held to (PERF.md gives the readings each limit was set from)."""

from __future__ import annotations

import time

import numpy as np

from pbench.ref import ima
from pbench.ref.dsp import Precision
from pbench.ref.replay import (History, Observed, bank_mode, replay_bank,
                               waterfall_gaps)

# name → limit; a run is correct when every number is at or under its limit
LIMITS = {
    "missing": 0,
    "misrouted": 0,
    "audio_wrong_per_block": 64,
    "waterfall_gap": 4.0,
    "no_audio_compared": 0,
}


def sample_slots(rec, seed: int, per_bank: int) -> dict:
    """Per filterbank bank key the slots to check: the one held by most
    listeners, then others drawn from the seed.  The full-rate banks
    (an edge drag's) have no reference yet: ``full_rate_blocks`` counts
    what they delivered unjudged; nor have slots that a join, leave or
    drag reached during a dispatch (``unresolved``)."""
    held: dict = {}
    _, unjudged = unresolved(rec)
    for b, routing in rec.routing.items():
        for hid, (key, slot) in routing.items():
            if (slot is not None and key.startswith(("pfb:", "pfbi:"))
                    and (key, slot) not in unjudged):
                held.setdefault(key, {}).setdefault(slot, set()).add(hid)
    s64 = int(seed) % (1 << 64)
    rng = np.random.default_rng([s64 & 0xFFFFFFFF, s64 >> 32, 23])
    out = {}
    for key, slots in sorted(held.items()):
        order = sorted(slots)
        first = max(order, key=lambda s: (len(slots[s]), -s))
        rest = [s for s in order if s != first]
        pick = [first] + list(rng.permutation(rest)[:max(0, per_bank - 1)])
        out[key] = sorted(int(s) for s in pick)
    return out


def unresolved(rec):
    """What a change that moves a listener between slots (a join or leave,
    an edge drag or its return, a retune in a bank whose slot is its
    channel), made during a dispatch, leaves open: whether that block's
    banks, and the runtime's list of listeners, had it yet.  →
    ({(listener, block)} whose delivery may or may not be due, {(bank key,
    slot)} whose history is not judged)."""
    pairs, slots = set(), set()
    for c in rec.control:
        if len(c["firsts"]) < 2:
            continue
        lo, hi = min(c["firsts"]), max(c["firsts"])
        held = {rec.routing[b][c["listener"]] for b in range(lo - 1, hi + 1)
                if c["listener"] in rec.routing.get(b, {})}
        if c["kind"] == "retune" and len(held) < 2:
            continue                       # stayed on its slot: ``History`` resolves it
        for hid in (c["listener"], c["left"]):
            for b in range(lo - 1, hi + 1):
                pairs.add((hid, b))
                held = rec.routing.get(b, {}).get(hid)
                if held is not None and held[1] is not None:
                    slots.add(held)
    return pairs, slots


def misrouted(rec) -> int:
    """Listeners routed to a slot that another listener held in the same
    block, over every block and bank."""
    n = 0
    for routing in rec.routing.values():
        held = [where for where in routing.values() if where[1] is not None]
        n += len(held) - len(set(held))
    return n


def delivery_faults(rec, deliveries, first_block: int = 0) -> int:
    """(listener, block) audio results due and never delivered, or
    delivered out of order, from ``first_block`` on."""
    missing = 0
    open_pairs, _ = unresolved(rec)
    for b in sorted(rec.routing):
        if b < first_block or b not in rec.complete:
            continue
        for hid, (key, slot) in rec.routing[b].items():
            if slot is None or key not in rec.active[b] or (hid, b) in open_pairs:
                continue
            if b not in deliveries.get(hid, {}):
                missing += 1
    for hid, per in deliveries.items():
        blocks = [b for b, _ in sorted(per.items(), key=lambda kv: kv[1][0])]
        missing += sum(1 for a, b in zip(blocks, blocks[1:]) if b < a)
    return missing


def program_cells(rec, deliveries, slots: dict) -> Observed:
    """The program's audio cells for the sampled slots (all decoded at
    once)."""
    obs = Observed()
    framed = []                               # (key, slot, b, states, nibbles)
    for key, chosen in slots.items():
        _, interactive = bank_mode(key)
        chosen = set(chosen)
        for b, routing in rec.routing.items():
            for hid, (k, slot) in routing.items():
                if k != key or slot not in chosen:
                    continue
                got = deliveries.get(hid, {}).get(b)
                if got is None or not isinstance(got[1], (bytes, bytearray)):
                    continue
                if not interactive:
                    s = np.frombuffer(bytes(got[1]), "<i2").astype(np.int64)
                    obs.put(key, slot, b, s, s)
                    continue
                try:
                    states, nib = ima.split_frames(bytes(got[1]))
                except ValueError:                 # an unreadable frame
                    obs.put(key, slot, b, np.full(1, 1 << 40), np.full(1, 1 << 40))
                    continue
                framed.append((key, slot, b, states, nib))
    if framed:
        lo, hi, ok = ima.cells(np.concatenate([f[3] for f in framed]),
                               np.concatenate([f[4] for f in framed]))
        at = 0
        for key, slot, b, states, _ in framed:
            n = len(states)
            sel = ok[at:at + n]
            obs.put(key, slot, b, lo[at:at + n][sel], hi[at:at + n][sel])
            at += n
    return obs


class ControlProgram:
    """The reference in bfloat16 put in the program's place: its audio,
    truncated to int16 and (for listeners) IMA-encoded in 200-sample
    segments, each from the state the one before left, as the program
    frames it."""

    def __init__(self):
        self.obs = Observed()
        self.audio: dict = {}                 # (hist, row) → [(b, samples)]

    def emit(self, hist, i, b, audio):
        s = np.trunc(np.clip(audio, -32768, 32767)).astype(np.int64)
        if not hist.interactive:
            self.obs.put(hist.key, hist.slots[i], b, s, s)
            return
        self.audio.setdefault((id(hist), hist.key, hist.slots[i]), []).append((b, s))

    def finish(self):
        """Encode every slot's stream, all slots at once."""
        keys = list(self.audio)
        if not keys:
            return
        blocks = [[b for b, _ in self.audio[k]] for k in keys]
        n = min(len(bl) for bl in blocks)
        x = np.stack([np.concatenate([s for _, s in self.audio[k][:n]]) for k in keys])
        seg = 200
        nib, states = np.empty_like(x), []
        state = np.zeros((len(keys), 2), np.int64)
        for a in range(0, x.shape[1], seg):
            states.append(state.copy())
            nib[:, a:a + seg], state = ima.encode(x[:, a:a + seg], state)
        states = np.stack(states, 1)                      # (K, segments, 2)
        k_, g_ = states.shape[:2]
        lo, hi, _ = ima.cells(states.reshape(-1, 2), nib.reshape(k_ * g_, seg))
        lo, hi = lo.reshape(k_, -1), hi.reshape(k_, -1)
        per = x.shape[1] // n
        for r, (_, key, slot) in enumerate(keys):
            for j in range(n):
                self.obs.put(key, slot, blocks[r][j], lo[r, j * per:(j + 1) * per],
                             hi[r, j * per:(j + 1) * per])
        self.audio.clear()


def control_rows(rec, wire, handed, block, fs, size, fps, device):
    """The waterfall rows the bfloat16 reference would send, per block
    (every row IMA-encoded from a fresh codec, all rows at once)."""
    from pbench.ref.dsp import WaterfallRef, wire_to_complex
    ref = WaterfallRef(size, fps, fs, block, device, Precision(low=True))
    order, rows = [], []
    for b in sorted(rec.waterfall_ran):
        if not rec.waterfall_ran[b]:
            continue
        x = wire_to_complex(wire[handed[b] * block:(handed[b] + 1) * block], device)
        db = ref.block(ref.p.r(x)).cpu().numpy() * 100.0
        for r in range(db.shape[0]):
            order.append(b)
            rows.append(np.concatenate([np.full(10, db[r, 0]), db[r]]))
    out: dict = {}
    if not rows:
        return out
    s = np.trunc(np.clip(np.stack(rows), -32768, 32767)).astype(np.int64)
    nib, _ = ima.encode(s)
    if nib.shape[1] % 2:
        nib = np.concatenate([nib, np.zeros((len(nib), 1), np.int64)], 1)
    packed = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
    for b, row in zip(order, packed):
        out.setdefault(b, []).append(row.tobytes())
    return out


def judge(cfg, traffic, drv, wire, deliveries, seed: int, device,
          control: bool = False) -> dict:
    """The run's numbers.  With ``control`` the bfloat16 reference's output
    is judged in place of the program's (the program's record still gives
    the routing, blocks and dials)."""
    rec = drv.rec
    fs = float(cfg["sample_rate"])
    block = drv.block
    handed = [h[0] for h in drv.source.handed]
    check = traffic.get("check", {})
    slots = sample_slots(rec, seed, int(check.get("slots_per_bank", 8)))
    first = drv.first_window_block
    numbers = {"missing": delivery_faults(rec, deliveries, first), "misrouted": misrouted(rec)}
    ctl = ControlProgram() if control else None
    obs = None if control else program_cells(rec, deliveries, slots)
    worst, bad, n, forks, wrong, capped = 0.0, 0, 0, 0, 0, 0
    spent = {}
    for key, chosen in slots.items():
        t = time.perf_counter()
        hist = History(key, fs, block, rec, drv.dials, chosen, variants=not control)
        capped += hist.capped
        seg = int(check.get("segment_blocks", 8))
        if control:
            replay_bank(hist, wire, handed, block, None, Precision(low=True), device,
                        seg, emit=ctl.emit)
            ctl.finish()
        res, nf = replay_bank(hist, wire, handed, block, ctl.obs if control else obs,
                              Precision(), device, seg, report_from=first)
        forks += nf
        spent[key] = time.perf_counter() - t
        for st in res.values():
            worst = max(worst, st[0])
            bad += st[1]
            n += st[2]
            wrong = max(wrong, st[3])
    numbers["audio_wrong_per_block"] = wrong
    numbers["no_audio_compared"] = int(n == 0)
    full_rate = sum(1 for b, routing in rec.routing.items() if b >= first
                    for key, slot in routing.values()
                    if slot is not None and not key.startswith(("pfb:", "pfbi:")))
    info = {"full_rate_blocks": full_rate, "slots_unjudged": len(unresolved(rec)[1]),"audio_gap_lsb": worst, "audio_samples": n, "audio_over_1lsb": bad,
            "forks": forks, "variants_capped": capped,
            "slots_checked": sum(len(v) for v in slots.values()), "replay_s": spent}
    if drv.waterfall:
        s = cfg["settings"]
        size, fps = int(s.get("fft_size", 4096)), float(s.get("fft_fps", 9))
        rows_of = None
        if control:
            ctl_rows = control_rows(rec, wire, handed, block, fs, size, fps, device)
            rows_of = ctl_rows.get
        ran = sorted(b for b, r in rec.waterfall_ran.items() if r and b >= first
                     and rec.waterfall_ran.get(b - 1))
        n_wf = int(check.get("waterfall_blocks", len(ran)))
        s64 = int(seed) % (1 << 64)
        pick = set(np.random.default_rng([s64 & 0xFFFFFFFF, s64 >> 32, 31])
                   .permutation(ran)[:n_wf].tolist())
        w, wb, wn, wmiss = waterfall_gaps(rec, wire, handed, block, fs, size, fps,
                                          device, Precision(), rows_of, first, pick)
        numbers["waterfall_gap"] = w
        numbers["missing"] += wmiss
        info.update(waterfall_samples=wn, waterfall_over_1=wb)
    return numbers, info


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in numbers)
