"""The comparison that decides ``correct``: the run's record against the
plain reference.

What the window produced is judged as it was delivered: every listener's
audio wire (ADPCM frames, or raw int16 for service dials) for every block
it was routed at, and every waterfall row.  For a sample of filterbank
slots, drawn from the seed, the reference works out each slot's audio
again over its whole history (every block its bank ran, the dial of
whichever listener held it, the parked channel 0 when none did) from the
wire bytes the source handed over; and the waterfall of every block.

What ``replay_bank`` gives per slot: the widest distance, in int16
steps, between a reference audio sample and the interval of encoder
inputs that gives the program's output there (``ima.cells``,
``ima.truncation_gap``), the samples over one step, the samples checked,
and the most samples over ``WRONG`` in one block (``check.LIMITS`` holds
the last); ``waterfall_gaps`` the same for the waterfall rows, in 0.01 dB
steps.
"""

from __future__ import annotations

import numpy as np
import torch

from pbench.plan import PASSBAND, channel_of, filterbank_channels
from pbench.ref import ima
from pbench.ref.dsp import (BackRef, ChannelPlan, FrontRef, PfbRef, Precision,
                            WaterfallRef, wire_to_complex)

CHAIN_MODE = {"ssb": "usb", "am": "am", "nfm": "nfm"}
BAD_GAP = 1.0          # a sample this far outside its cell counts against a candidate
WRONG = 64.0           # a sample this far outside its cell (int16 steps) is wrong
# AGC decisions closer than this (relative) fork: float32 rounding in the
# program can take them either way
TIE = 2e-4
# NFM phase steps this close to ±π (relative to the row's scale) fork
FM_TIE = 1e-4
# at most this many histories a slot when control changes landed in one
# of two blocks (``History``); a slot that would need more is not judged
MAX_VARIANTS = 16


class Observed:
    """What the program (or the control, in its place) delivered: per
    (bank key, slot, block) the integer cells of the audio samples."""

    def __init__(self):
        self.cells: dict = {}

    def put(self, key, slot, block, lo, hi):
        self.cells[(key, slot, block)] = (lo, hi)

    def get(self, key, slot, block):
        return self.cells.get((key, slot, block))


def bank_mode(key: str) -> tuple[str, bool]:
    """'pfbi:ssb' → ('usb', interactive)."""
    prefix, _, bucket = key.partition(":")
    if prefix not in ("pfb", "pfbi"):
        raise KeyError(f"bank {key}: the reference covers the filterbank banks only")
    return CHAIN_MODE[bucket], prefix == "pfbi"


class History:
    """A bank's blocks and, per sampled slot, the dial it served at each.

    A control change made while a block was being dispatched may have
    reached that block or only the next (``drive.Driver.resolve``); a
    slot whose history holds such changes gets one row for each way they
    can have landed (a slot that would need more than ``MAX_VARIANTS`` is
    left out and counted in ``capped``), and the output decides between
    them.  ``slots`` gives each row's slot."""

    def __init__(self, key, fs, block, rec, dials, slots, variants: bool = True):
        self.key, self.fs = key, fs
        self.mode, self.interactive = bank_mode(key)
        self.m = filterbank_channels(fs, self.mode)
        self.blocks = [b for b in sorted(rec.active) if key in rec.active[b]]
        lo, hi = PASSBAND[self.mode]
        self.capped = 0
        self.diverge = {}                        # slot → its first ambiguous block
        holders = {s: [] for s in slots}        # slot → [(block index, hid)]
        for j, b in enumerate(self.blocks):
            for hid, (k, slot) in rec.routing[b].items():
                if k == key and slot in holders:
                    holders[slot].append((j, hid))
        rows = []                                # (slot, {change id: first block})
        for s in slots:
            amb = {}
            for j, hid in holders[s]:
                for cid, firsts, _ in dials[hid]:
                    if len(firsts) > 1 and min(firsts) <= self.blocks[j] < max(firsts):
                        amb[cid] = firsts
            combos = [{}]
            if variants:
                for cid, firsts in sorted(amb.items()):
                    combos = [{**c, cid: f} for c in combos for f in firsts]
                if len(combos) > MAX_VARIANTS:       # left unjudged
                    self.capped += 1
                    combos = []
            rows += [(s, c) for c in combos]
            if len(combos) > 1:
                self.diverge[s] = min(min(f) for f in amb.values())
        self.slots = [s for s, _ in rows]
        nb = len(self.blocks)
        self.chan = np.zeros((len(rows), nb), np.int64)
        self.fine = np.zeros((len(rows), nb))
        self.low = np.full((len(rows), nb), lo)
        self.high = np.full((len(rows), nb), hi)
        self.level = np.full((len(rows), nb), -150.0)
        for i, (s, choice) in enumerate(rows):
            for j, hid in holders[s]:
                hz = dial_at(dials[hid], self.blocks[j], choice)
                self.chan[i, j], self.fine[i, j] = channel_of(hz, self.m, fs)


def dial_at(changes, block, choice=None):
    """The dial a listener's ``changes`` [(change id, the blocks it may
    first have reached, hz)] set at ``block``; an ambiguous change counts
    from ``choice``'s block for it, else from the last it may have."""
    hz = changes[0][2]                 # a joiner's dial, should its open land late
    for cid, firsts, f in changes:
        first = (choice or {}).get(cid, firsts[-1])
        if first <= block:
            hz = f
    return hz


def replay_bank(hist: History, wire, handed, block, observed: Observed,
                precision: Precision, device, segment: int, emit=None,
                report_from: int = 0):
    """Run the reference over a bank's history for its sampled slots.
    With ``observed`` (the program's cells) return per slot (max gap,
    samples over BAD_GAP, samples checked, the most samples over WRONG in
    one block) over the blocks from
    ``report_from`` on (every observed block decides between AGC
    candidates); with ``emit`` (the control) hand each block's audio to it
    instead."""
    fs = hist.fs
    plan = ChannelPlan(hist.mode, fs / hist.m, block // hist.m)
    rows = len(hist.slots)
    if not rows:                     # every sampled slot left unjudged
        return {}, 0
    pfb = PfbRef(hist.m, 16, device, precision)
    front = FrontRef(plan, rows, device, precision)
    back = BackRef(plan, rows, device, precision, tie=0.0 if emit else TIE)
    front.fm_tie = 0.0 if emit else FM_TIE
    slot_of = np.asarray(hist.slots)
    # candidate id → [max gap, bad, n] over the reported blocks, [bad,
    # summed gap] over every observed block (which decide between AGC
    # candidates), the most samples over WRONG in one reported block, and
    # the samples over WRONG from the slot's first ambiguous block on
    # (which decide between the ways control changes landed)
    stats = {}
    cand_ids = np.arange(rows)
    next_id = rows
    chan_t = torch.as_tensor(hist.chan, device=device)
    nb = len(hist.blocks)
    ab = plan.audio_block
    for a in range(0, nb, segment):
        js = list(range(a, min(nb, a + segment)))
        xs = []
        for j in js:
            b = hist.blocks[j]
            x = wire_to_complex(wire[handed[b] * block:(handed[b] + 1) * block], device)
            ch = pfb.block(precision.r(x))                       # (M, cb)
            xs.append(ch[chan_t[:, j]])
        x = torch.cat(xs, -1)
        y = front(x, hist.fine[:, js], hist.low[:, js], hist.high[:, js],
                  hist.level[:, js])
        back.fork_src = []
        audio = back(back.fork_inputs(y, front.fm_forks))
        # candidates forked in this segment get ids (and the record so far)
        # of their own
        for src in back.fork_src:
            stats[next_id] = list(stats.get(cand_ids[src], _NEW))
            cand_ids = np.append(cand_ids, next_id)
            next_id += 1
        au = audio.cpu().numpy()
        if emit is not None:
            for jj, j in enumerate(js):
                for i in range(rows):
                    emit(hist, i, hist.blocks[j], au[i, jj * ab:(jj + 1) * ab])
            continue
        for c in range(len(cand_ids)):
            i = back.origin[c]
            st = stats.setdefault(cand_ids[c], list(_NEW))
            for jj, j in enumerate(js):
                obs = observed.get(hist.key, hist.slots[i], hist.blocks[j])
                if obs is None:
                    continue
                gap = ima.truncation_gap(au[c, jj * ab:(jj + 1) * ab], *obs)
                bad = int((gap > BAD_GAP).sum())
                st[3] += bad
                st[4] += float(gap.sum())
                if hist.blocks[j] >= hist.diverge.get(hist.slots[i], np.inf):
                    st[6] += int((gap > WRONG).sum())
                if hist.blocks[j] >= report_from:
                    st[0] = max(st[0], float(gap.max()))
                    st[1] += bad
                    st[2] += gap.size
                    st[5] = max(st[5], int((gap > WRONG).sum()))
        keep = sorted(c for s_ in dict.fromkeys(hist.slots)
                      for c in _fittest(np.flatnonzero(slot_of[back.origin] == s_),
                                        back.origin, cand_ids, stats))
        if len(keep) < len(back.origin):
            back.keep(keep)
            cand_ids = cand_ids[keep]
    out = {}
    for s_ in dict.fromkeys(hist.slots):
        mine = [stats.get(cand_ids[c], _NEW)
                for c in _fittest(np.flatnonzero(slot_of[back.origin] == s_),
                                  back.origin, cand_ids, stats)]
        best = min(mine, key=lambda s: (s[3], s[4]))
        out[s_] = best[:3] + best[5:6]
    return out, back.forks


_NEW = [0.0, 0, 0, 0, 0.0, 0, 0]


def _fittest(cands, origin, cand_ids, stats):
    """Of one slot's candidates, those that fit the program's output best.
    First the rows (the ways its ambiguous control changes can have
    landed) whose best candidate has the fewest wrong samples (over
    ``WRONG``) from the slot's first ambiguous block on: rows that agree
    on a block differ there only by rounding, which the stream's first
    block can blow up but never to a wrong sample.  Then in each row the
    candidates with the fewest samples outside their cells over every
    observed block, then the least summed distance.  Candidates the
    output cannot tell apart yet all stay, up to 4 a row."""
    if len(cands) < 2:
        return list(cands)
    st = {c: stats.get(cand_ids[c], _NEW) for c in cands}
    rows = {}
    for c in cands:
        rows.setdefault(int(origin[c]), []).append(c)
    if len(rows) > 1:
        post = {r: min(st[c][6] for c in cs) for r, cs in rows.items()}
        rows = {r: cs for r, cs in rows.items() if post[r] == min(post.values())}
    out = []
    for cs in rows.values():
        best = min((st[c][3], st[c][4]) for c in cs)
        out += [c for c in cs if st[c][3] == best[0] and st[c][4] <= best[1] + 1e-6][:4]
    return out


def waterfall_gaps(rec, wire, handed, block, fs, size, fps, device, precision,
                   rows_of=None, report_from: int = 0, sample=None):
    """Reference rows of the blocks the waterfall ran → (max gap, samples
    over BAD_GAP, samples checked, missing rows), every delivered row
    decoded at once.  A block's rows depend only on it and the ``size``
    samples before it, so ``sample`` (a set of blocks) may pick which are
    worked out; every block's rows are counted.  With ``rows_of`` (the
    control) its rows stand in for the program's."""
    ref = WaterfallRef(size, fps, fs, block, device, precision)
    pad = 10
    values, nibbles, missing = [], [], 0
    for b in sorted(rec.waterfall_ran):
        if not rec.waterfall_ran[b] or b < report_from:
            continue
        payloads = rec.rows.get(b, []) if rows_of is None else (rows_of(b) or [])
        if len(payloads) != ref.rows:
            missing += abs(ref.rows - len(payloads))
            continue
        if sample is not None and b not in sample:
            continue
        # the waterfall's history is the end of the block before
        prev = wire[handed[b - 1] * block:(handed[b - 1] + 1) * block][-size:] if b else None
        ref.hist = (wire_to_complex(prev, device) if prev is not None else
                    torch.zeros(size, dtype=torch.complex128, device=device))
        x = wire_to_complex(wire[handed[b] * block:(handed[b] + 1) * block], device)
        db = ref.block(x).cpu().numpy() * 100.0
        for r, payload in enumerate(payloads):
            nibbles.append(ima.row_nibbles(payload)[:size + pad])
            values.append(np.concatenate([np.full(pad, db[r, 0]), db[r]]))
    if not values:
        return 0.0, 0, 0, missing
    nib = np.stack(nibbles)
    lo, hi, _ = ima.cells(np.zeros((len(nib), 2), np.int64), nib)
    gap = ima.truncation_gap(np.stack(values), lo, hi)
    return float(gap.max()), int((gap > BAD_GAP).sum()), gap.size, missing
