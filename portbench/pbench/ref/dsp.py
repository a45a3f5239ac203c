"""Plain reference of the receive chains the benchmark's cells run.

Written from the published design of an OpenWebRX receive chain
(polyphase filterbank front end, then per channel: NCO shift, FIR
decimation, rational resampling, FFT bandpass, power squelch, the analog
demodulator, AGC, client-audio rate conversion, spectral NR, limiter) and
of its waterfall (Hann-windowed FFT frames, averaged power in dB,
fftshift).  Every filter is designed here again from its formula, in
float64, and the chain runs over a slot's history in segments of blocks,
each stage carrying its own history from one segment to the next.
Nothing here imports the program.

The reference computes in float64.  The control runs the same code with
every stage's output and every filter's taps rounded to bfloat16
(``Precision``), the precision step below the float32 the configuration
states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

SHORT_SCALE = 32767.0


# ------------------------------------------------------------- precision --
class Precision:
    """float64 reference, or the bfloat16 control (``low``): values are
    rounded to bfloat16 after every stage; arithmetic stays in float64."""

    def __init__(self, low: bool = False):
        self.low = bool(low)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).to(torch.float64),
                                 x.imag.to(torch.bfloat16).to(torch.float64))
        return x.to(torch.bfloat16).to(x.dtype)

    def taps(self, h: np.ndarray) -> np.ndarray:
        if not self.low:
            return h
        t = torch.as_tensor(h)
        return self.r(t.to(torch.complex128 if t.is_complex() else torch.float64)
                      ).numpy()


# ---------------------------------------------------------------- design --
def odd(n: int) -> int:
    return n | 1


def lowpass(cutoff: float, transition: float) -> np.ndarray:
    """Windowed-sinc (Hamming) lowpass, unity DC gain, about
    4/transition taps (odd, at least 9)."""
    ntaps = odd(max(9, int(np.ceil(4.0 / transition))))
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return h / h.sum()


def bandpass(low: float, high: float, transition: float) -> np.ndarray:
    """Complex bandpass: the lowpass of half the band's width moved to its
    centre (cycles/sample)."""
    ntaps = odd(max(9, int(np.ceil(4.0 / transition))))
    n = np.arange(ntaps) - (ntaps - 1) / 2
    cut = max((high - low) / 2, transition / 2 + 1e-6)
    h = 2 * cut * np.sinc(2 * cut * n) * np.hamming(ntaps)
    h /= h.sum()
    return h * np.exp(2j * np.pi * (high + low) / 2 * n)


def pfb_prototype(m: int, taps_per_phase: int) -> np.ndarray:
    n = m * taps_per_phase
    c = 0.5 / m
    h = np.sinc(2 * c * (np.arange(n) - (n - 1) / 2)) * 2 * c * np.hamming(n)
    return h / h.sum()


def best_chunk(block: int, target: int) -> int:
    """The divisor of ``block`` closest to ``target`` on a log scale."""
    divs = [d for d in range(1, int(math.isqrt(block)) + 1) if block % d == 0]
    divs += [block // d for d in divs]
    return min(divs, key=lambda v: abs(math.log(v / max(1, target))))


def split_ratio(in_rate: float, out_rate: float) -> tuple[int, Fraction]:
    """out/in = L/M in lowest terms → (integer decimation M//q, L/q) with q
    the least divisor of M not below L."""
    total = (Fraction(out_rate).limit_denominator(10 ** 6)
             / Fraction(in_rate).limit_denominator(10 ** 6))
    L, M = total.numerator, total.denominator
    q = min(d for d in range(1, M + 1) if M % d == 0 and d >= L)
    return M // q, Fraction(L, q)


def rational_taps(L: int, M: int) -> np.ndarray:
    cut = 0.45 / max(L, M)
    return lowpass(cut, cut * 0.3) * L


def rational_alignment(ntaps: int, L: int, M: int) -> int:
    """Input samples of history ahead of the stream so that output j·L + r
    is y[j·L + r] = Σ_k h[k]·u[(j·L + r)·M − k] on the stream's own grid:
    the zero history a streaming resampler starts from."""
    lo = min(-((k - r * M) // L) for r in range(L) for k in range(ntaps)
             if (r * M - k) % L == 0)
    hi = max((r * M - k) // L for r in range(L) for k in range(ntaps)
             if (r * M - k) % L == 0)
    p = hi - lo + 1
    if p < M:
        lo -= M - p
        p = M
    t = p - M
    while (t + lo) % M:
        t += 1
    return t, lo, p


def fixed_rate(rate: float) -> int:
    """Normalised rate → its 32-bit fixed-point phase increment."""
    return int(np.int64(np.round(np.mod(np.float64(rate), 1.0) * 2.0 ** 32))
               & 0xFFFFFFFF)


AGC_SLOW = (0.7, 0.002, 30)          # attack, decay a chunk, hang chunks
AGC_FAST = (0.9, 0.01, 8)
AGC_REFERENCE, AGC_MAX_GAIN, AGC_CHUNK = 0.8, 65536.0, 50
NFM_TAU = 150e-6


# ------------------------------------------------------------ the chains --
@dataclass
class ChannelPlan:
    """One mode's chain at a filterbank's channel rate."""
    mode: str
    fc: float                 # channel rate
    channel_block: int        # channel samples a device block
    audio_rate: float = 12000.0

    def __post_init__(self):
        demod_if = 48000.0 if self.mode == "nfm" else self.audio_rate
        self.if_rate = max(demod_if, self.audio_rate)
        self.dec, frac = split_ratio(self.fc, self.if_rate)
        self.L, self.M = frac.numerator, frac.denominator
        n = self.channel_block
        self.fir = None
        if self.dec > 1:
            self.fir = lowpass(0.5 * self.if_rate / self.fc,
                               0.15 * self.if_rate / self.fc)
            n //= self.dec
        self.rat = None
        if (self.L, self.M) != (1, 1):
            self.rat = rational_taps(self.L, self.M)
            n = n * self.L // self.M
        self.if_block = n
        self.bp_transition = 320.0 / self.if_rate
        self.bp_ntaps = odd(max(9, int(np.ceil(4.0 / self.bp_transition))))
        self.sq_window = best_chunk(n, int(round(self.if_rate / 16)))
        self.agc = AGC_FAST if self.mode == "nfm" else AGC_SLOW
        self.agc_chunk = best_chunk(n, AGC_CHUNK)
        self.audio_dec = int(round(self.if_rate / self.audio_rate))
        self.audio_fir = None
        if self.audio_dec > 1:
            tb = 0.15 / self.audio_dec
            self.audio_fir = lowpass(0.5 / self.audio_dec - tb / 2, tb)
        self.audio_block = n // self.audio_dec
        self.nr_hop = best_chunk(self.audio_block, 250)


def _fir(tail: torch.Tensor, x: torch.Tensor, h: torch.Tensor, stride: int = 1):
    """Causal FIR with carried input history: y[j] = Σ_i h[i]·x[j·stride − i]
    over the stream, ``tail`` its last T−1 samples before ``x`` →
    (new tail, y (R, N // stride))."""
    t = h.shape[-1]
    xe = torch.cat([tail, x], -1)
    size = 1 << int(math.ceil(math.log2(xe.shape[-1] + t - 1)))
    if xe.is_complex() or h.is_complex():
        y = torch.fft.ifft(torch.fft.fft(xe, size) * torch.fft.fft(h, size))
    else:
        y = torch.fft.irfft(torch.fft.rfft(xe, size) * torch.fft.rfft(h, size), size)
    y = y[..., t - 1: t - 1 + x.shape[-1]][..., ::stride]
    return xe[..., xe.shape[-1] - (t - 1):], y


def _rational_bank(taps: np.ndarray, L: int, M: int):
    """bank (L, p) with y[j·L + r] = Σ_c bank[r, c]·xe[j·M + c], where xe
    is the stream behind ``t`` samples of history, and ``t``."""
    t, lo, p = rational_alignment(len(taps), L, M)
    bank = np.zeros((L, p))
    for r in range(L):
        for c in range(p):
            k = r * M - L * (c + lo)
            if 0 <= k < len(taps):
                bank[r, c] = taps[k]
    return bank, t


def _iir1(state, x: torch.Tensor, b0: float, b1: float, a1: float):
    """y[n] = a1·y[n−1] + b0·x[n] + b1·x[n−1]; state (x_prev, y_prev)
    numpy (R,) → (new state, y)."""
    from scipy.signal import lfilter
    xp, yp = state
    xn = x.cpu().numpy()
    y, _ = lfilter([b0, b1], [1.0, -a1], xn, axis=-1,
                   zi=(b1 * xp + a1 * yp)[:, None])
    return (xn[:, -1].copy(), y[:, -1].copy()), torch.as_tensor(y, device=x.device)


class FrontRef:
    """A mode's chain from the channel samples to the demodulated signal
    ahead of the AGC, streamed over segments of blocks, one row a
    filterbank slot; every stage carries its own history."""

    def __init__(self, plan: ChannelPlan, rows: int, device, precision: Precision):
        self.plan, self.dev, self.p = plan, torch.device(device), precision
        d, c = self.dev, torch.complex128
        self.phase = np.zeros(rows, np.int64)
        self.fir_h = self.fir_tail = self.rat_bank = None
        if plan.fir is not None:
            self.fir_h = torch.as_tensor(precision.taps(plan.fir), device=d)
            self.fir_tail = torch.zeros((rows, len(plan.fir) - 1), dtype=c, device=d)
        if plan.rat is not None:
            bank, t = _rational_bank(precision.taps(plan.rat), plan.L, plan.M)
            self.rat_bank = torch.as_tensor(bank, device=d)
            self.rat_tail = torch.zeros((rows, t), dtype=c, device=d)
        self.bp_tail = torch.zeros((rows, plan.bp_ntaps - 1), dtype=c, device=d)
        self.bp_taps: dict = {}
        self.sq_hang = np.zeros(rows, np.int64)
        self.iir = (np.zeros(rows), np.zeros(rows))
        self.fm_prev = torch.zeros(rows, dtype=c, device=d)
        # NFM samples whose phase step lies this close to ±π (relative to
        # the row's scale) are a float-ambiguous decision: ``fm_forks``
        # lists each segment's (row, sample, what the other sign adds to
        # the de-emphasised output from there on); 0 = never fork
        self.fm_tie = 0.0
        self.fm_forks: list = []

    def shift(self, x, fine_hz):
        """Mix by −fine on a 32-bit fixed-point phase that runs on across
        blocks, each block at its own rate."""
        pl = self.plan
        cb = pl.channel_block
        # the phase increment is the float32 quotient −fine ÷ channel rate,
        # the dial as a float32 control carries it, then 32-bit fixed point
        rate32 = -np.asarray(fine_hz, np.float32) / np.float32(pl.fc)
        rates = np.vectorize(fixed_rate, otypes=[np.int64])(rate32.astype(np.float64))
        steps = rates * cb
        start = (self.phase[:, None]
                 + np.concatenate([np.zeros((len(rates), 1), np.int64),
                                   np.cumsum(steps, 1)[:, :-1]], 1)) & 0xFFFFFFFF
        self.phase = (self.phase + steps.sum(1)) & 0xFFFFFFFF
        start = torch.as_tensor(start, device=self.dev)
        r = torch.as_tensor(rates, device=self.dev)
        n = torch.arange(cb, dtype=torch.int64, device=self.dev)
        ph = (start[:, :, None] + r[:, :, None] * n) & 0xFFFFFFFF
        ang = ph.reshape(ph.shape[0], -1).to(torch.float64) * (2 * np.pi / 2.0 ** 32)
        return self.p.r(x * torch.polar(torch.ones_like(ang), ang))

    def taps(self, low: float, high: float) -> np.ndarray:
        pl = self.plan
        key = (low, high)
        if key not in self.bp_taps:
            lo = min(max(low / pl.if_rate, -0.4999), 0.4999)
            hi = min(max(high / pl.if_rate, lo + pl.bp_transition), 0.49999)
            self.bp_taps[key] = self.p.taps(bandpass(lo, hi, pl.bp_transition))
        return self.bp_taps[key]

    def bandpass(self, x, low_hz, high_hz):
        """Each block through the FIR of that block's passband."""
        pl = self.plan
        n, t = pl.if_block, pl.bp_ntaps
        rows, segs = low_hz.shape
        xe = torch.cat([self.bp_tail, x], -1)
        self.bp_tail = xe[:, xe.shape[-1] - (t - 1):]
        frames = xe.unfold(-1, t - 1 + n, n)                       # (R, S, t−1+n)
        h = torch.as_tensor(np.array([[self.taps(float(low_hz[i, j]), float(high_hz[i, j]))
                                       for j in range(segs)] for i in range(rows)]),
                            device=self.dev)
        size = 1 << int(math.ceil(math.log2(t - 1 + n)))
        y = torch.fft.ifft(torch.fft.fft(frames, size) * torch.fft.fft(h, size))
        return self.p.r(y[..., t - 1: t - 1 + n].reshape(x.shape))

    def squelch(self, x, level_db):
        """Window power against the level, open while above it and for two
        windows after."""
        w = self.plan.sq_window
        p = (x.abs() ** 2).reshape(x.shape[0], -1, w).mean(-1)
        db = 10 * torch.log10(torch.clamp_min(p, 1e-30))
        per = p.shape[1] // level_db.shape[1]
        above = (db > torch.as_tensor(np.repeat(level_db, per, 1), device=self.dev)
                 ).cpu().numpy()
        gate = np.zeros_like(above)
        hang = self.sq_hang
        for k in range(above.shape[1]):
            hang = np.where(above[:, k], 2, np.maximum(hang - 1, 0))
            gate[:, k] = above[:, k] | (hang > 0)
        self.sq_hang = hang
        g = torch.as_tensor(np.repeat(gate, w, 1), device=self.dev)
        return torch.where(g, x, torch.zeros((), dtype=x.dtype, device=self.dev))

    def demod(self, x):
        pl = self.plan
        if pl.mode in ("usb", "lsb", "cw"):
            return self.p.r(x.real * 2.0)
        if pl.mode == "am":
            env = self.p.r(x.abs())
            r = math.exp(-2 * math.pi * 10.0 / pl.if_rate)
            self.iir, y = _iir1(self.iir, env, 1.0, -1.0, r)
            return self.p.r(y)
        if pl.mode == "nfm":
            prev = torch.cat([self.fm_prev[:, None], x[:, :-1]], -1)
            self.fm_prev = x[:, -1].clone()
            d = x * prev.conj()
            y = torch.where(d.abs() > 0, torch.angle(d) / math.pi,
                            torch.zeros((), dtype=torch.float64, device=self.dev))
            y = self.p.r(torch.clamp(y, -1.0, 1.0))
            dt = 1.0 / pl.if_rate
            alpha = dt / (NFM_TAU + dt)
            self.fm_forks = self._fm_ties(x, prev, d, y, alpha) if self.fm_tie else []
            self.iir, y = _iir1(self.iir, y, alpha, 0.0, 1.0 - alpha)
            return self.p.r(y)
        raise KeyError(pl.mode)

    def _fm_ties(self, x, prev, d, y, alpha):
        """The discriminator's samples at ±π to within float32 rounding: a
        phase step whose imaginary part is under ``fm_tie`` × the row's
        scale × (|x| + |prev|), with a negative real part.  The program may
        take either sign there; the other sign adds ∓2 at that sample,
        which the de-emphasis spreads as alpha·(1 − alpha)^k.  A tie in a
        segment's last few hundred samples also moves the next segment's
        start by under its decayed tail, which is not followed."""
        scale = x.abs().pow(2).mean(-1).sqrt()[:, None]
        tie = (d.real < 0) & (d.imag.abs() <= self.fm_tie * scale * (x.abs() + prev.abs()))
        out = []
        if not bool(tie.any()):
            return out
        n = y.shape[-1]
        for r, k in tie.nonzero().tolist():
            tail = torch.zeros(n, dtype=torch.float64, device=self.dev)
            m = n - k
            tail[k:] = (-2.0 * y[r, k]) * alpha * (1.0 - alpha) ** torch.arange(
                m, dtype=torch.float64, device=self.dev)
            out.append((r, k, tail))
        return out

    def __call__(self, x, fine_hz, low_hz, high_hz, level_db):
        """Channel samples of S blocks (R, S·channel_block) and per (row,
        block) fine offset, passband and squelch level → the demodulated
        signal (R, S·if_block) float64."""
        pl = self.plan
        x = self.shift(x, fine_hz)
        if self.fir_h is not None:
            self.fir_tail, x = _fir(self.fir_tail, x, self.fir_h, pl.dec)
            x = self.p.r(x)
        if self.rat_bank is not None:
            xe = torch.cat([self.rat_tail, x], -1)
            t = self.rat_tail.shape[-1]
            self.rat_tail = xe[:, xe.shape[-1] - t:]
            groups = x.shape[-1] // pl.M
            out = torch.zeros((x.shape[0], groups, pl.L), dtype=x.dtype, device=self.dev)
            for c in range(self.rat_bank.shape[1]):
                out += xe[:, c: c + groups * pl.M: pl.M][:, :groups, None] * self.rat_bank[:, c]
            x = self.p.r(out.reshape(x.shape[0], groups * pl.L))
        x = self.bandpass(x, low_hz, high_hz)
        x = self.squelch(x, level_db)
        return self.demod(x)


class BackRef:
    """AGC → client-audio rate → NR → limiter, streamed over segments, on
    candidate rows.

    The AGC's per-chunk decision (attack when the chunk's target gain is
    under the gain) is a comparison that float32 rounding can take either
    way when target and gain agree to within ``tie`` (relative); there a
    candidate forks into both outcomes, and ``keep`` later drops the
    candidates the program's output rules out.  ``origin`` gives each
    candidate's input row."""

    def __init__(self, plan: ChannelPlan, rows: int, device, precision: Precision,
                 tie: float = 2e-4, max_candidates: int = 32):
        self.plan, self.dev, self.p = plan, torch.device(device), precision
        self.tie, self.max_candidates = tie, max_candidates
        self.attack, self.decay, self.hang_chunks = plan.agc
        self.origin = np.arange(rows)
        self.src = np.arange(rows)        # each candidate's row of the input
        self.g = np.ones(rows)
        self.hang = np.zeros(rows, np.int64)
        d = self.dev
        self.fir_h = None
        if plan.audio_fir is not None:
            self.fir_h = torch.as_tensor(precision.taps(plan.audio_fir), device=d)
            self.fir_tail = torch.zeros((rows, len(plan.audio_fir) - 1),
                                        dtype=torch.float64, device=d)
        hop = plan.nr_hop
        self.nr_in = torch.zeros((rows, hop), dtype=torch.float64, device=d)
        self.nr_ola = torch.zeros((rows, hop), dtype=torch.float64, device=d)
        self.nr_floor = torch.full((rows,), -1.0, dtype=torch.float64, device=d)
        frame = 2 * hop
        self.nfft = 1 << max(9, int(np.ceil(np.log2(frame))))
        self.win = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame) / frame),
                                   device=d)
        cola = self.win[:hop] ** 2 + self.win[hop:] ** 2
        self.corr = 1.0 / torch.clamp_min(cola, 1e-3)
        self.forks = 0
        self.fork_src: list[int] = []    # candidate each fork was copied from

    def _take(self, idx):
        idx = np.asarray(idx)
        t = torch.as_tensor(idx, device=self.dev)
        self.origin, self.g, self.hang = self.origin[idx], self.g[idx], self.hang[idx]
        self.src = self.src[idx]
        if self.fir_h is not None:
            self.fir_tail = self.fir_tail[t]
        self.nr_in, self.nr_ola, self.nr_floor = self.nr_in[t], self.nr_ola[t], self.nr_floor[t]

    def keep(self, idx):
        """Keep only these candidates."""
        self._take(idx)

    def fork_inputs(self, x, forks):
        """Before a segment: each (row, sample, tail) of ``forks`` (the
        front end's float-ambiguous samples) doubles every candidate of that
        row, the copy reading the row with ``tail`` added → the input with
        the copies' rows appended.  Every candidate reads its own row
        again from here on."""
        self.src = self.origin.copy()
        if not forks:
            return x
        extra = []
        for r, _, tail in forks:
            for c in np.flatnonzero(self.origin == r):
                if (self.origin == r).sum() >= self.max_candidates:
                    break
                row = x[self.src[c]] if self.src[c] < x.shape[0] else extra[self.src[c] - x.shape[0]]
                extra.append(row + tail)
                self._take(np.append(np.arange(len(self.origin)), c))
                self.src[-1] = x.shape[0] + len(extra) - 1
                self.fork_src.append(int(c))
                self.forks += 1
        return torch.cat([x, torch.stack(extra)]) if extra else x

    def agc(self, x):
        c = self.plan.agc_chunk
        env = x.abs().reshape(x.shape[0], -1, c).amax(-1).cpu().numpy()
        nch = env.shape[1]
        n0 = len(self.origin)
        origin, g, hang = list(self.origin), self.g.copy(), self.hang.copy()
        src = list(self.src)
        env_c = env[self.src]
        gains = np.empty((len(origin), nch))
        g0 = g.copy()
        forked = []                       # the candidate each new one copies
        attack, decay, hold = self.attack, self.decay, self.hang_chunks
        for k in range(nch):
            target = AGC_REFERENCE / np.maximum(env_c[:, k], 1e-9)
            d = target - g
            attacking = d < 0
            if self.tie:
                close = np.abs(d) <= self.tie * g
                if close.any():
                    for i in np.flatnonzero(close):
                        if origin.count(origin[i]) >= self.max_candidates:
                            continue
                        forked.append(int(i))
                        origin.append(origin[i])
                        src.append(src[i])
                        g, hang, g0 = np.append(g, g[i]), np.append(hang, hang[i]), np.append(g0, g0[i])
                        env_c = np.concatenate([env_c, env_c[i:i + 1]])
                        gains = np.concatenate([gains, gains[i:i + 1]])
                        d, target = np.append(d, d[i]), np.append(target, target[i])
                        attacking = np.append(attacking, not attacking[i])
            g = np.where(attacking, g + attack * d, np.where(hang > 0, g, g + decay * d))
            hang = np.where(attacking, hold, np.maximum(hang - 1, 0))
            g = np.clip(g, 1e-6, AGC_MAX_GAIN)
            if self.p.low:
                g = self.p.r(torch.as_tensor(g)).numpy()
            gains[:, k] = g
        if forked:
            self.forks += len(forked)
            self.fork_src.extend(forked)
            # a candidate forked in this segment holds the filter and NR
            # state its first ancestor held at the segment's start
            root = []
            for i in forked:
                root.append(i if i < n0 else root[i - n0])
            self._take(np.concatenate([np.arange(n0), root]).astype(np.int64))
        self.origin, self.g, self.hang = np.asarray(origin), g, hang
        self.src = np.asarray(src)
        gains = torch.as_tensor(gains, device=self.dev)
        prev = torch.cat([torch.as_tensor(g0, device=self.dev)[:, None], gains[:, :-1]], 1)
        ramp = torch.arange(c, dtype=torch.float64, device=self.dev) / c
        gs = (prev[..., None] + (gains - prev)[..., None] * ramp).reshape(len(self.origin), -1)
        return self.p.r(x[torch.as_tensor(self.src, device=self.dev)] * gs)

    def nr(self, x, threshold_db: float = -100.0):
        """Spectral NR on 50 %-overlap Hann frames of 2·hop: a floor from
        each frame's 25th-percentile magnitude, averaged over a block's
        frames and smoothed across blocks, soft subtraction with the gain
        in [0.1, 1], exact overlap-add (one hop of delay)."""
        pl = self.plan
        hop, blk = pl.nr_hop, pl.audio_block
        rows = x.shape[0]
        xe = torch.cat([self.nr_in, x], -1)
        self.nr_in = xe[:, -hop:]
        frames = xe.unfold(-1, 2 * hop, hop) * self.win
        spec = torch.fft.rfft(frames, n=self.nfft)
        mag = spec.abs()
        fpb = blk // hop
        nb = x.shape[-1] // blk
        q = torch.quantile(mag.reshape(-1, mag.shape[-1]), 0.25, dim=-1,
                           interpolation="linear").reshape(rows, nb, fpb).mean(-1)
        floor = torch.empty_like(q)
        cur = self.nr_floor
        for b in range(nb):
            cur = torch.where(cur < 0, q[:, b], 0.8 * cur + 0.2 * q[:, b])
            floor[:, b] = cur
        self.nr_floor = cur
        sub = 10 ** (threshold_db / 20) * floor.repeat_interleave(fpb, 1)
        gain = torch.clamp((mag - sub[..., None]) / torch.clamp_min(mag, 1e-9), 0.1, 1.0)
        cleaned = torch.fft.irfft(spec * gain, n=self.nfft)[..., :2 * hop] * self.win
        first, second = cleaned[..., :hop], cleaned[..., hop:]
        prev = torch.cat([self.nr_ola[:, None], second[:, :-1]], 1)
        self.nr_ola = second[:, -1]
        return ((first + prev) * self.corr).reshape(rows, -1)

    def __call__(self, x):
        """Demodulated signal of S blocks (R, S·if_block) → audio in int16
        units (C, S·audio_block), one row a candidate."""
        pl = self.plan
        y = self.agc(x)
        if self.fir_h is not None:
            self.fir_tail, y = _fir(self.fir_tail, y, self.fir_h, pl.audio_dec)
            y = self.p.r(y)
        y = self.p.r(self.nr(y))
        return torch.clamp(y, -1.0, 1.0) * SHORT_SCALE

class PfbRef:
    """M-channel critically sampled polyphase filterbank, from its
    definition: channel k at frame t of a block is
    Σ_i h[i]·e^{+2πi·k·i/M}·x[t·M − i] over the stream x (zero before its
    start), computed as M phases and an M-point inverse DFT."""

    def __init__(self, m: int, taps_per_phase: int, device, precision: Precision):
        self.m, self.p_taps = m, taps_per_phase
        self.dev, self.p = torch.device(device), precision
        h = precision.taps(pfb_prototype(m, taps_per_phase))
        self.h = torch.as_tensor(h.reshape(taps_per_phase, m), device=self.dev)
        self.tail = torch.zeros(taps_per_phase * m, dtype=torch.complex128,
                                device=self.dev)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """One device block (B,) complex128 → (M, B/M) channels; carries the
        last P·M samples to the next block."""
        m, pt = self.m, self.p_taps
        xe = torch.cat([self.tail, x])
        self.tail = xe[-pt * m:]
        nb = x.shape[0] // m
        # Z[s, r] = xe[s·M − r]; w[t, r] = Σ_j h[j·M + r]·Z[t + P − j, r]
        s_rows = nb + pt
        z = torch.empty((s_rows, m), dtype=xe.dtype, device=self.dev)
        z[0] = 0
        z[1:, 0] = xe[m: s_rows * m: m]
        rev = xe[:s_rows * m].reshape(s_rows, m)
        z[1:, 1:] = rev[:-1, 1:].flip(-1)
        w = torch.zeros((nb, m), dtype=xe.dtype, device=self.dev)
        for j in range(pt):
            w += z[pt - j: pt - j + nb] * self.h[j]
        return self.p.r((torch.fft.ifft(w, dim=-1) * m).T)


def wire_to_complex(wire: np.ndarray, device) -> torch.Tensor:
    """uint8 (n, 2) wire pairs → complex128: (u − 127.4)/128."""
    f = (torch.as_tensor(wire, device=device).to(torch.float64) - 127.4) / 128.0
    return torch.complex(f[:, 0], f[:, 1])


class WaterfallRef:
    """Rows of a block: ``rows`` rows of ``averages`` Hann-windowed
    ``size``-point frames, frames spaced evenly so the last ends at the
    block's end, power averaged, normalised by size², in dB plus
    ``add_db``, fftshifted."""

    def __init__(self, size: int, fps: float, fs: float, block: int, device,
                 precision: Precision, add_db: float = -70.0):
        self.size, self.dev, self.p, self.add_db = size, torch.device(device), precision, add_db
        self.rows = max(1, round(fps * block / fs))
        self.averages = max(1, block // (size * self.rows))
        self.stride = block // (self.rows * self.averages)
        self.win = torch.as_tensor(precision.taps(np.hanning(size)), device=self.dev)
        self.hist = torch.zeros(size, dtype=torch.complex128, device=self.dev)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        n = self.rows * self.averages
        xe = torch.cat([self.hist, x])
        self.hist = xe[-self.size:]
        # frame k holds the block's samples [(k+1)·stride − size, (k+1)·stride)
        idx = ((torch.arange(n, device=self.dev) + 1) * self.stride)[:, None] \
            + torch.arange(self.size, device=self.dev)
        f = xe[idx]
        spec = torch.fft.fft(self.p.r(f * self.win))
        pw = self.p.r(spec.real ** 2 + spec.imag ** 2)
        pm = pw.reshape(self.rows, self.averages, self.size).mean(1) / self.size ** 2
        db = 10 * torch.log10(torch.clamp_min(pm, 1e-30)) + self.add_db
        return self.p.r(torch.fft.fftshift(db, dim=-1))
