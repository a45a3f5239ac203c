"""IMA ADPCM codec: stride-parallel audio encode, exact waterfall-row encode,
host framing.

Counterpart of ``openwebrx_tpu/ops/adpcm.py``.  The wire format matches the
reference browser decoder: "SYNC" + int16le step index + int16le predictor,
then ADPCM bytes (two nibbles per byte, low nibble first).

The audio encoder restarts its adaptation at every STATE_STRIDE-byte stride
from a reseed state that rides the wire in the sync header, so strides are
independent: the 100-step recurrence runs with one lane per (channel,
stride).  On a CUDA tensor :func:`adpcm_encode` is one launch of the
hand-written kernel ``csrc/adpcm.cu``, which computes the reseed states,
runs every lane's recurrence and writes the stride states and the carried
state; :func:`encode_strides` runs the same kernel on explicit start
states.  On a CPU tensor both are their plain versions
(:func:`adpcm_encode_plain`, :func:`encode_strides_plain`).  Bytes, stride
states and carried state must equal the reference bit for bit on
identical int16 input.

Waterfall rows carry no codec state on the wire, so they are encoded as
one exact continuous IMA recurrence a row (:func:`adpcm_encode_seq`): on a
CUDA tensor one launch of ``csrc/adpcm_seq.cu``, on a CPU tensor
:func:`adpcm_encode_seq_plain`.  Its bytes, stride states and final state
equal the reference bit for bit as well.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import ADPCM, ADPCM_SEQ
from openwebrx_tpu_torch.ops import wrap32

IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)

IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
    19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
    130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
    337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
    876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
    5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)

# bytes per independently encoded stride; also the sync-header interval
STATE_STRIDE = 100
SYNC_INTERVAL = STATE_STRIDE
COMPRESS_FFT_PAD_N = 10  # the client skips this many samples of a row
SEQ_DIAG_WORDS = 8       # the row-encoder kernel's diag words a row


def adpcm_init(batch_shape=(), device="cuda"):
    dev = resolve_device(device)
    return (torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev),   # predictor
            torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev))   # step index


@functools.lru_cache(maxsize=None)
def _step_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(IMA_STEP_TABLE, device=device).to(dtype)


def pack_codec_state(pred: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(predictor, index) → packed int32 (pred << 16) | (idx & 0xFFFF)."""
    return wrap32((pred.to(torch.int64) << 16) | (idx.to(torch.int64) & 0xFFFF))


def unpack_codec_state(packed: int) -> tuple[int, int]:
    """Packed int32 → (predictor, step index) on host."""
    v = np.int32(packed)
    return int(v >> 16), int(v & 0xFFFF)


def _encode_nibble(predictor, index, sample, table):
    """One IMA ADPCM encode step on int32 tensors (plain version)."""
    step = table[index]
    diff = sample - predictor
    sign = (diff < 0).to(torch.int32)
    diff = diff.abs()
    nib = torch.zeros_like(index)
    delta = step >> 3
    for stepval, bit in ((step, 4), (step >> 1, 2), (step >> 2, 1)):
        take = diff >= stepval
        nib = torch.where(take, nib | bit, nib)
        diff = torch.where(take, diff - stepval, diff)
        delta = torch.where(take, delta + stepval, delta)
    delta = torch.where(sign == 1, -delta, delta)
    predictor = torch.clamp(predictor + delta, -32768, 32767)
    nib = nib | (sign << 3)
    # IMA_INDEX_TABLE[nib] = −1 for (nib & 7) < 4 else 2·(nib & 7) − 6
    low = nib & 7
    index = torch.clamp(index + torch.where(low < 4, -1, 2 * low - 6), 0, 88)
    return predictor, index, nib


def encode_strides_plain(samples: torch.Tensor, prev: torch.Tensor,
                         idxs: torch.Tensor) -> torch.Tensor:
    """Plain version of the recurrence: samples (L, 2·K) int16 (K is
    STATE_STRIDE on the paths), prev/idxs (L,) int32 → bytes (L, K) uint8."""
    x = samples.to(torch.int32).reshape(samples.shape[0], samples.shape[1] // 2, 2)
    table = _step_table(torch.int32, samples.device)
    pred, idx = prev, idxs
    out = []
    for i in range(x.shape[1]):
        pred, idx, lo = _encode_nibble(pred, idx, x[:, i, 0], table)
        pred, idx, hi = _encode_nibble(pred, idx, x[:, i, 1], table)
        out.append((lo | (hi << 4)).to(torch.uint8))
    return torch.stack(out, dim=-1)


def encode_strides(samples: torch.Tensor, prev: torch.Tensor,
                   idxs: torch.Tensor, device="cuda") -> torch.Tensor:
    """The stride-parallel IMA recurrence, one lane per row: samples
    (L, 2·STRIDE) int16, prev/idxs (L,) int32 start states → bytes
    (L, STRIDE) uint8.  CUDA kernel on a CUDA device, plain version on the
    CPU; the tensors must lie on ``device``."""
    dev = resolve_device(device)
    check_on(dev, samples, prev, idxs)
    lanes = samples.shape[0]
    if (samples.dtype != torch.int16 or samples.dim() != 2
            or samples.shape[1] != 2 * STATE_STRIDE):
        raise ValueError(f"samples must be (L, {2 * STATE_STRIDE}) int16, "
                         f"got {tuple(samples.shape)} {samples.dtype}")
    for name, t in (("prev", prev), ("idxs", idxs)):
        if t.dtype != torch.int32 or tuple(t.shape) != (lanes,):
            raise ValueError(f"{name} must be ({lanes},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type == "cpu":
        return encode_strides_plain(samples, prev, idxs)
    out = torch.empty((lanes, STATE_STRIDE), dtype=torch.uint8, device=dev)
    if lanes == 0:
        return out
    if not (samples.is_contiguous() and prev.is_contiguous()
            and idxs.is_contiguous() and samples.data_ptr() % 16 == 0):
        raise ValueError("the ADPCM kernel needs contiguous inputs and "
                         "16-byte aligned samples")
    ADPCM.launch(dev, samples.data_ptr(), None, None, prev.data_ptr(),
                 idxs.data_ptr(), out.data_ptr(), None, None, None, lanes, 1)
    return out


def _estimate_index(xs: torch.Tensor) -> torch.Tensor:
    """Per-stride step-index estimate: the table index whose step best
    tracks the stride's mean |Δx|.  The sum of |Δx| is an exact integer
    (below 2²⁴), divided once in float32 as the reference's mean does."""
    total = torch.diff(xs, dim=-1).abs().sum(dim=-1).to(torch.float32)
    # a tensor divisor: on the card a scalar one becomes a reciprocal multiply
    md = total / torch.full_like(total, xs.shape[-1] - 1)
    table = _step_table(torch.float32, xs.device)
    return torch.clamp(torch.searchsorted(table, md), 0, 88).to(torch.int32)


def adpcm_encode_plain(state, samples: torch.Tensor):
    """Plain version of :func:`adpcm_encode`: the reseed states in PyTorch
    around :func:`encode_strides_plain`."""
    batch = samples.shape[:-1]
    n = samples.shape[-1] // 2                        # bytes this block
    s = n // STATE_STRIDE                             # strides this block
    x16 = samples.reshape(*batch, s, 2 * STATE_STRIDE)
    xs = x16.to(torch.int32)
    pred0, idx0 = state
    # start states per stride: the raw sample before the stride, and the
    # index estimated from the stride BEFORE it
    prev = torch.cat([pred0[..., None], xs[..., :-1, -1]], dim=-1)
    est = _estimate_index(xs)
    idxs = torch.cat([idx0[..., None], est[..., :-1]], dim=-1)
    bytes_ = encode_strides_plain(x16.reshape(-1, 2 * STATE_STRIDE),
                                  prev.reshape(-1), idxs.reshape(-1))
    bytes_ = bytes_.reshape(*batch, n)
    stride = pack_codec_state(xs[..., :, -1] & 0xFFFF, est)
    new_state = (xs[..., -1, -1], est[..., -1])
    return new_state, (bytes_, stride)


def adpcm_encode(state, samples: torch.Tensor):
    """Stride-parallel IMA encode for the audio path: int16 samples
    (..., 2N) with N % STATE_STRIDE == 0 → (new_state, (bytes (..., N)
    uint8, stride (..., N/STATE_STRIDE) int32)).

    stride[..., i] is the packed start state of stride i+1; stride 0 starts
    from the carried block state.  On a CUDA tensor one launch of the
    kernel, on a CPU tensor :func:`adpcm_encode_plain`; the state must lie
    on the samples' device."""
    pred0, idx0 = state
    dev = samples.device
    check_on(dev, pred0, idx0)
    batch = tuple(samples.shape[:-1])
    two_n = samples.shape[-1] if samples.dim() else 0
    if (samples.dtype != torch.int16 or two_n == 0
            or two_n % (2 * STATE_STRIDE)):
        raise ValueError(f"samples must be (..., 2N) int16 with N a positive "
                         f"multiple of {STATE_STRIDE}, got "
                         f"{tuple(samples.shape)} {samples.dtype}")
    for name, t in (("predictor", pred0), ("index", idx0)):
        if t.dtype != torch.int32 or tuple(t.shape) != batch:
            raise ValueError(f"{name} state must be {batch} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type == "cpu":
        return adpcm_encode_plain(state, samples)
    n = two_n // 2
    s = n // STATE_STRIDE
    bytes_ = torch.empty(batch + (n,), dtype=torch.uint8, device=dev)
    stride = torch.empty(batch + (s,), dtype=torch.int32, device=dev)
    new_state = (torch.empty(batch, dtype=torch.int32, device=dev),
                 torch.empty(batch, dtype=torch.int32, device=dev))
    lanes = bytes_.numel() // STATE_STRIDE
    if lanes == 0:
        return new_state, (bytes_, stride)
    x = samples.contiguous()
    pred0, idx0 = pred0.contiguous(), idx0.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the ADPCM kernel needs 16-byte aligned samples")
    ADPCM.launch(dev, x.data_ptr(), pred0.data_ptr(), idx0.data_ptr(), None, None,
                 bytes_.data_ptr(), stride.data_ptr(), new_state[0].data_ptr(),
                 new_state[1].data_ptr(), lanes, s)
    return new_state, (bytes_, stride)


def adpcm_encode_seq_plain(state, samples: torch.Tensor):
    """Plain version of :func:`adpcm_encode_seq`: the recurrence as a
    Python loop over the row's bytes."""
    pred, idx = state
    x = samples.to(torch.int32)
    table = _step_table(torch.int32, samples.device)
    out, strides = [], []
    for i in range(x.shape[-1] // 2):
        pred, idx, lo = _encode_nibble(pred, idx, x[..., 2 * i], table)
        pred, idx, hi = _encode_nibble(pred, idx, x[..., 2 * i + 1], table)
        out.append((lo | (hi << 4)).to(torch.uint8))
        if i % STATE_STRIDE == STATE_STRIDE - 1:
            strides.append(pack_codec_state(pred, idx))
    lead = tuple(samples.shape[:-1])
    stride = (torch.stack(strides, dim=-1) if strides else
              torch.zeros(lead + (0,), dtype=torch.int32, device=samples.device))
    return (pred, idx), (torch.stack(out, dim=-1), stride)


def adpcm_encode_seq(state, samples: torch.Tensor):
    """Exact continuous IMA encode (waterfall rows): int16 samples (..., 2N)
    from start states (predictor, index 0..88) (...,) int32 → (new_state,
    (bytes (..., N) uint8, stride (..., N // STATE_STRIDE) int32)), where
    stride is the packed codec state after every STATE_STRIDE-th byte.  On
    a CUDA tensor one launch of the kernel, on a CPU tensor
    :func:`adpcm_encode_seq_plain`; the state must lie on the samples'
    device."""
    pred0, idx0 = state
    dev = samples.device
    check_on(dev, pred0, idx0)
    lead = tuple(samples.shape[:-1])
    two_n = samples.shape[-1] if samples.dim() else 0
    if samples.dtype != torch.int16 or two_n == 0 or two_n % 2:
        raise ValueError(f"samples must be (..., 2N) int16 with N > 0, got "
                         f"{tuple(samples.shape)} {samples.dtype}")
    for name, t in (("predictor", pred0), ("index", idx0)):
        if t.dtype != torch.int32 or tuple(t.shape) != lead:
            raise ValueError(f"{name} state must be {lead} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type == "cpu":
        return adpcm_encode_seq_plain(state, samples)
    return encode_seq_kernel(state, samples)


def encode_seq_kernel(state, samples: torch.Tensor, forced: int = 0,
                      diag: torch.Tensor | None = None):
    """One launch of ``csrc/adpcm_seq.cu`` on CUDA tensors that
    :func:`adpcm_encode_seq` has checked.  The kernel runs candidate
    trajectories from guessed states in parallel and has one sweep follow
    the true state through them; the output does not depend on the guesses.
    ``forced`` is a test input that changes the work and not the output: 1
    starts every guessed segment from (−32768, 88), 2 lets the sweep take no
    guessed run (all but the first run encoded in series, the design's
    worst case).
    ``diag``, an (rows, SEQ_DIAG_WORDS) int32 tensor, receives per row the
    run ends the sweep looked up, the nibbles it encoded itself, the nibbles
    of the longest first-pass run and the SM cycles of the kernel and of its
    set-up, first pass, sweep and output."""
    pred0, idx0 = state
    dev = samples.device
    if forced not in (0, 1, 2):
        raise ValueError(f"forced must be 0, 1 or 2, got {forced}")
    if dev.type != "cuda":
        raise ValueError(f"the row-encoder kernel runs on CUDA tensors, got {dev}")
    lead = tuple(samples.shape[:-1])
    n = samples.shape[-1] // 2
    bytes_ = torch.empty(lead + (n,), dtype=torch.uint8, device=dev)
    stride = torch.empty(lead + (n // STATE_STRIDE,), dtype=torch.int32, device=dev)
    new_state = (torch.empty(lead, dtype=torch.int32, device=dev),
                 torch.empty(lead, dtype=torch.int32, device=dev))
    rows = int(np.prod(lead, dtype=np.int64))
    if diag is not None and (diag.dtype != torch.int32
                             or diag.shape != (rows, SEQ_DIAG_WORDS)
                             or not diag.is_contiguous() or diag.device != dev):
        raise ValueError(f"diag must be a contiguous ({rows}, {SEQ_DIAG_WORDS}) "
                         f"int32 tensor on {dev}")
    if rows:
        x = samples.contiguous()
        ADPCM_SEQ.launch(dev, x.data_ptr(), pred0.contiguous().data_ptr(),
                         idx0.contiguous().data_ptr(), bytes_.data_ptr(),
                         stride.data_ptr(), new_state[0].data_ptr(),
                         new_state[1].data_ptr(), rows, 2 * n, forced,
                         None if diag is None else diag.data_ptr())
    return new_state, (bytes_, stride)


def fft_row_samples(rows_db: torch.Tensor) -> torch.Tensor:
    """Waterfall rows (..., N) in dB → the encoder's int16 input: dB×100,
    clipped and truncated, COMPRESS_FFT_PAD_N copies of the first sample in
    front, and the last repeated up to a multiple of 8 samples (whole
    16-byte vectors; the bytes past the wire payload are trimmed on the
    host)."""
    s = torch.clamp(rows_db * 100.0, -32768, 32767).to(torch.int16)
    lead = tuple(s.shape[:-1])
    s = torch.cat([s[..., :1].expand(lead + (COMPRESS_FFT_PAD_N,)), s], dim=-1)
    extra = (-s.shape[-1]) % 8
    if extra:
        s = torch.cat([s, s[..., -1:].expand(lead + (extra,))], dim=-1)
    return s


def wire_bytes_per_row(fft_size: int) -> int:
    """Bytes of one compressed waterfall row on the wire."""
    return (fft_size + COMPRESS_FFT_PAD_N + 1) // 2


def compress_fft_rows(rows_db, device="cuda"):
    """Compress waterfall rows as the reference FftAdpcm does: per row,
    dB×100 as int16, 10 warm-up pad samples in front, a fresh codec per
    row, all rows in one encode on ``device``.  rows_db (R, N) float32
    (numpy or a tensor) → list of R ``bytes``, each (N + 10 + 1) // 2
    long."""
    dev = resolve_device(device)
    if not torch.is_tensor(rows_db):
        rows_db = torch.from_numpy(np.asarray(rows_db, np.float32))
    rows = torch.atleast_2d(rows_db.to(dev))
    raw = encode_fft_rows(rows).cpu().numpy()
    nbytes = wire_bytes_per_row(rows.shape[-1])
    return [raw[i, :nbytes].tobytes() for i in range(raw.shape[0])]


def encode_fft_rows(rows_db: torch.Tensor) -> torch.Tensor:
    """compress_fft_rows without the fetch: rows (..., N) float32 dB on
    their device → uint8 (..., padded bytes) there, whose first
    ``wire_bytes_per_row(N)`` bytes a row are its wire payload."""
    lead, n = tuple(rows_db.shape[:-1]), rows_db.shape[-1]
    s = fft_row_samples(rows_db.reshape(-1, n))
    _, (bytes_, _) = adpcm_encode_seq(adpcm_init(s.shape[:-1], device=s.device), s)
    return bytes_.reshape(lead + (bytes_.shape[-1],))


def adpcm_decode_np(data: bytes, state=(0, 0)):
    """Numpy reference decoder (host side), mirroring the browser's
    decodeNibble."""
    predictor, index = state
    out = np.empty(len(data) * 2, np.int16)
    for i, byte in enumerate(data):
        for k, nib in enumerate((byte & 0x0F, byte >> 4)):
            step = IMA_STEP_TABLE[index]
            diff = step >> 3
            if nib & 1:
                diff += step >> 2
            if nib & 2:
                diff += step >> 1
            if nib & 4:
                diff += step
            if nib & 8:
                diff = -diff
            predictor = int(np.clip(predictor + diff, -32768, 32767))
            index = int(np.clip(index + IMA_INDEX_TABLE[nib], 0, 88))
            out[i * 2 + k] = predictor
    return out, (predictor, index)


class SyncFramer:
    """Host-side sync framing: splice "SYNC"+state headers into the encoded
    byte stream every SYNC_INTERVAL bytes, reseeding the client decoder.
    Cuts land only on STATE_STRIDE multiples, which the exported stride
    states cover exactly."""

    def __init__(self):
        self.since_sync = SYNC_INTERVAL  # ⇒ emit a sync header immediately
        self._carry = 0                  # packed state at end of prev block

    def frame(self, bytes_: np.ndarray, stride_states: np.ndarray) -> bytes:
        """bytes_: this block's encoded bytes (multiple of STATE_STRIDE);
        stride_states: packed int32 reseed state at each STATE_STRIDE
        boundary (the start state of the following stride)."""
        out = bytearray()
        n = len(bytes_)
        pos = 0
        while pos < n:
            if self.since_sync >= SYNC_INTERVAL:
                packed = self._carry if pos == 0 else int(
                    stride_states[pos // STATE_STRIDE - 1])
                pred, idx = unpack_codec_state(packed)
                out += b"SYNC" + np.array([idx, pred], "<i2").tobytes()
                self.since_sync = 0
            take = min(n - pos, SYNC_INTERVAL - self.since_sync)
            out += bytes(bytes_[pos:pos + take])
            pos += take
            self.since_sync += take
        if n:
            self._carry = int(stride_states[-1])
        return bytes(out)
