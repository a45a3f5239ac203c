"""The IMA cells hold the port's own encoder input, and the encoder the
control uses is the codec the cells decode."""

import numpy as np
import torch

from pbench.ref import ima


def test_cells_hold_the_ports_encoder_input():
    from openwebrx_tpu_torch.ops import adpcm
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.normal(0, 900, (16, 1200)), 1).clip(-32768, 32767).astype(np.int16)
    st = adpcm.adpcm_init((16,), device="cpu")
    _, (b, s) = adpcm.adpcm_encode(st, torch.as_tensor(x))
    for r in range(16):
        wire = adpcm.SyncFramer().frame(b[r].numpy(), s[r].numpy())
        states, nib = ima.split_frames(wire)
        lo, hi, ok = ima.cells(states, nib)
        v = x[r].reshape(lo.shape)
        assert ((v >= lo) & (v <= hi)).all()
        assert np.median(hi - lo) < 4000


def test_encode_then_cells_round_trip():
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 3000, (5, 400))).clip(-32768, 32767).astype(np.int64)
    nib, _ = ima.encode(x)
    lo, hi, _ = ima.cells(np.zeros((5, 2), np.int64), nib)
    assert ((x >= lo) & (x <= hi)).all()


def test_truncation_gap():
    lo, hi = np.array([5, -3, 0]), np.array([7, -1, 0])
    v = np.array([7.9, -3.9, 0.5])
    assert (ima.truncation_gap(v, lo, hi) == 0).all()
    g = ima.truncation_gap(np.array([8.5, -4.5, 1.5]), lo, hi)
    assert np.allclose(g, [0.5, 0.5, 0.5])
