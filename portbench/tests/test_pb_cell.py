"""Whole runs on the CPU at a small size, of a cell made of data alone
(a configuration file, a traffic file and an entry in BENCHMARK.json):
sound, with the bfloat16 control in the program's place, and with the
timed path broken underneath in each way a cell of this system can be,
its routing among them."""

import json

import pytest
import torch

from pbench import check
from pbench.cell import run_cell

CONFIG = {"name": "tiny", "sample_rate": 1024000, "wire": "cu8", "precision": "float32",
          "settings": {"fft_size": 1024, "fft_fps": 9, "audio_compression": "adpcm",
                       "fft_compression": "adpcm", "tpu_channel_capacity": 16,
                       "tpu_block_seconds": 0.1},
          "guarantees": [], "assumed": {}, "reduced": []}
TRAFFIC = {"pacing": "saturate", "waterfall": True, "service": False, "loop_blocks": 2,
           "warm_blocks": 3, "warm": {"retunes": 1},
           "listeners": [{"mode": "usb", "count": 2}, {"mode": "am", "count": 1},
                         {"mode": "nfm", "count": 1}],
           "stations": {"per_mode": {"usb": 4, "am": 2, "nfm": 2}, "lsb": 6.0,
                        "noise_lsb": 2.0, "dc_lsb": 8.0, "fine_hz": 6000,
                        "tone_hz": [500, 2500], "step_hz": 5},
           "control": {"retunes_per_s": 3},
           "check": {"slots_per_bank": 4, "segment_blocks": 4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir(parents=True)
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (root / "portbench" / "traffic" / "tiny.max.json").write_text(json.dumps(TRAFFIC))
    # the same dials as background services: raw int16 audio, no waterfall
    (root / "portbench" / "traffic" / "tiny.svc.json").write_text(
        json.dumps(dict(TRAFFIC, service=True, waterfall=False)))
    spec = {"command": ["python3", "portbench/run.py"], "paths": ["portbench"],
            "run_seconds": 2,
            "configs": [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}],
            "workloads": [{"name": "tiny.max", "config": "tiny", "traffic": "tiny.max",
                           "chips": 1, "why": "test"},
                          {"name": "tiny.svc", "config": "tiny", "traffic": "tiny.svc",
                           "chips": 1, "why": "test"}],
            "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                            "source": "host_clock"},
                           {"name": "tune_p95_ms", "unit": "ms", "better": "lower",
                            "bound": 0.1, "source": "host_clock"}],
            "per_layer": [{"name": "runtime.span.control_ms.rt", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "runtime",
                           "moves": "tune_p95_ms"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, hooks=None, control=False, cell="tiny.max"):
    return run_cell(cell, 2 ** 31 + 11, 2.0, False, "cpu", root=root,
                    hooks=hooks, control=control)


@pytest.mark.parametrize("cell", ["tiny.max", "tiny.svc"])
def test_a_data_only_cell_runs_and_is_correct(root, cell):
    r = _run(root, cell=cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "tune_p95_ms"}
    assert r["checks"]["audio_wrong_per_block"]["value"] == 0
    assert r["_info"]["audio_gap_lsb"] <= 1.0
    assert r["_info"]["audio_samples"] > 0
    assert (r["_info"].get("waterfall_samples", 0) > 0) == (cell == "tiny.max")


def test_the_bfloat16_control_is_not_correct(root):
    r = _run(root, control=True)
    assert not r["correct"]
    assert r["checks"]["audio_wrong_per_block"]["value"] > check.LIMITS["audio_wrong_per_block"]
    assert r["checks"]["waterfall_gap"]["value"] > 10


def _frozen_state(monkeypatch):
    from openwebrx_tpu_torch.runtime import chain

    def body(self):
        _, y, aux = self.fn(self.state, self.params, self.x)
        y, aux = chain.tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, (y, aux))
        return y, aux, True                    # the state stays as it was
    monkeypatch.setattr(chain.GraphStep, "_body", body)


def _half_batch(monkeypatch):
    from openwebrx_tpu_torch.runtime import chain, channelized
    raw = channelized.ChannelizedBank._raw_step

    def step(self, state, params, x):
        state, y, aux = raw(self, state, params, x)
        n = self._n
        live = torch.as_tensor(self._active.nonzero()[0])
        half = len(live) // 2

        def fill(t):
            if torch.is_tensor(t) and t.dim() and t.shape[0] == n and half:
                t = t.clone()
                # the later half of the live slots left out, filled from the rest
                t[live[-half:]] = t[live[:half]]
            return t
        return state, chain.tree_map(fill, y), aux
    monkeypatch.setattr(channelized.ChannelizedBank, "_raw_step", step)


def _altered_answer(monkeypatch):
    from openwebrx_tpu_torch.runtime import channelized
    raw = channelized.ChannelizedBank._raw_step
    calls = {"n": 0}

    def step(self, state, params, x):
        state, y, aux = raw(self, state, params, x)
        calls["n"] += 1
        if calls["n"] == 12 and isinstance(y, tuple):
            y = (y[0].clone(), y[1])
            y[0][0] = y[0][0].flip(0)             # one slot's block of audio, reversed
        return state, y, aux
    monkeypatch.setattr(channelized.ChannelizedBank, "_raw_step", step)


def _one_segment_from_a_wrong_state(monkeypatch):
    """A listener's framer started afresh mid-stream, as a joiner's is: its
    next header says (0, 0) where the encoder carried on from its state,
    so one 200-sample segment decodes from the wrong state."""
    def hooks(drv):
        complete = drv.rt._complete_block
        calls = {"n": 0}

        def wrapped(pending):
            calls["n"] += 1
            if calls["n"] == 6:
                from openwebrx_tpu_torch.ops.adpcm import SyncFramer
                for h in drv.handles.values():
                    h.framer = SyncFramer()
            complete(pending)
        drv.rt._complete_block = wrapped
    return hooks


@pytest.mark.parametrize("fault", [_frozen_state, _half_batch, _altered_answer,
                                   _one_segment_from_a_wrong_state])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    r = _run(root, hooks=fault(monkeypatch))
    assert not r["correct"], r["checks"]
    assert r["checks"]["audio_wrong_per_block"]["value"] > check.LIMITS["audio_wrong_per_block"]


def _swapped_slots(monkeypatch):
    """One retune that also swaps the retuned listener's slot with another
    listener's of its bank, behind the other's back: from then on each
    hears the other's dial."""
    from openwebrx_tpu_torch.runtime import device
    set_offset = device.ChannelHandle.set_offset
    swapped = []

    def wrong(self, offset_hz):
        set_offset(self, offset_hz)
        other = next((h for h in self.runtime.handles if h is not self
                      and h.bucket_key == self.bucket_key and h.slot is not None), None)
        if other is not None and not swapped:
            self.slot, other.slot = other.slot, self.slot
            swapped.append(self)
    monkeypatch.setattr(device.ChannelHandle, "set_offset", wrong)
    return swapped


def test_a_misrouted_listener_is_not_correct(root, monkeypatch):
    """The benchmark reads a listener's slot after each call on that listener:
    the swap shows as two listeners on one slot."""
    swapped = _swapped_slots(monkeypatch)
    r = _run(root)
    assert swapped
    assert not r["correct"], r["checks"]
    assert r["checks"]["misrouted"]["value"] >= 1
