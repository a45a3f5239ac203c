"""Analog demodulator chains: the SSB chain of this slice.

Counterpart of ``BaseDemodulatorChain`` and ``Ssb`` in
``openwebrx_tpu/models/analog.py``.  AM, FM and sync AM come with a later
slice of the port.
"""

from __future__ import annotations

from openwebrx_tpu_torch.models.stages import AgcStage, GainStage, RealPartStage
from openwebrx_tpu_torch.ops import agc
from openwebrx_tpu_torch.runtime.chain import Chain


class BaseDemodulatorChain(Chain):
    """IF/audio rate policy flags."""

    fixed_if_rate: float | None = None
    fixed_audio_rate: float | None = None

    def get_if_rate(self, audio_rate: float) -> float:
        return self.fixed_if_rate or audio_rate

    def supports_squelch(self) -> bool:
        return True


class Ssb(BaseDemodulatorChain):
    """RealPart → ×2 → SLOW AGC; the Selector's asymmetric bandpass has
    already picked the sideband."""

    def __init__(self, name: str = "ssb"):
        super().__init__([RealPartStage(), GainStage(2.0), AgcStage(agc.SLOW)],
                         name=name)
