"""Typed sample formats for stream edges.

Mirrors the vocabulary of the reference's ``pycsdr.types.Format``
(COMPLEX_FLOAT / FLOAT / SHORT / COMPLEX_SHORT / CHAR; see reference
``csdr/chain/__init__.py`` format negotiation and ``owrx/dsp.py``), but the
on-device representation is always float32/complex64 — integer formats only
exist at the host boundary (network ingest, audio egress).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Format(enum.Enum):
    """Sample format of a stream edge (reference: pycsdr.types.Format)."""

    COMPLEX_FLOAT = "complex_float"   # complex64 on device
    FLOAT = "float"                   # float32
    SHORT = "short"                   # int16 (host boundary only)
    COMPLEX_SHORT = "complex_short"   # interleaved int16 IQ (host boundary)
    CHAR = "char"                     # uint8 bytes (host boundary)

    @property
    def dtype(self):
        return {
            Format.COMPLEX_FLOAT: np.complex64,
            Format.FLOAT: np.float32,
            Format.SHORT: np.int16,
            Format.COMPLEX_SHORT: np.int16,
            Format.CHAR: np.uint8,
        }[self]

    @property
    def sample_size(self) -> int:
        """Bytes per sample (complex short = 2 × int16)."""
        return {
            Format.COMPLEX_FLOAT: 8,
            Format.FLOAT: 4,
            Format.SHORT: 2,
            Format.COMPLEX_SHORT: 4,
            Format.CHAR: 1,
        }[self]

    @property
    def is_complex(self) -> bool:
        return self in (Format.COMPLEX_FLOAT, Format.COMPLEX_SHORT)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Format + sample rate of a stream edge.

    The reference negotiates formats dynamically through the chain
    (``csdr/chain/__init__.py:137-151`` get{In,Out}putFormat); here every
    kernel declares its output spec from its input spec at build time so the
    whole chain's shapes are static under jit.
    """

    format: Format
    rate: float

    def with_rate(self, rate: float) -> "StreamSpec":
        return dataclasses.replace(self, rate=rate)

    def with_format(self, format: Format) -> "StreamSpec":
        return dataclasses.replace(self, format=format)
