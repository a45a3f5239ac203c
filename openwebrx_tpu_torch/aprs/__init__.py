"""APRS stack: KISS deframing, AX.25 parsing, APRS position decoding.

Reference: ``owrx/aprs/`` (950 LoC) — the packet chain is
FM demod → direwolf (external) → KISS TCP → AX.25 deframe → APRS parse →
map.  direwolf stays an external binary (``direwolf.py`` builds its config
and speaks KISS over its TCP port); the protocol parsing here is a fresh
implementation of the public AX.25/APRS specs covering plain, compressed
and Mic-E position formats plus weather fields.
"""

from openwebrx_tpu_torch.aprs.kiss import KissDeframer
from openwebrx_tpu_torch.aprs.ax25 import parse_ax25_frame
from openwebrx_tpu_torch.aprs.parser import AprsParser

__all__ = ["KissDeframer", "parse_ax25_frame", "AprsParser"]
