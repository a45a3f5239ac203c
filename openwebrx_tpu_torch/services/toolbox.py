"""Text-mode decoder parsers: paging (POCSAG/FLEX), ISM, RDS, SELCALL.

Reference: ``owrx/toolbox.py`` (411 LoC) — parsers for multimon-ng,
rtl_433 and redsea output, turned into client messages / map updates.
These attach to SubprocessPipeline instances fed by the TPU demod chains.
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__name__)


class PageParser:
    """multimon-ng POCSAG/FLEX lines → message dicts (reference PageParser,
    owrx/toolbox.py:150; FLEX fragment reassembly included).

    POCSAG512: Address: 1234567  Function: 0  Alpha:   message text
    FLEX|...|1600/2/K/A|09.064|002577600|ALN|message   (multimon flex_next)
    """

    _POCSAG = re.compile(
        r"^(POCSAG\d+): Address: *(\d+) +Function: *(\d)(?: +(Alpha|Numeric):\s*(.*))?$")
    _FLEX = re.compile(
        r"^FLEX[:|][^|]*\|(\d+/\d+/?\S*)\|(\d+\.\d+)\|(\d+)\|(\w+)\|(.*)$")

    def __init__(self, on_message):
        self.on_message = on_message
        self._flex_fragments: dict[str, str] = {}

    def parse(self, line: bytes):
        text = line.decode(errors="replace").strip()
        m = self._POCSAG.match(text)
        if m:
            out = {"mode": "POCSAG", "protocol": m.group(1),
                   "address": int(m.group(2)), "function": int(m.group(3))}
            if m.group(4):
                out["type"] = m.group(4).lower()
                out["message"] = (m.group(5) or "").strip("<>")
            self.on_message(out)
            return
        m = self._FLEX.match(text)
        if m:
            capcode = m.group(3)
            mtype = m.group(4)
            body = m.group(5)
            # fragment reassembly: 'F' continuation flags in the state field
            if body.endswith("+"):  # continued
                self._flex_fragments[capcode] = \
                    self._flex_fragments.get(capcode, "") + body[:-1]
                return
            full = self._flex_fragments.pop(capcode, "") + body
            self.on_message({"mode": "FLEX", "address": int(capcode),
                             "type": mtype.lower(), "message": full.strip()})


class SelCallParser:
    """multimon-ng selective-call tones (ZVEI/EEA/CCIR; reference
    SelCallParser): 'ZVEI1: 12345' style lines."""

    _RE = re.compile(r"^(ZVEI[123]?|EEA|EIA|CCIR): (.*)$")

    def __init__(self, on_message):
        self.on_message = on_message

    def parse(self, line: bytes):
        m = self._RE.match(line.decode(errors="replace").strip())
        if m:
            self.on_message({"mode": "SELCALL", "protocol": m.group(1),
                             "code": m.group(2).strip()})


class IsmParser:
    """rtl_433 JSON events (reference IsmParser, owrx/toolbox.py:122)."""

    def __init__(self, on_message):
        self.on_message = on_message

    def parse(self, event: dict):
        out = {"mode": "ISM"}
        out.update(event)
        self.on_message(out)


class RdsParser:
    """redsea JSON output → WFM metadata (reference RdsParser,
    owrx/toolbox.py:88): accumulates PI/PS/RT across groups."""

    def __init__(self, on_meta):
        self.on_meta = on_meta
        self.state: dict = {}

    RESET_KEYS = {"pi"}

    def parse(self, event: dict):
        if "pi" in event and event.get("pi") != self.state.get("pi"):
            self.state = {}  # station change resets accumulated metadata
        for key in ("pi", "ps", "radiotext", "prog_type", "callsign",
                    "clock_time", "partial_ps"):
            if key in event:
                self.state[key] = event[key]
        self.on_meta({"mode": "RDS", **self.state})


class EasParser:
    """EAS SAME headers (reference EasParser + vendored dsame3,
    owrx/toolbox.py:336, owrx/dsame3/dsame.py:278): raw 'ZCZC-...'
    headers decoded to human-readable alert text (services/eas.py)."""

    _RE = re.compile(r"(ZCZC-\w{3}-\w{3}(?:-\d{6})+\+\d{4}-\d{7}-[^-]+-)")

    def __init__(self, on_message):
        self.on_message = on_message
        self._county_db = None
        path = None
        country = "US"
        try:
            from openwebrx_tpu_torch.core.config import Config
            path = Config.get().get("eas_fips_path")
            country = Config.get().get("eas_country", "US")
        except Exception:
            pass
        try:
            from openwebrx_tpu_torch.services.eas import (
                builtin_county_db, load_county_db,
            )
            if path:
                # deployment-provided CSV overrides the shipped pack
                self._county_db = load_county_db(path)
            else:
                # full shipped SAME tables (US default, CA via
                # eas_country; data/same_counties.txt.gz)
                self._county_db = builtin_county_db(country)
        except OSError:
            pass

    def parse(self, line: bytes):
        from openwebrx_tpu_torch.services.eas import decode_same
        text = line.decode(errors="replace")
        m = self._RE.search(text)
        if m:
            msg = {"mode": "EAS", "raw": m.group(1)}
            decoded = decode_same(m.group(1), self._county_db)
            if decoded:
                msg.update(decoded)
            self.on_message(msg)
        elif "NNNN" in text:
            self.on_message({"mode": "EAS", "eom": True})
