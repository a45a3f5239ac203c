"""AX.25 UI-frame parsing (reference ``owrx/aprs/__init__.py:50-80``).

Addresses are 7-octet fields (callsign shifted left 1 bit + SSID octet);
the header is destination, source, then up to 8 digipeater path entries
until an octet with the extension bit set; control 0x03 + PID 0xF0 marks
a UI frame carrying the APRS information field.
"""

from __future__ import annotations


def _decode_address(field: bytes, mark_visited: bool = False) -> str:
    call = bytes(b >> 1 for b in field[:6]).decode("ascii", "replace").strip()
    ssid = (field[6] >> 1) & 0x0F
    visited = "*" if mark_visited and (field[6] & 0x80) else ""
    return f"{call}-{ssid}{visited}" if ssid else f"{call}{visited}"


def parse_ax25_frame(frame: bytes) -> dict | None:
    """frame (without flags/FCS) → {source, destination, path, data}."""
    if len(frame) < 16:
        return None
    # walk the address field: last address octet has the extension bit set
    end = 7
    while end < len(frame) and not frame[end - 1] & 0x01:
        end += 7
        if end > 7 * 10:
            return None
    if end + 2 > len(frame):
        return None
    addresses = [frame[i: i + 7] for i in range(0, end, 7)]
    control, pid = frame[end], frame[end + 1]
    return {
        "destination": _decode_address(addresses[0]),
        "source": _decode_address(addresses[1]),
        "path": [_decode_address(a, True) for a in addresses[2:]],
        "control": control,
        "pid": pid,
        "data": frame[end + 2:],
        "raw": frame.hex().upper(),
    }
