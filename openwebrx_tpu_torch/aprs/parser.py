"""APRS information-field parsing (reference ``owrx/aprs/__init__.py``).

Implements the public APRS spec subset the reference handles: plain and
timestamped positions (with/without messaging), compressed positions,
Mic-E encoded positions, objects, status, messages, and the basic weather
field group.  Output dicts feed the map (lat/lon/symbol/comment).
"""

from __future__ import annotations

import re


def _parse_plain_coords(body: str) -> dict | None:
    # DDMM.mmN S DDDMM.mmE S with symbol table/code around them
    if len(body) < 19:
        return None
    try:
        lat_deg = int(body[0:2])
        lat_min = float(body[2:7])
        ns = body[7]
        sym_table = body[8]
        lon_deg = int(body[9:12])
        lon_min = float(body[12:17])
        ew = body[17]
        sym = body[18]
    except (ValueError, IndexError):
        return None
    if ns not in "NS" or ew not in "EW":
        return None
    lat = lat_deg + lat_min / 60
    lon = lon_deg + lon_min / 60
    if ns == "S":
        lat = -lat
    if ew == "W":
        lon = -lon
    return {"lat": lat, "lon": lon, "symboltable": sym_table, "symbol": sym,
            "comment": body[19:].strip()}


def _parse_compressed(body: str) -> dict | None:
    if len(body) < 13:
        return None
    sym_table = body[0]
    try:
        y = [ord(c) - 33 for c in body[1:5]]
        x = [ord(c) - 33 for c in body[5:9]]
    except TypeError:
        return None
    if any(v < 0 or v > 90 for v in y + x):
        return None
    lat = 90 - (((y[0] * 91 + y[1]) * 91 + y[2]) * 91 + y[3]) / 380926
    lon = -180 + (((x[0] * 91 + x[1]) * 91 + x[2]) * 91 + x[3]) / 190463
    return {"lat": lat, "lon": lon, "symboltable": sym_table,
            "symbol": body[9], "comment": body[12:].strip()}


_WX_FIELDS = [("g", "gustspeed", 3), ("t", "temperature", 3),
              ("r", "rainhour", 3), ("p", "rainday", 3), ("P", "rainmidnight", 3),
              ("h", "humidity", 2), ("b", "barometricpressure", 5)]


def _parse_weather(comment: str) -> tuple[dict, str]:
    wx = {}
    m = re.match(r"^(\d{3}|\.{3})/(\d{3}|\.{3})", comment)
    if m:
        if m.group(1) != "...":
            wx["winddirection"] = int(m.group(1))
        if m.group(2) != "...":
            wx["windspeed"] = int(m.group(2))
        comment = comment[7:]
    while comment:
        for char, key, length in _WX_FIELDS:
            if comment.startswith(char):
                chunk = comment[1: 1 + length]
                if chunk.replace(".", "").replace("-", "").isdigit():
                    try:
                        wx[key] = int(chunk)
                    except ValueError:
                        pass
                    comment = comment[1 + length:]
                    break
        else:
            break
    if wx.get("temperature") is not None:
        wx["temperature"] = (wx["temperature"] - 32) / 1.8  # °F → °C
    return wx, comment


_MICE_LAT = {
    # dest char → (digit, message bit, n/s or e/w / lon offset)
    **{chr(ord("0") + i): (str(i), 0, "S") for i in range(10)},
    **{chr(ord("A") + i): (str(i), 1, None) for i in range(10)},
    **{chr(ord("P") + i): (str(i), 1, "N") for i in range(10)},
    "K": (" ", 1, None), "L": (" ", 0, "S"), "Z": (" ", 1, "N"),
}


def _parse_mice(destination: str, data: bytes) -> dict | None:
    dest = destination.split("-")[0].ljust(6)
    if len(data) < 9:
        return None
    digits, ns_flags = "", []
    for ch in dest[:6]:
        entry = _MICE_LAT.get(ch)
        if entry is None:
            return None
        digits += entry[0]
        ns_flags.append(entry[2])
    try:
        lat = int(digits[0:2].replace(" ", "0")) + \
            float(digits[2:4] + "." + digits[4:6].replace(" ", "0")) / 60
    except ValueError:
        return None
    if ns_flags[3] != "N":
        lat = -lat
    lon_offset = 100 if ns_flags[4] == "N" else 0
    lon_deg = data[1] - 28 + lon_offset
    if 180 <= lon_deg <= 189:
        lon_deg -= 80
    elif 190 <= lon_deg <= 199:
        lon_deg -= 190
    lon_min = data[2] - 28
    if lon_min >= 60:
        lon_min -= 60
    lon_hun = data[3] - 28
    lon = lon_deg + (lon_min + lon_hun / 100) / 60
    if ns_flags[5] == "N":  # west
        lon = -lon
    speed = ((data[4] - 28) * 10) + (data[5] - 28) // 10
    if speed >= 800:
        speed -= 800
    course = ((data[5] - 28) % 10) * 100 + (data[6] - 28)
    if course >= 400:
        course -= 400
    return {
        "lat": lat, "lon": lon,
        "symbol": chr(data[7]), "symboltable": chr(data[8]),
        "speed": speed * 1.852, "course": course,
        "comment": data[9:].decode("ascii", "replace").strip(),
        "type": "Mic-E",
    }


def parse_tnc2(line: str) -> dict | None:
    """Parse a TNC2-format monitor string ``SRC>DEST,PATH:body`` into the
    frame dict ``AprsParser.parse`` accepts.  D-Star DPRS payloads and
    third-party traffic arrive in this textual form (reference:
    owrx/meta.py:188-209 feeding DPRS through the APRS parser)."""
    head, sep, body = line.partition(":")
    if not sep or ">" not in head:
        return None
    source, _, rest = head.partition(">")
    parts = rest.split(",")
    return {
        "source": source.strip(),
        "destination": parts[0].strip(),
        "path": [p.strip() for p in parts[1:]],
        "data": body.encode("ascii", "replace"),
    }


class AprsParser:
    """Parse an AX.25 UI frame dict into an APRS event dict."""

    def parse(self, frame: dict) -> dict | None:
        data = frame.get("data", b"")
        if not data:
            return None
        out = {
            "source": frame.get("source", ""),
            "destination": frame.get("destination", ""),
            "path": frame.get("path", []),
        }
        dti = chr(data[0])
        body = data[1:].decode("ascii", "replace")
        if dti in ("!", "="):
            pos = self._position(body)
        elif dti in ("/", "@"):
            pos = self._position(body[7:]) if len(body) > 7 else None
            if pos is not None:
                out["timestamp"] = body[:7]
        elif dti in ("`", "'", "\x1c", "\x1d"):
            pos = _parse_mice(frame.get("destination", ""), data[1:])
        elif dti == ";" and len(body) > 27:  # object
            out["object"] = body[:9].strip()
            pos = self._position(body[17:])
        elif dti == ">":
            out["type"] = "status"
            out["comment"] = body
            return out
        elif dti == ":":
            m = re.match(r"^([A-Za-z0-9 -]{9}):(.*)$", body)
            if m:
                out["type"] = "message"
                out["adressee"] = m.group(1).strip()
                out["message"] = m.group(2)
            return out
        else:
            out["type"] = "raw"
            out["comment"] = body
            return out
        if pos is None:
            return None
        out.update(pos)
        out.setdefault("type", "position")
        if out.get("symbol") == "_":
            wx, comment = _parse_weather(out.get("comment", ""))
            if wx:
                out["weather"] = wx
                out["comment"] = comment
        return out

    def _position(self, body: str) -> dict | None:
        if body and body[0].isdigit():
            return _parse_plain_coords(body)
        return _parse_compressed(body)
