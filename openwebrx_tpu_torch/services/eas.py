"""EAS SAME header decoding → human-readable alert text.

Behavioral equivalent of the reference's vendored dsame3
(``owrx/dsame3/dsame.py:278`` ``same_decode_string`` +
``owrx/dsame3/defs.py`` tables), built from the SAME specification
(47 CFR 11.31 / NWSI 10-1712) rather than ported: originator + event
code tables, FIPS state/marine-area names, part-of-county divisions,
purge-time arithmetic, and the message renderer.

County names: the full US (3913-entry) and Canadian (1513-entry) SAME
location tables ship as a gzipped data pack
(``data/same_counties.txt.gz`` — public US Census FIPS / Environment
Canada SGC data, restructured from the same public tables the
reference's vendored dsame3 carries, owrx/dsame3/defs.py US_SAME_CODE /
CA_SAME_CODE).  A deployment can still override with a CSV
(``eas_fips_path`` config: lines ``SSCCC,County Name``); unknown codes
fall back to "area CCC of <State>".
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone

# originator codes (47 CFR 11.31(d))
ORIGINATORS = {
    "PEP": ("United States Government", "the"),
    "CIV": ("Civil authorities", ""),
    "WXR": ("National Weather Service", "the"),
    "EAS": ("Broadcast station or cable system", "a"),
    "EAN": ("Emergency Action Notification Network", "the"),
}

# event codes: current + proposed set (47 CFR 11.31(e) and NWS additions)
EVENTS = {
    "ADR": "Administrative Message",
    "AVA": "Avalanche Watch",
    "AVW": "Avalanche Warning",
    "BHW": "Biological Hazard Warning",
    "BWW": "Boil Water Warning",
    "BZW": "Blizzard Warning",
    "CAE": "Child Abduction Emergency",
    "CDW": "Civil Danger Warning",
    "CEM": "Civil Emergency Message",
    "CFA": "Coastal Flood Watch",
    "CFW": "Coastal Flood Warning",
    "CHW": "Chemical Hazard Warning",
    "CWW": "Contaminated Water Warning",
    "DBA": "Dam Watch",
    "DBW": "Dam Break Warning",
    "DEW": "Contagious Disease Warning",
    "DMO": "Practice/Demo Warning",
    "DSW": "Dust Storm Warning",
    "EAN": "Emergency Action Notification",
    "EAT": "Emergency Action Termination",
    "EQW": "Earthquake Warning",
    "EVA": "Evacuation Watch",
    "EVI": "Evacuation Immediate",
    "EWW": "Extreme Wind Warning",
    "FCW": "Food Contamination Warning",
    "FFA": "Flash Flood Watch",
    "FFS": "Flash Flood Statement",
    "FFW": "Flash Flood Warning",
    "FLA": "Flood Watch",
    "FLS": "Flood Statement",
    "FLW": "Flood Warning",
    "FRW": "Fire Warning",
    "FSW": "Flash Freeze Warning",
    "FZW": "Freeze Warning",
    "HLS": "Hurricane Local Statement",
    "HMW": "Hazardous Materials Warning",
    "HUA": "Hurricane Watch",
    "HUW": "Hurricane Warning",
    "HWA": "High Wind Watch",
    "HWW": "High Wind Warning",
    "IBW": "Iceberg Warning",
    "IFW": "Industrial Fire Warning",
    "LAE": "Local Area Emergency",
    "LEW": "Law Enforcement Warning",
    "LSW": "Land Slide Warning",
    "NAT": "National Audible Test",
    "NIC": "National Information Center",
    "NMN": "Network Message Notification",
    "NPT": "National Periodic Test",
    "NST": "National Silent Test",
    "NUW": "Nuclear Power Plant Warning",
    "POS": "Power Outage Statement",
    "RHW": "Radiological Hazard Warning",
    "RMT": "Required Monthly Test",
    "RWT": "Required Weekly Test",
    "SMW": "Special Marine Warning",
    "SPS": "Special Weather Statement",
    "SPW": "Shelter in Place Warning",
    "SSA": "Storm Surge Watch",
    "SSW": "Storm Surge Warning",
    "SVA": "Severe Thunderstorm Watch",
    "SVR": "Severe Thunderstorm Warning",
    "SVS": "Severe Weather Statement",
    "TOA": "Tornado Watch",
    "TOE": "911 Telephone Outage Emergency",
    "TOR": "Tornado Warning",
    "TRA": "Tropical Storm Watch",
    "TRW": "Tropical Storm Warning",
    "TSA": "Tsunami Watch",
    "TSW": "Tsunami Warning",
    "VOW": "Volcano Warning",
    "WFA": "Wild Fire Watch",
    "WFW": "Wild Fire Warning",
    "WSA": "Winter Storm Watch",
    "WSW": "Winter Storm Warning",
}

# FIPS state codes (SS of PSSCCC) + SAME marine areas (NWSI 10-1712)
STATES = {
    1: "Alabama", 2: "Alaska", 4: "Arizona", 5: "Arkansas",
    6: "California", 8: "Colorado", 9: "Connecticut", 10: "Delaware",
    11: "District of Columbia", 12: "Florida", 13: "Georgia", 15: "Hawaii",
    16: "Idaho", 17: "Illinois", 18: "Indiana", 19: "Iowa", 20: "Kansas",
    21: "Kentucky", 22: "Louisiana", 23: "Maine", 24: "Maryland",
    25: "Massachusetts", 26: "Michigan", 27: "Minnesota", 28: "Mississippi",
    29: "Missouri", 30: "Montana", 31: "Nebraska", 32: "Nevada",
    33: "New Hampshire", 34: "New Jersey", 35: "New Mexico", 36: "New York",
    37: "North Carolina", 38: "North Dakota", 39: "Ohio", 40: "Oklahoma",
    41: "Oregon", 42: "Pennsylvania", 44: "Rhode Island",
    45: "South Carolina", 46: "South Dakota", 47: "Tennessee", 48: "Texas",
    49: "Utah", 50: "Vermont", 51: "Virginia", 53: "Washington",
    54: "West Virginia", 55: "Wisconsin", 56: "Wyoming",
    60: "American Samoa", 66: "Guam", 69: "Northern Mariana Islands",
    72: "Puerto Rico", 78: "U.S. Virgin Islands",
    # marine SAME areas
    57: "Eastern North Pacific Ocean",
    58: "North Pacific Ocean near Alaska",
    59: "Central Pacific Ocean",
    61: "South Central Pacific Ocean",
    65: "Western Pacific Ocean",
    73: "Western North Atlantic Ocean",
    75: "Gulf of Mexico",
    77: "Lake Okeechobee",
    91: "Lake Superior",
    92: "Lake Michigan",
    93: "Lake Huron",
    94: "Saint Clair River, Detroit River and Lake Saint Clair",
    96: "Lake Erie",
    97: "Niagara River and Lake Ontario",
    98: "Saint Lawrence River",
}

# part-of-county prefix P of PSSCCC (47 CFR 11.31(f))
DIVISIONS = {
    0: "", 1: "northwest", 2: "north", 3: "northeast", 4: "west",
    5: "central", 6: "east", 7: "southwest", 8: "south", 9: "southeast",
}

HEADER_RE = re.compile(
    r"ZCZC-(?P<org>\w{3})-(?P<eee>\w{3})"
    r"(?P<areas>(?:-\d{6})+)\+(?P<tttt>\d{4})"
    r"-(?P<jjjhhmm>\d{7})-(?P<sender>[\w./ ]+?)-?$")


_BUILTIN_DB: dict[str, dict[str, str]] = {}


def builtin_county_db(country: str = "US") -> dict[str, str]:
    """Built-in SAME location names from the gzipped data pack (lazy;
    ~120 KB decompressed).  Keys are the 5-digit SSCCC; the cache is
    keyed per country (US / CA ship in the pack)."""
    db = _BUILTIN_DB.get(country)
    if db is None:
        import gzip
        import os
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "data", "same_counties.txt.gz")
        db = {}
        try:
            with gzip.open(path, "rt", encoding="utf-8") as f:
                for line in f:
                    cc, ss, rest = line.rstrip("\n").split(" ", 2)
                    if cc != country:
                        continue
                    for item in rest.split("|"):
                        ccc, name = item.split(":", 1)
                        db[ss + ccc] = name
        except OSError:
            pass
        _BUILTIN_DB[country] = db
    return db


def load_county_db(path: str) -> dict[str, str]:
    """Optional county-name CSV: lines ``SSCCC,County Name``."""
    db = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "," not in line:
                continue
            code, name = line.split(",", 1)
            code = code.strip()
            if code.isdigit() and len(code) == 5:
                db[code] = name.strip()
    return db


def decode_area(psscc: str, county_db: dict[str, str] | None = None) -> dict:
    """One PSSCCC location → {part, state, county, text}."""
    part = DIVISIONS.get(int(psscc[0]), "")
    ss = int(psscc[1:3])
    ccc = int(psscc[3:6])
    state = STATES.get(ss, f"region {ss}")
    if ccc == 0:
        county = None
        text = f"all of {state}"
    else:
        county = (county_db or builtin_county_db()).get(psscc[1:6])
        base = county if county else f"area {ccc} of {state}"
        if county:
            base = f"{county}, {state}"
        text = f"{part} {base}".strip()
    return {"code": psscc, "part": part, "state": state,
            "county": county, "text": text}


def _alert_times(jjjhhmm: str, tttt: str, now: datetime | None = None):
    """SAME issue time (UTC day-of-year JJJHHMM) + purge TTTT (HHMM)."""
    now = now or datetime.now(timezone.utc)
    jjj = int(jjjhhmm[:3])
    hh, mm = int(jjjhhmm[3:5]), int(jjjhhmm[5:7])
    year = now.year
    # day-of-year near a year boundary: pick the year whose day is closest
    def mk(y):
        return (datetime(y, 1, 1, tzinfo=timezone.utc)
                + timedelta(days=jjj - 1, hours=hh, minutes=mm))
    start = min((mk(year - 1), mk(year), mk(year + 1)),
                key=lambda d: abs((d - now).total_seconds()))
    duration = timedelta(hours=int(tttt[:2]), minutes=int(tttt[2:]))
    return start, start + duration, duration


def severity_of(eee: str) -> str:
    # national activations outrank the name-suffix heuristic: EAN/EAT are
    # the highest-priority events, CEM is emergency-class (47 CFR 11.31)
    if eee in ("EAN", "EAT", "CEM"):
        return "emergency"
    name = EVENTS.get(eee, "")
    for word in ("Warning", "Watch", "Emergency", "Statement"):
        if name.endswith(word):
            return word.lower()
    if eee in ("RWT", "RMT", "DMO", "NPT", "NAT", "NST"):
        return "test"
    return "advisory"


def decode_same(header: str, county_db: dict[str, str] | None = None,
                now: datetime | None = None) -> dict | None:
    """'ZCZC-ORG-EEE-PSSCCC(+...)+TTTT-JJJHHMM-LLLLLLLL-' → alert dict
    with a dsame-style human-readable ``text`` (reference
    ``owrx/dsame3/dsame.py:222`` readable_message)."""
    m = HEADER_RE.search(header.strip())
    if not m:
        return None
    org, eee = m.group("org"), m.group("eee")
    org_name, article = ORIGINATORS.get(org, (f"origin {org}", ""))
    event = EVENTS.get(eee, f"Unknown Event ({eee})")
    areas = [decode_area(a, county_db)
             for a in m.group("areas").strip("-").split("-")]
    start, end, duration = _alert_times(m.group("jjjhhmm"), m.group("tttt"),
                                        now)
    sender = m.group("sender").strip()
    verb = "has issued" if severity_of(eee) in (
        "warning", "watch", "emergency") else "has sent"
    area_text = "; ".join(a["text"] for a in areas)
    fmt = "%I:%M %p UTC on %b %d"
    text = (f"{article.title() + ' ' if article else ''}{org_name} {verb} "
            f"a {event} for {area_text}; beginning at "
            f"{start.strftime(fmt).lstrip('0')} and ending at "
            f"{end.strftime(fmt).lstrip('0')}. Message from {sender}.")
    return {
        "org": org, "org_text": org_name,
        "event_code": eee, "event": event,
        "severity": severity_of(eee),
        "areas": areas,
        "start": start.isoformat(), "end": end.isoformat(),
        "duration_minutes": int(duration.total_seconds() // 60),
        "sender": sender,
        "text": text,
    }
