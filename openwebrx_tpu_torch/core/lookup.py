"""Callsign and MMSI lookup: country/entity identification.

Reference: ``owrx/lookup.py`` (HamCallsign/MmsiNumber/CountryCode with
~770 expanded prefix entries).  Implemented differently here: the ITU
Table of Allocation of International Call Sign Series (RR Appendix 42)
is stored as RANGES (lo, hi) and expanded to prefix keys at import —
complete coverage of the allocation table in a fraction of the lines,
plus a longest-prefix SPECIAL layer for sub-entity callsigns the table
can't express (HB0 Liechtenstein, OX Greenland, …).  MMSI resolution
implements the ITU MID table + the public MMSI numbering rules.
"""

from __future__ import annotations

# ITU call sign series (lo, hi, iso, name); lo/hi are 3-char bounds.
SERIES = [
    ("AAA", "ALZ", "us", "United States"),
    ("AMA", "AOZ", "es", "Spain"),
    ("APA", "ASZ", "pk", "Pakistan"),
    ("ATA", "AWZ", "in", "India"),
    ("AXA", "AXZ", "au", "Australia"),
    ("AYA", "AZZ", "ar", "Argentina"),
    ("A2A", "A2Z", "bw", "Botswana"),
    ("A3A", "A3Z", "to", "Tonga"),
    ("A4A", "A4Z", "om", "Oman"),
    ("A5A", "A5Z", "bt", "Bhutan"),
    ("A6A", "A6Z", "ae", "United Arab Emirates"),
    ("A7A", "A7Z", "qa", "Qatar"),
    ("A8A", "A8Z", "lr", "Liberia"),
    ("A9A", "A9Z", "bh", "Bahrain"),
    ("BAA", "BZZ", "cn", "China"),
    ("CAA", "CEZ", "cl", "Chile"),
    ("CFA", "CKZ", "ca", "Canada"),
    ("CLA", "CMZ", "cu", "Cuba"),
    ("CNA", "CNZ", "ma", "Morocco"),
    ("COA", "COZ", "cu", "Cuba"),
    ("CPA", "CPZ", "bo", "Bolivia"),
    ("CQA", "CUZ", "pt", "Portugal"),
    ("CVA", "CXZ", "uy", "Uruguay"),
    ("CYA", "CZZ", "ca", "Canada"),
    ("C2A", "C2Z", "nr", "Nauru"),
    ("C3A", "C3Z", "ad", "Andorra"),
    ("C4A", "C4Z", "cy", "Cyprus"),
    ("C5A", "C5Z", "gm", "Gambia"),
    ("C6A", "C6Z", "bs", "Bahamas"),
    ("C8A", "C9Z", "mz", "Mozambique"),
    ("DAA", "DRZ", "de", "Germany"),
    ("DSA", "DTZ", "kr", "South Korea"),
    ("DUA", "DZZ", "ph", "Philippines"),
    ("D2A", "D3Z", "ao", "Angola"),
    ("D4A", "D4Z", "cv", "Cape Verde"),
    ("D5A", "D5Z", "lr", "Liberia"),
    ("D6A", "D6Z", "km", "Comoros"),
    ("D7A", "D9Z", "kr", "South Korea"),
    ("EAA", "EHZ", "es", "Spain"),
    ("EIA", "EJZ", "ie", "Ireland"),
    ("EKA", "EKZ", "am", "Armenia"),
    ("ELA", "ELZ", "lr", "Liberia"),
    ("EMA", "EOZ", "ua", "Ukraine"),
    ("EPA", "EQZ", "ir", "Iran"),
    ("ERA", "ERZ", "md", "Moldova"),
    ("ESA", "ESZ", "ee", "Estonia"),
    ("ETA", "ETZ", "et", "Ethiopia"),
    ("EUA", "EWZ", "by", "Belarus"),
    ("EXA", "EXZ", "kg", "Kyrgyzstan"),
    ("EYA", "EYZ", "tj", "Tajikistan"),
    ("EZA", "EZZ", "tm", "Turkmenistan"),
    ("E2A", "E2Z", "th", "Thailand"),
    ("E3A", "E3Z", "er", "Eritrea"),
    ("E4A", "E4Z", "ps", "Palestine"),
    ("E5A", "E5Z", "ck", "Cook Islands"),
    ("E6A", "E6Z", "nu", "Niue"),
    ("E7A", "E7Z", "ba", "Bosnia and Herzegovina"),
    ("FAA", "FZZ", "fr", "France"),
    ("GAA", "GZZ", "gb", "United Kingdom"),
    ("HAA", "HAZ", "hu", "Hungary"),
    ("HBA", "HBZ", "ch", "Switzerland"),
    ("HCA", "HDZ", "ec", "Ecuador"),
    ("HEA", "HEZ", "ch", "Switzerland"),
    ("HFA", "HFZ", "pl", "Poland"),
    ("HGA", "HGZ", "hu", "Hungary"),
    ("HHA", "HHZ", "ht", "Haiti"),
    ("HIA", "HIZ", "do", "Dominican Republic"),
    ("HJA", "HKZ", "co", "Colombia"),
    ("HLA", "HLZ", "kr", "South Korea"),
    ("HMA", "HMZ", "kp", "North Korea"),
    ("HNA", "HNZ", "iq", "Iraq"),
    ("HOA", "HPZ", "pa", "Panama"),
    ("HQA", "HRZ", "hn", "Honduras"),
    ("HSA", "HSZ", "th", "Thailand"),
    ("HTA", "HTZ", "ni", "Nicaragua"),
    ("HUA", "HUZ", "sv", "El Salvador"),
    ("HVA", "HVZ", "va", "Vatican City"),
    ("HWA", "HYZ", "fr", "France"),
    ("HZA", "HZZ", "sa", "Saudi Arabia"),
    ("H2A", "H2Z", "cy", "Cyprus"),
    ("H3A", "H3Z", "pa", "Panama"),
    ("H4A", "H4Z", "sb", "Solomon Islands"),
    ("H6A", "H7Z", "ni", "Nicaragua"),
    ("H8A", "H9Z", "pa", "Panama"),
    ("IAA", "IZZ", "it", "Italy"),
    ("JAA", "JSZ", "jp", "Japan"),
    ("JTA", "JVZ", "mn", "Mongolia"),
    ("JWA", "JXZ", "no", "Norway"),
    ("JYA", "JYZ", "jo", "Jordan"),
    ("JZA", "JZZ", "id", "Indonesia"),
    ("J2A", "J2Z", "dj", "Djibouti"),
    ("J3A", "J3Z", "gd", "Grenada"),
    ("J4A", "J4Z", "gr", "Greece"),
    ("J5A", "J5Z", "gw", "Guinea-Bissau"),
    ("J6A", "J6Z", "lc", "Saint Lucia"),
    ("J7A", "J7Z", "dm", "Dominica"),
    ("J8A", "J8Z", "vc", "Saint Vincent and the Grenadines"),
    ("KAA", "KZZ", "us", "United States"),
    ("LAA", "LNZ", "no", "Norway"),
    ("LOA", "LWZ", "ar", "Argentina"),
    ("LXA", "LXZ", "lu", "Luxembourg"),
    ("LYA", "LYZ", "lt", "Lithuania"),
    ("LZA", "LZZ", "bg", "Bulgaria"),
    ("L2A", "L9Z", "ar", "Argentina"),
    ("MAA", "MZZ", "gb", "United Kingdom"),
    ("NAA", "NZZ", "us", "United States"),
    ("OAA", "OCZ", "pe", "Peru"),
    ("ODA", "ODZ", "lb", "Lebanon"),
    ("OEA", "OEZ", "at", "Austria"),
    ("OFA", "OJZ", "fi", "Finland"),
    ("OKA", "OLZ", "cz", "Czechia"),
    ("OMA", "OMZ", "sk", "Slovakia"),
    ("ONA", "OTZ", "be", "Belgium"),
    ("OUA", "OZZ", "dk", "Denmark"),
    ("PAA", "PIZ", "nl", "Netherlands"),
    ("PJA", "PJZ", "cw", "Curaçao and Caribbean Netherlands"),
    ("PKA", "POZ", "id", "Indonesia"),
    ("PPA", "PYZ", "br", "Brazil"),
    ("PZA", "PZZ", "sr", "Suriname"),
    ("P2A", "P2Z", "pg", "Papua New Guinea"),
    ("P3A", "P3Z", "cy", "Cyprus"),
    ("P4A", "P4Z", "aw", "Aruba"),
    ("P5A", "P9Z", "kp", "North Korea"),
    ("RAA", "RZZ", "ru", "Russia"),
    ("SAA", "SMZ", "se", "Sweden"),
    ("SNA", "SRZ", "pl", "Poland"),
    ("SSA", "SSM", "eg", "Egypt"),
    ("SSN", "STZ", "sd", "Sudan"),
    ("SUA", "SUZ", "eg", "Egypt"),
    ("SVA", "SZZ", "gr", "Greece"),
    ("S2A", "S3Z", "bd", "Bangladesh"),
    ("S5A", "S5Z", "si", "Slovenia"),
    ("S6A", "S6Z", "sg", "Singapore"),
    ("S7A", "S7Z", "sc", "Seychelles"),
    ("S8A", "S8Z", "za", "South Africa"),
    ("S9A", "S9Z", "st", "São Tomé and Príncipe"),
    ("TAA", "TCZ", "tr", "Turkey"),
    ("TDA", "TDZ", "gt", "Guatemala"),
    ("TEA", "TEZ", "cr", "Costa Rica"),
    ("TFA", "TFZ", "is", "Iceland"),
    ("TGA", "TGZ", "gt", "Guatemala"),
    ("THA", "THZ", "fr", "France"),
    ("TIA", "TIZ", "cr", "Costa Rica"),
    ("TJA", "TJZ", "cm", "Cameroon"),
    ("TKA", "TKZ", "fr", "France (Corsica)"),
    ("TLA", "TLZ", "cf", "Central African Republic"),
    ("TMA", "TMZ", "fr", "France"),
    ("TNA", "TNZ", "cg", "Congo"),
    ("TOA", "TQZ", "fr", "France"),
    ("TRA", "TRZ", "ga", "Gabon"),
    ("TSA", "TSZ", "tn", "Tunisia"),
    ("TTA", "TTZ", "td", "Chad"),
    ("TUA", "TUZ", "ci", "Côte d'Ivoire"),
    ("TVA", "TXZ", "fr", "France"),
    ("TYA", "TYZ", "bj", "Benin"),
    ("TZA", "TZZ", "ml", "Mali"),
    ("T2A", "T2Z", "tv", "Tuvalu"),
    ("T3A", "T3Z", "ki", "Kiribati"),
    ("T4A", "T4Z", "cu", "Cuba"),
    ("T5A", "T5Z", "so", "Somalia"),
    ("T6A", "T6Z", "af", "Afghanistan"),
    ("T7A", "T7Z", "sm", "San Marino"),
    ("T8A", "T8Z", "pw", "Palau"),
    ("UAA", "UIZ", "ru", "Russia"),
    ("UJA", "UMZ", "uz", "Uzbekistan"),
    ("UNA", "UQZ", "kz", "Kazakhstan"),
    ("URA", "UZZ", "ua", "Ukraine"),
    ("VAA", "VGZ", "ca", "Canada"),
    ("VHA", "VNZ", "au", "Australia"),
    ("VOA", "VOZ", "ca", "Canada"),
    ("VPA", "VSZ", "gb", "United Kingdom (overseas territories)"),
    ("VTA", "VWZ", "in", "India"),
    ("VXA", "VYZ", "ca", "Canada"),
    ("VZA", "VZZ", "au", "Australia"),
    ("V2A", "V2Z", "ag", "Antigua and Barbuda"),
    ("V3A", "V3Z", "bz", "Belize"),
    ("V4A", "V4Z", "kn", "Saint Kitts and Nevis"),
    ("V5A", "V5Z", "na", "Namibia"),
    ("V6A", "V6Z", "fm", "Micronesia"),
    ("V7A", "V7Z", "mh", "Marshall Islands"),
    ("V8A", "V8Z", "bn", "Brunei"),
    ("WAA", "WZZ", "us", "United States"),
    ("XAA", "XIZ", "mx", "Mexico"),
    ("XJA", "XOZ", "ca", "Canada"),
    ("XPA", "XPZ", "dk", "Denmark"),
    ("XQA", "XRZ", "cl", "Chile"),
    ("XSA", "XSZ", "cn", "China"),
    ("XTA", "XTZ", "bf", "Burkina Faso"),
    ("XUA", "XUZ", "kh", "Cambodia"),
    ("XVA", "XVZ", "vn", "Vietnam"),
    ("XWA", "XWZ", "la", "Laos"),
    ("XXA", "XXZ", "mo", "Macao"),
    ("XYA", "XZZ", "mm", "Myanmar"),
    ("YAA", "YAZ", "af", "Afghanistan"),
    ("YBA", "YHZ", "id", "Indonesia"),
    ("YIA", "YIZ", "iq", "Iraq"),
    ("YJA", "YJZ", "vu", "Vanuatu"),
    ("YKA", "YKZ", "sy", "Syria"),
    ("YLA", "YLZ", "lv", "Latvia"),
    ("YMA", "YMZ", "tr", "Turkey"),
    ("YNA", "YNZ", "ni", "Nicaragua"),
    ("YOA", "YRZ", "ro", "Romania"),
    ("YSA", "YSZ", "sv", "El Salvador"),
    ("YTA", "YUZ", "rs", "Serbia"),
    ("YVA", "YYZ", "ve", "Venezuela"),
    ("Y2A", "Y9Z", "de", "Germany"),
    ("ZAA", "ZAZ", "al", "Albania"),
    ("ZBA", "ZJZ", "gb", "United Kingdom (overseas territories)"),
    ("ZKA", "ZMZ", "nz", "New Zealand"),
    ("ZNA", "ZOZ", "gb", "United Kingdom (overseas territories)"),
    ("ZPA", "ZPZ", "py", "Paraguay"),
    ("ZQA", "ZQZ", "gb", "United Kingdom (overseas territories)"),
    ("ZRA", "ZUZ", "za", "South Africa"),
    ("ZVA", "ZZZ", "br", "Brazil"),
    ("Z2A", "Z2Z", "zw", "Zimbabwe"),
    ("Z3A", "Z3Z", "mk", "North Macedonia"),
    ("Z8A", "Z8Z", "ss", "South Sudan"),
    ("2AA", "2ZZ", "gb", "United Kingdom"),
    ("3AA", "3AZ", "mc", "Monaco"),
    ("3BA", "3BZ", "mu", "Mauritius"),
    ("3CA", "3CZ", "gq", "Equatorial Guinea"),
    ("3DA", "3DM", "sz", "Eswatini"),
    ("3DN", "3DZ", "fj", "Fiji"),
    ("3EA", "3FZ", "pa", "Panama"),
    ("3GA", "3GZ", "cl", "Chile"),
    ("3HA", "3UZ", "cn", "China"),
    ("3VA", "3VZ", "tn", "Tunisia"),
    ("3WA", "3WZ", "vn", "Vietnam"),
    ("3XA", "3XZ", "gn", "Guinea"),
    ("3YA", "3YZ", "no", "Norway"),
    ("3ZA", "3ZZ", "pl", "Poland"),
    ("4AA", "4CZ", "mx", "Mexico"),
    ("4DA", "4IZ", "ph", "Philippines"),
    ("4JA", "4KZ", "az", "Azerbaijan"),
    ("4LA", "4LZ", "ge", "Georgia"),
    ("4MA", "4MZ", "ve", "Venezuela"),
    ("4OA", "4OZ", "me", "Montenegro"),
    ("4PA", "4SZ", "lk", "Sri Lanka"),
    ("4TA", "4TZ", "pe", "Peru"),
    ("4UA", "4UZ", None, "United Nations"),
    ("4VA", "4VZ", "ht", "Haiti"),
    ("4WA", "4WZ", "tl", "Timor-Leste"),
    ("4XA", "4XZ", "il", "Israel"),
    ("4YA", "4YZ", None, "ICAO"),
    ("4ZA", "4ZZ", "il", "Israel"),
    ("5AA", "5AZ", "ly", "Libya"),
    ("5BA", "5BZ", "cy", "Cyprus"),
    ("5CA", "5GZ", "ma", "Morocco"),
    ("5HA", "5IZ", "tz", "Tanzania"),
    ("5JA", "5KZ", "co", "Colombia"),
    ("5LA", "5MZ", "lr", "Liberia"),
    ("5NA", "5OZ", "ng", "Nigeria"),
    ("5PA", "5QZ", "dk", "Denmark"),
    ("5RA", "5SZ", "mg", "Madagascar"),
    ("5TA", "5TZ", "mr", "Mauritania"),
    ("5UA", "5UZ", "ne", "Niger"),
    ("5VA", "5VZ", "tg", "Togo"),
    ("5WA", "5WZ", "ws", "Samoa"),
    ("5XA", "5XZ", "ug", "Uganda"),
    ("5YA", "5ZZ", "ke", "Kenya"),
    ("6AA", "6BZ", "eg", "Egypt"),
    ("6CA", "6CZ", "sy", "Syria"),
    ("6DA", "6JZ", "mx", "Mexico"),
    ("6KA", "6NZ", "kr", "South Korea"),
    ("6OA", "6OZ", "so", "Somalia"),
    ("6PA", "6SZ", "pk", "Pakistan"),
    ("6TA", "6UZ", "sd", "Sudan"),
    ("6VA", "6WZ", "sn", "Senegal"),
    ("6XA", "6XZ", "mg", "Madagascar"),
    ("6YA", "6YZ", "jm", "Jamaica"),
    ("6ZA", "6ZZ", "lr", "Liberia"),
    ("7AA", "7IZ", "id", "Indonesia"),
    ("7JA", "7NZ", "jp", "Japan"),
    ("7OA", "7OZ", "ye", "Yemen"),
    ("7PA", "7PZ", "ls", "Lesotho"),
    ("7QA", "7QZ", "mw", "Malawi"),
    ("7RA", "7RZ", "dz", "Algeria"),
    ("7SA", "7SZ", "se", "Sweden"),
    ("7TA", "7YZ", "dz", "Algeria"),
    ("7ZA", "7ZZ", "sa", "Saudi Arabia"),
    ("8AA", "8IZ", "id", "Indonesia"),
    ("8JA", "8NZ", "jp", "Japan"),
    ("8OA", "8OZ", "bw", "Botswana"),
    ("8PA", "8PZ", "bb", "Barbados"),
    ("8QA", "8QZ", "mv", "Maldives"),
    ("8RA", "8RZ", "gy", "Guyana"),
    ("8SA", "8SZ", "se", "Sweden"),
    ("8TA", "8YZ", "in", "India"),
    ("8ZA", "8ZZ", "sa", "Saudi Arabia"),
    ("9AA", "9AZ", "hr", "Croatia"),
    ("9BA", "9DZ", "ir", "Iran"),
    ("9EA", "9FZ", "et", "Ethiopia"),
    ("9GA", "9GZ", "gh", "Ghana"),
    ("9HA", "9HZ", "mt", "Malta"),
    ("9IA", "9JZ", "zm", "Zambia"),
    ("9KA", "9KZ", "kw", "Kuwait"),
    ("9LA", "9LZ", "sl", "Sierra Leone"),
    ("9MA", "9MZ", "my", "Malaysia"),
    ("9NA", "9NZ", "np", "Nepal"),
    ("9OA", "9TZ", "cd", "Democratic Republic of the Congo"),
    ("9UA", "9UZ", "bi", "Burundi"),
    ("9VA", "9VZ", "sg", "Singapore"),
    ("9WA", "9WZ", "my", "Malaysia"),
    ("9XA", "9XZ", "rw", "Rwanda"),
    ("9YA", "9ZZ", "tt", "Trinidad and Tobago"),
]

# Sub-entities / non-ITU prefixes the series table can't express:
# longest-prefix override layer, checked FIRST.
SPECIAL = {
    "1A": (None, "Sovereign Military Order of Malta"),
    "1S": (None, "Principality of Sealand"),
    "3D2": ("fj", "Fiji"),      # issued series uses a digit: 3D2xx
    "HB0": ("li", "Liechtenstein"),
    "HB3Y": ("li", "Liechtenstein"),
    "OX": ("gl", "Greenland"),
    "OY": ("fo", "Faroe Islands"),
    "OH0": ("ax", "Åland Islands"),
    "OJ0": ("ax", "Market Reef"),
    "JW": ("sj", "Svalbard"),
    "JX": ("sj", "Jan Mayen"),
    "TK": ("fr", "Corsica"),
    "ZB": ("gi", "Gibraltar"),
    "ZC4": ("cy", "UK Sovereign Base Areas on Cyprus"),
    "ZD7": ("sh", "Saint Helena"),
    "ZD8": ("ac", "Ascension Island"),
    "ZD9": ("sh", "Tristan da Cunha"),
    "ZF": ("ky", "Cayman Islands"),
    "ZK3": ("tk", "Tokelau"),
    "ZL7": ("nz", "Chatham Islands"),
    "VP2E": ("ai", "Anguilla"),
    "VP2M": ("ms", "Montserrat"),
    "VP2V": ("vg", "British Virgin Islands"),
    "VP5": ("tc", "Turks and Caicos Islands"),
    "VP6": ("pn", "Pitcairn Islands"),
    "VP8": ("fk", "Falkland Islands"),
    "VP9": ("bm", "Bermuda"),
    "VQ9": ("io", "Chagos Islands"),
    "VK9": ("au", "Australian external territories"),
    "VK0": ("aq", "Heard Island / Macquarie Island"),
    "CY0": ("ca", "Sable Island"),
    "CE0": ("cl", "Easter Island / Juan Fernández"),
    "KL": ("us", "Alaska"),
    "KH6": ("us", "Hawaii"),
    "KH2": ("gu", "Guam"),
    "KP4": ("pr", "Puerto Rico"),
    "KP2": ("vi", "U.S. Virgin Islands"),
    "FO": ("pf", "French Polynesia"),
    "FK": ("nc", "New Caledonia"),
    "FG": ("gp", "Guadeloupe"),
    "FM": ("mq", "Martinique"),
    "FP": ("pm", "Saint Pierre and Miquelon"),
    "FR": ("re", "Réunion"),
    "FH": ("yt", "Mayotte"),
    "FY": ("gf", "French Guiana"),
    "FW": ("wf", "Wallis and Futuna"),
    "FT": ("tf", "French Southern Territories"),
}

_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _expand():
    """SERIES ranges → {2-char prefix} and {3-char prefix} maps, plus
    {1-char} for letters whose whole series belongs to one entity."""
    by2, by3 = {}, {}
    for lo, hi, code, name in SERIES:
        c0 = lo[0]
        assert hi[0] == c0, (lo, hi)
        s_lo, s_hi = lo[1], hi[1]
        # the second character ranges over letters OR digits (digit-ranged
        # series like L2A–L9Z / Y2A–Y9Z are common in the ITU table)
        seq = _LETTERS if s_lo in _LETTERS else "0123456789"
        for s in seq[seq.index(s_lo):seq.index(s_hi) + 1]:
            t_lo = lo[2] if s == s_lo else "A"
            t_hi = hi[2] if s == s_hi else "Z"
            if t_lo == "A" and t_hi == "Z":
                by2[c0 + s] = (code, name)
            else:
                for t in _LETTERS[_LETTERS.index(t_lo):
                                  _LETTERS.index(t_hi) + 1]:
                    by3[c0 + s + t] = (code, name)
    by1 = {}
    for c in _LETTERS:
        entities = {by2.get(c + s) for s in _LETTERS}
        if len(entities) == 1 and None not in entities:
            by1[c] = entities.pop()
    return by1, by2, by3


_BY1, _BY2, _BY3 = _expand()


class HamCallsign:
    @staticmethod
    def get_country(callsign: str):
        """→ (iso_code or None, country name) or None.  Longest-prefix:
        SPECIAL overrides, then 3/2/1-char ITU series."""
        call = callsign.upper().split("/")[0].strip("*").strip()
        if not call:
            return None
        for n in range(min(4, len(call)), 1, -1):
            hit = SPECIAL.get(call[:n])
            if hit:
                return hit
        hit = _BY3.get(call[:3]) or _BY2.get(call[:2]) or _BY1.get(call[:1])
        return hit

    @staticmethod
    def get_country_code(callsign: str):
        hit = HamCallsign.get_country(callsign)
        return hit[0] if hit else None

    @staticmethod
    def get_country_name(callsign: str):
        hit = HamCallsign.get_country(callsign)
        return hit[1] if hit else None


class CountryCode:
    _MAP = None

    @staticmethod
    def get_country(ccode: str):
        if CountryCode._MAP is None:
            CountryCode._MAP = {}
            for _, _, code, name in SERIES:
                if code and code not in CountryCode._MAP:
                    CountryCode._MAP[code] = name.split(" (")[0]
        return CountryCode._MAP.get(ccode.lower())

    _BY_NAME = None

    # MID display names absent from the ITU SERIES table (territories with
    # their own maritime identity but no amateur prefix entry) → ISO code
    _NAME_ALIASES = {
        "adélie land": "tf", "alaska": "us", "american samoa": "as",
        "anguilla": "ai", "ascension island": "sh", "azores": "pt",
        "bermuda": "bm", "british virgin islands": "vg",
        "cayman islands": "ky", "christmas island": "cx",
        "cocos (keeling) islands": "cc", "crozet archipelago": "tf",
        "curaçao": "cw", "falkland islands": "fk", "faroe islands": "fo",
        "french guiana": "gf", "french polynesia": "pf", "gibraltar": "gi",
        "greenland": "gl", "guadeloupe": "gp", "hong kong": "hk",
        "kerguelen islands": "tf", "liechtenstein": "li", "madeira": "pt",
        "martinique": "mq", "montserrat": "ms", "new caledonia": "nc",
        "northern mariana islands": "mp", "pitcairn islands": "pn",
        "puerto rico": "pr", "réunion": "re", "saint helena": "sh",
        "saint paul and amsterdam islands": "tf",
        "saint pierre and miquelon": "pm", "taiwan": "tw",
        "turks and caicos islands": "tc", "u.s. virgin islands": "vi",
        "wallis and futuna": "wf",
    }

    @staticmethod
    def from_name(country: str):
        """Country display name → ISO code (for flag rendering of entities
        whose tables store names, e.g. the MMSI MID table)."""
        if CountryCode._BY_NAME is None:
            CountryCode.get_country("us")        # populate _MAP
            CountryCode._BY_NAME = {
                name.lower(): code for code, name in CountryCode._MAP.items()}
            CountryCode._BY_NAME.update(CountryCode._NAME_ALIASES)
        key = country.split(" (")[0].lower()
        return CountryCode._BY_NAME.get(key) \
            or CountryCode._BY_NAME.get(country.lower())


# ITU Maritime Identification Digits (Table 1 of ITU-R M.585 allocation)
MID = {
    201: "Albania", 202: "Andorra", 203: "Austria", 204: "Azores",
    205: "Belgium", 206: "Belarus", 207: "Bulgaria", 208: "Vatican City",
    209: "Cyprus", 210: "Cyprus", 211: "Germany", 212: "Cyprus",
    213: "Georgia", 214: "Moldova", 215: "Malta", 216: "Armenia",
    218: "Germany", 219: "Denmark", 220: "Denmark", 224: "Spain",
    225: "Spain", 226: "France", 227: "France", 228: "France",
    229: "Malta", 230: "Finland", 231: "Faroe Islands",
    232: "United Kingdom", 233: "United Kingdom", 234: "United Kingdom",
    235: "United Kingdom", 236: "Gibraltar", 237: "Greece", 238: "Croatia",
    239: "Greece", 240: "Greece", 241: "Greece", 242: "Morocco",
    243: "Hungary", 244: "Netherlands", 245: "Netherlands",
    246: "Netherlands", 247: "Italy", 248: "Malta", 249: "Malta",
    250: "Ireland", 251: "Iceland", 252: "Liechtenstein", 253: "Luxembourg",
    254: "Monaco", 255: "Madeira", 256: "Malta", 257: "Norway",
    258: "Norway", 259: "Norway", 261: "Poland", 262: "Montenegro",
    263: "Portugal", 264: "Romania", 265: "Sweden", 266: "Sweden",
    267: "Slovakia", 268: "San Marino", 269: "Switzerland", 270: "Czechia",
    271: "Turkey", 272: "Ukraine", 273: "Russia", 274: "North Macedonia",
    275: "Latvia", 276: "Estonia", 277: "Lithuania", 278: "Slovenia",
    279: "Serbia",
    301: "Anguilla", 303: "Alaska (USA)", 304: "Antigua and Barbuda",
    305: "Antigua and Barbuda", 306: "Curaçao", 307: "Aruba",
    308: "Bahamas", 309: "Bahamas", 310: "Bermuda", 311: "Bahamas",
    312: "Belize", 314: "Barbados", 316: "Canada", 319: "Cayman Islands",
    321: "Costa Rica", 323: "Cuba", 325: "Dominica",
    327: "Dominican Republic", 329: "Guadeloupe", 330: "Grenada",
    331: "Greenland", 332: "Guatemala", 334: "Honduras", 336: "Haiti",
    338: "United States", 339: "Jamaica", 341: "Saint Kitts and Nevis",
    343: "Saint Lucia", 345: "Mexico", 347: "Martinique", 348: "Montserrat",
    350: "Nicaragua", 351: "Panama", 352: "Panama", 353: "Panama",
    354: "Panama", 355: "Panama", 356: "Panama", 357: "Panama",
    358: "Puerto Rico", 359: "El Salvador",
    361: "Saint Pierre and Miquelon", 362: "Trinidad and Tobago",
    364: "Turks and Caicos Islands", 366: "United States",
    367: "United States", 368: "United States", 369: "United States",
    370: "Panama", 371: "Panama", 372: "Panama", 373: "Panama",
    374: "Panama", 375: "Saint Vincent and the Grenadines",
    376: "Saint Vincent and the Grenadines",
    377: "Saint Vincent and the Grenadines", 378: "British Virgin Islands",
    379: "U.S. Virgin Islands",
    401: "Afghanistan", 403: "Saudi Arabia", 405: "Bangladesh",
    408: "Bahrain", 410: "Bhutan", 412: "China", 413: "China",
    414: "China", 416: "Taiwan", 417: "Sri Lanka", 419: "India",
    422: "Iran", 423: "Azerbaijan", 425: "Iraq", 428: "Israel",
    431: "Japan", 432: "Japan", 434: "Turkmenistan", 436: "Kazakhstan",
    437: "Uzbekistan", 438: "Jordan", 440: "South Korea",
    441: "South Korea", 443: "Palestine", 445: "North Korea",
    447: "Kuwait", 450: "Lebanon", 451: "Kyrgyzstan", 453: "Macao",
    455: "Maldives", 457: "Mongolia", 459: "Nepal", 461: "Oman",
    463: "Pakistan", 466: "Qatar", 468: "Syria",
    470: "United Arab Emirates", 471: "United Arab Emirates",
    472: "Tajikistan", 473: "Yemen", 475: "Yemen", 477: "Hong Kong",
    478: "Bosnia and Herzegovina",
    501: "Adélie Land", 503: "Australia", 506: "Myanmar", 508: "Brunei",
    510: "Micronesia", 511: "Palau", 512: "New Zealand", 514: "Cambodia",
    515: "Cambodia", 516: "Christmas Island", 518: "Cook Islands",
    520: "Fiji", 523: "Cocos (Keeling) Islands", 525: "Indonesia",
    529: "Kiribati", 531: "Laos", 533: "Malaysia",
    536: "Northern Mariana Islands", 538: "Marshall Islands",
    540: "New Caledonia", 542: "Niue", 544: "Nauru",
    546: "French Polynesia", 548: "Philippines", 553: "Papua New Guinea",
    555: "Pitcairn Islands", 557: "Solomon Islands", 559: "American Samoa",
    561: "Samoa", 563: "Singapore", 564: "Singapore", 565: "Singapore",
    566: "Singapore", 567: "Thailand", 570: "Tonga", 572: "Tuvalu",
    574: "Vietnam", 576: "Vanuatu", 577: "Vanuatu",
    578: "Wallis and Futuna",
    601: "South Africa", 603: "Angola", 605: "Algeria",
    607: "Saint Paul and Amsterdam Islands", 608: "Ascension Island",
    609: "Burundi", 610: "Benin", 611: "Botswana",
    612: "Central African Republic", 613: "Cameroon", 615: "Congo",
    616: "Comoros", 617: "Cape Verde", 618: "Crozet Archipelago",
    619: "Côte d'Ivoire", 620: "Comoros", 621: "Djibouti", 622: "Egypt",
    624: "Ethiopia", 625: "Eritrea", 626: "Gabon", 627: "Ghana",
    629: "Gambia", 630: "Guinea-Bissau", 631: "Equatorial Guinea",
    632: "Guinea", 633: "Burkina Faso", 634: "Kenya",
    635: "Kerguelen Islands", 636: "Liberia", 637: "Liberia",
    638: "South Sudan", 642: "Libya", 644: "Lesotho", 645: "Mauritius",
    647: "Madagascar", 649: "Mali", 650: "Mozambique", 654: "Mauritania",
    655: "Malawi", 656: "Niger", 657: "Nigeria", 659: "Namibia",
    660: "Réunion", 661: "Rwanda", 662: "Sudan", 663: "Senegal",
    664: "Seychelles", 665: "Saint Helena", 666: "Somalia",
    667: "Sierra Leone", 668: "São Tomé and Príncipe", 669: "Eswatini",
    670: "Chad", 671: "Togo", 672: "Tunisia", 674: "Tanzania",
    675: "Uganda", 676: "Democratic Republic of the Congo",
    677: "Tanzania", 678: "Zambia", 679: "Zimbabwe",
    701: "Argentina", 710: "Brazil", 720: "Bolivia", 725: "Chile",
    730: "Colombia", 735: "Ecuador", 740: "Falkland Islands",
    745: "French Guiana", 750: "Guyana", 755: "Paraguay", 760: "Peru",
    765: "Suriname", 770: "Uruguay", 775: "Venezuela",
}


class MmsiNumber:
    @staticmethod
    def parse(mmsi: str) -> dict:
        """MMSI → {type, country} per the ITU-R M.585 numbering rules."""
        mmsi = mmsi.strip()
        out = {"mmsi": mmsi}
        if not mmsi.isdigit() or len(mmsi) != 9:
            out["type"] = "invalid"
            return out
        if mmsi.startswith("970"):
            # digits 4-6 are a manufacturer ID (ITU-R M.585), not a MID
            out["type"] = "AIS SART"
            mid = None
        elif mmsi.startswith("972"):
            out["type"] = "man overboard device"
            mid = None
        elif mmsi.startswith("974"):
            out["type"] = "EPIRB-AIS"
            mid = None
        elif mmsi.startswith("00"):
            out["type"] = "coast station"
            mid = int(mmsi[2:5])
        elif mmsi.startswith("0"):
            out["type"] = "group"
            mid = int(mmsi[1:4])
        elif mmsi.startswith("111"):
            out["type"] = "SAR aircraft"
            mid = int(mmsi[3:6])
        elif mmsi.startswith("98"):
            out["type"] = "craft associated with parent ship"
            mid = int(mmsi[2:5])
        elif mmsi.startswith("99"):
            out["type"] = "aid to navigation"
            mid = int(mmsi[2:5])
        else:
            out["type"] = "ship"
            mid = int(mmsi[0:3])
        country = MID.get(mid) if mid else None
        if country:
            out["country"] = country
        return out
