"""ICAO 24-bit address → registration (tail number) + country.

Reference surface: ``owrx/icao.py:1-534``.  The country table is the
public ICAO Annex 10 Vol III Chapter 9 appendix allocation data; the
registration patterns (US N-numbers, Japan JA, South Korea HL, and the
stride/numeric block allocations several countries use) are publicly
reverse-engineered (the dump1090/readsb lineage).  Everything here is
data-driven: compact range tuples plus four small pattern decoders.
"""

from __future__ import annotations

from bisect import bisect_right

# 24 letters, I/O excluded (used by US/JA suffixes)
_LIM = "ABCDEFGHJKLMNPQRSTUVWXYZ"
_FULL = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _suffix2(offset: int) -> str:
    """0 → "", 1.. → A..Z, AA..ZZ over the limited alphabet."""
    if offset <= 0:
        return ""
    offset -= 1
    hi, lo = divmod(offset, 25)
    return _LIM[hi] + ("" if lo == 0 else _LIM[lo - 1])


def _us_n(icao: int) -> str | None:
    """US N-number allocation: nested digit blocks with letter suffixes."""
    offset = icao - 0xA00001
    if not 0 <= offset < 915399:
        return None
    reg = "N"
    for block, letters in ((101711, True), (10111, True), (951, True)):
        digit, offset = divmod(offset, block)
        reg += str(digit + (1 if reg == "N" else 0))
        if offset <= 600:
            return reg + _suffix2(offset)
        offset -= 601
    digit, offset = divmod(offset, 35)
    reg += str(digit)
    if offset <= 24:
        return reg + ("" if offset == 0 else _LIM[offset - 1])
    return reg + str(offset - 25)


def _ja(icao: int) -> str | None:
    """Japan JA: two digits, then digits or paired letters."""
    offset = icao - 0x840000
    if not 0 <= offset < 229840:
        return None
    reg = "JA"
    d1, offset = divmod(offset, 22984)
    d2, offset = divmod(offset, 916)
    if d1 > 9 or d2 > 9:
        return None
    reg += str(d1) + str(d2)
    if offset >= 340:
        offset -= 340
        hi, lo = divmod(offset, 24)
        if hi >= 24:
            return None
        return reg + _LIM[hi] + _LIM[lo]
    d3, offset = divmod(offset, 34)
    reg += str(d3)
    return reg + (str(offset) if offset < 10 else _LIM[offset - 10])


def _hl(icao: int) -> str | None:
    """South Korea HL: hex-coded numeric blocks."""
    for start, base, span in ((0x71BA00, 0x7200, 0x599),
                              (0x71C000, 0x8000, 0x99),
                              (0x71C200, 0x8200, 0x99)):
        if start <= icao <= start + span:
            return "HL" + format(icao - start + base, "x")
    return None


# Numeric blocks: (start hexid, first number, count, template)
_NUMERIC = (
    (0x140000, 0, 100000, "RA-00000"),
    (0x0B03E8, 1000, 1000, "CU-T0000"),
)

# Three-letter stride blocks: (start, major stride, minor stride, prefix,
# first suffix or None, last suffix or None, limited_alphabet?)
_STRIDES = (
    (0x380000, 1024, 32, "F-B", None, None),
    (0x388000, 1024, 32, "F-I", None, None),
    (0x390000, 1024, 32, "F-G", None, None),
    (0x398000, 1024, 32, "F-H", None, None),
    (0x3A0000, 1024, 32, "F-O", None, None),
    (0x3C4421, 1024, 32, "D-A", "AAA", "OZZ"),
    (0x3C0001, 676, 26, "D-A", "PAA", "ZZZ"),
    (0x3C8421, 1024, 32, "D-B", "AAA", "OZZ"),
    (0x3C2001, 676, 26, "D-B", "PAA", "ZZZ"),
    (0x3CC000, 676, 26, "D-C", None, None),
    (0x3D04A8, 676, 26, "D-E", None, None),
    (0x3D4950, 676, 26, "D-F", None, None),
    (0x3D8DF8, 676, 26, "D-G", None, None),
    (0x3DD2A0, 676, 26, "D-H", None, None),
    (0x3E1748, 676, 26, "D-I", None, None),
    (0x448421, 1024, 32, "OO-", None, None),
    (0x458421, 1024, 32, "OY-", None, None),
    (0x460000, 676, 26, "OH-", None, None),
    (0x468421, 1024, 32, "SX-", None, None),
    (0x490421, 1024, 32, "CS-", None, None),
    (0x4A0421, 1024, 32, "YR-", None, None),
    (0x4B8421, 1024, 32, "TC-", None, None),
    (0x740421, 1024, 32, "JY-", None, None),
    (0x760421, 1024, 32, "AP-", None, None),
    (0x768421, 1024, 32, "9V-", None, None),
    (0x778421, 1024, 32, "YK-", None, None),
    (0xC00001, 676, 26, "C-F", None, None),
    (0xC044A9, 676, 26, "C-G", None, None),
    (0xE01041, 4096, 64, "LV-", None, None),
)


def _stride(icao: int) -> str | None:
    for start, s1, s2, prefix, first, last in _STRIDES:
        al = _FULL
        def val(sfx):
            return al.index(sfx[0]) * s1 + al.index(sfx[1]) * s2 + al.index(sfx[2])
        off0 = val(first) if first else 0
        end = start - off0 + (val(last) if last
                              else (len(al) - 1) * (s1 + s2 + 1))
        if not start <= icao <= end:
            continue
        offset = icao - start + off0
        x1, rem = divmod(offset, s1)
        x2, x3 = divmod(rem, s2)
        if max(x1, x2, x3) < len(al):
            return prefix + al[x1] + al[x2] + al[x3]
        return None
    return None


def _numeric(icao: int) -> str | None:
    for start, first, count, template in _NUMERIC:
        if start <= icao < start + count:
            num = str(icao - start + first)
            return template[: len(template) - len(num)] + num
    return None


def registration(icao: int) -> str | None:
    """Tail number for a 24-bit ICAO address, if the allocation pattern of
    its country is known."""
    for decode in (_us_n, _ja, _hl, _numeric, _stride):
        result = decode(icao)
        if result is not None:
            return result
    return None


# ICAO Annex 10 Vol III Ch. 9 appendix allocation ranges (public data):
# (start, end, ISO country code, country name), sorted by start
COUNTRY_RANGES = (
    (0x004000, 0x0043FF, "ZW", "Zimbabwe"),
    (0x006000, 0x006FFF, "MZ", "Mozambique"),
    (0x008000, 0x00FFFF, "ZA", "South Africa"),
    (0x010000, 0x017FFF, "EG", "Egypt"),
    (0x018000, 0x01FFFF, "LY", "Libya"),
    (0x020000, 0x027FFF, "MA", "Morocco"),
    (0x028000, 0x02FFFF, "TN", "Tunisia"),
    (0x030000, 0x0303FF, "BW", "Botswana"),
    (0x032000, 0x032FFF, "BI", "Burundi"),
    (0x034000, 0x034FFF, "CM", "Cameroon"),
    (0x035000, 0x0353FF, "KM", "Comoros"),
    (0x036000, 0x036FFF, "CD", "DR Congo"),
    (0x038000, 0x038FFF, "CI", "Cote d'Ivoire"),
    (0x03E000, 0x03EFFF, "GA", "Gabon"),
    (0x040000, 0x040FFF, "ET", "Ethiopia"),
    (0x042000, 0x042FFF, "GQ", "Equatorial Guinea"),
    (0x044000, 0x044FFF, "GH", "Ghana"),
    (0x046000, 0x046FFF, "GN", "Guinea"),
    (0x048000, 0x0483FF, "GW", "Guinea-Bissau"),
    (0x04A000, 0x04A3FF, "LS", "Lesotho"),
    (0x04C000, 0x04CFFF, "KE", "Kenya"),
    (0x050000, 0x050FFF, "LR", "Liberia"),
    (0x054000, 0x054FFF, "MG", "Madagascar"),
    (0x058000, 0x058FFF, "MW", "Malawi"),
    (0x05A000, 0x05A3FF, "MV", "Maldives"),
    (0x05C000, 0x05CFFF, "ML", "Mali"),
    (0x05E000, 0x05E3FF, "MR", "Mauritania"),
    (0x060000, 0x0603FF, "MU", "Mauritius"),
    (0x062000, 0x062FFF, "NE", "Niger"),
    (0x064000, 0x064FFF, "NG", "Nigeria"),
    (0x068000, 0x068FFF, "UG", "Uganda"),
    (0x06A000, 0x06A3FF, "QA", "Qatar"),
    (0x06C000, 0x06CFFF, "CF", "Central African Republic"),
    (0x06E000, 0x06EFFF, "RW", "Rwanda"),
    (0x070000, 0x070FFF, "SN", "Senegal"),
    (0x074000, 0x0743FF, "SC", "Seychelles"),
    (0x076000, 0x0763FF, "SL", "Sierra Leone"),
    (0x078000, 0x078FFF, "SO", "Somalia"),
    (0x07A000, 0x07A3FF, "SZ", "Eswatini"),
    (0x07C000, 0x07CFFF, "SD", "Sudan"),
    (0x080000, 0x080FFF, "TZ", "Tanzania"),
    (0x084000, 0x084FFF, "TD", "Chad"),
    (0x088000, 0x088FFF, "TG", "Togo"),
    (0x08A000, 0x08AFFF, "ZM", "Zambia"),
    (0x08C000, 0x08CFFF, "CG", "Congo"),
    (0x090000, 0x090FFF, "AO", "Angola"),
    (0x094000, 0x0943FF, "BJ", "Benin"),
    (0x096000, 0x0963FF, "CV", "Cabo Verde"),
    (0x098000, 0x0983FF, "DJ", "Djibouti"),
    (0x09A000, 0x09AFFF, "GM", "Gambia"),
    (0x09C000, 0x09CFFF, "BF", "Burkina Faso"),
    (0x09E000, 0x09E3FF, "ST", "Sao Tome and Principe"),
    (0x0A0000, 0x0A7FFF, "DZ", "Algeria"),
    (0x0A8000, 0x0A8FFF, "BS", "Bahamas"),
    (0x0AA000, 0x0AA3FF, "BB", "Barbados"),
    (0x0AB000, 0x0AB3FF, "BZ", "Belize"),
    (0x0AC000, 0x0ACFFF, "CO", "Colombia"),
    (0x0AE000, 0x0AEFFF, "CR", "Costa Rica"),
    (0x0B0000, 0x0B0FFF, "CU", "Cuba"),
    (0x0B2000, 0x0B2FFF, "SV", "El Salvador"),
    (0x0B4000, 0x0B4FFF, "GT", "Guatemala"),
    (0x0B6000, 0x0B6FFF, "GY", "Guyana"),
    (0x0B8000, 0x0B8FFF, "HT", "Haiti"),
    (0x0BA000, 0x0BAFFF, "HN", "Honduras"),
    (0x0BC000, 0x0BC3FF, "VC", "Saint Vincent and Grenadines"),
    (0x0BE000, 0x0BEFFF, "JM", "Jamaica"),
    (0x0C0000, 0x0C0FFF, "NI", "Nicaragua"),
    (0x0C2000, 0x0C2FFF, "PA", "Panama"),
    (0x0C4000, 0x0C4FFF, "DO", "Dominican Republic"),
    (0x0C6000, 0x0C6FFF, "TT", "Trinidad and Tobago"),
    (0x0C8000, 0x0C8FFF, "SR", "Suriname"),
    (0x0CA000, 0x0CA3FF, "AG", "Antigua and Barbuda"),
    (0x0CC000, 0x0CC3FF, "GD", "Grenada"),
    (0x0D0000, 0x0D7FFF, "MX", "Mexico"),
    (0x0D8000, 0x0DFFFF, "VE", "Venezuela"),
    (0x100000, 0x1FFFFF, "RU", "Russia"),
    (0x200000, 0x27FFFF, None, "Unassigned (AFI region)"),
    (0x201000, 0x2013FF, "NA", "Namibia"),
    (0x202000, 0x2023FF, "ER", "Eritrea"),
    (0x280000, 0x28FFFF, None, "Unassigned (SAM region)"),
    (0x300000, 0x33FFFF, "IT", "Italy"),
    (0x340000, 0x37FFFF, "ES", "Spain"),
    (0x380000, 0x3BFFFF, "FR", "France"),
    (0x3C0000, 0x3FFFFF, "DE", "Germany"),
    (0x400000, 0x4001BF, "BM", "Bermuda"),
    (0x400000, 0x43FFFF, "GB", "United Kingdom"),
    (0x4001C0, 0x4001FF, "KY", "Cayman Islands"),
    (0x400300, 0x4003FF, "TC", "Turks and Caicos"),
    (0x424135, 0x4241F2, "KY", "Cayman Islands"),
    (0x424200, 0x4246FF, "BM", "Bermuda"),
    (0x424700, 0x424899, "KY", "Cayman Islands"),
    (0x424B00, 0x424BFF, "IM", "Isle of Man"),
    (0x43BE00, 0x43BEFF, "BM", "Bermuda"),
    (0x43E700, 0x43EAFD, "IM", "Isle of Man"),
    (0x43EAFE, 0x43EEFF, "GG", "Guernsey"),
    (0x440000, 0x447FFF, "AT", "Austria"),
    (0x448000, 0x44FFFF, "BE", "Belgium"),
    (0x450000, 0x457FFF, "BG", "Bulgaria"),
    (0x458000, 0x45FFFF, "DK", "Denmark"),
    (0x460000, 0x467FFF, "FI", "Finland"),
    (0x468000, 0x46FFFF, "GR", "Greece"),
    (0x470000, 0x477FFF, "HU", "Hungary"),
    (0x478000, 0x47FFFF, "NO", "Norway"),
    (0x480000, 0x487FFF, "NL", "Netherlands"),
    (0x488000, 0x48FFFF, "PL", "Poland"),
    (0x490000, 0x497FFF, "PT", "Portugal"),
    (0x498000, 0x49FFFF, "CZ", "Czechia"),
    (0x4A0000, 0x4A7FFF, "RO", "Romania"),
    (0x4A8000, 0x4AFFFF, "SE", "Sweden"),
    (0x4B0000, 0x4B7FFF, "CH", "Switzerland"),
    (0x4B8000, 0x4BFFFF, "TR", "Turkey"),
    (0x4C0000, 0x4C7FFF, "RS", "Serbia"),
    (0x4C8000, 0x4C83FF, "CY", "Cyprus"),
    (0x4CA000, 0x4CAFFF, "IE", "Ireland"),
    (0x4CC000, 0x4CCFFF, "IS", "Iceland"),
    (0x4D0000, 0x4D03FF, "LU", "Luxembourg"),
    (0x4D2000, 0x4D2FFF, "MT", "Malta"),
    (0x4D4000, 0x4D43FF, "MC", "Monaco"),
    (0x500000, 0x5003FF, "SM", "San Marino"),
    (0x500000, 0x5FFFFF, None, "Unassigned (EUR / NAT regions)"),
    (0x501000, 0x5013FF, "AL", "Albania"),
    (0x501C00, 0x501FFF, "HR", "Croatia"),
    (0x502C00, 0x502FFF, "LV", "Latvia"),
    (0x503C00, 0x503FFF, "LT", "Lithuania"),
    (0x504C00, 0x504FFF, "MD", "Moldova"),
    (0x505C00, 0x505FFF, "SK", "Slovakia"),
    (0x506C00, 0x506FFF, "SI", "Slovenia"),
    (0x507C00, 0x507FFF, "UZ", "Uzbekistan"),
    (0x508000, 0x50FFFF, "UA", "Ukraine"),
    (0x510000, 0x5103FF, "BY", "Belarus"),
    (0x511000, 0x5113FF, "EE", "Estonia"),
    (0x512000, 0x5123FF, "MK", "Macedonia"),
    (0x513000, 0x5133FF, "BA", "Bosnia and Herzegovina"),
    (0x514000, 0x5143FF, "GE", "Georgia"),
    (0x515000, 0x5153FF, "TJ", "Tajikistan"),
    (0x516000, 0x5163FF, "ME", "Montenegro"),
    (0x600000, 0x6003FF, "AM", "Armenia"),
    (0x600000, 0x67FFFF, None, "Unassigned (MID region)"),
    (0x600800, 0x600BFF, "AZ", "Azerbaijan"),
    (0x601000, 0x6013FF, "KG", "Kyrgyzstan"),
    (0x601800, 0x601BFF, "TM", "Turkmenistan"),
    (0x680000, 0x6803FF, "BT", "Bhutan"),
    (0x680000, 0x6FFFFF, None, "Unassigned (ASIA region)"),
    (0x681000, 0x6813FF, "FM", "Micronesia"),
    (0x682000, 0x6823FF, "MN", "Mongolia"),
    (0x683000, 0x6833FF, "KZ", "Kazakhstan"),
    (0x684000, 0x6843FF, "PW", "Palau"),
    (0x700000, 0x700FFF, "AF", "Afghanistan"),
    (0x702000, 0x702FFF, "BD", "Bangladesh"),
    (0x704000, 0x704FFF, "MM", "Myanmar"),
    (0x706000, 0x706FFF, "KW", "Kuwait"),
    (0x708000, 0x708FFF, "LA", "Laos"),
    (0x70A000, 0x70AFFF, "NP", "Nepal"),
    (0x70C000, 0x70C3FF, "OM", "Oman"),
    (0x70E000, 0x70EFFF, "KH", "Cambodia"),
    (0x710000, 0x717FFF, "SA", "Saudi Arabia"),
    (0x718000, 0x71FFFF, "KR", "South Korea"),
    (0x720000, 0x727FFF, "KP", "North Korea"),
    (0x728000, 0x72FFFF, "IQ", "Iraq"),
    (0x730000, 0x737FFF, "IR", "Iran"),
    (0x738000, 0x73FFFF, "IL", "Israel"),
    (0x740000, 0x747FFF, "JO", "Jordan"),
    (0x748000, 0x74FFFF, "LB", "Lebanon"),
    (0x750000, 0x757FFF, "MY", "Malaysia"),
    (0x758000, 0x75FFFF, "PH", "Philippines"),
    (0x760000, 0x767FFF, "PK", "Pakistan"),
    (0x768000, 0x76FFFF, "SG", "Singapore"),
    (0x770000, 0x777FFF, "LK", "Sri Lanka"),
    (0x778000, 0x77FFFF, "SY", "Syria"),
    (0x780000, 0x7BFFFF, "CN", "China"),
    (0x789000, 0x789FFF, "HK", "Hong Kong"),
    (0x7C0000, 0x7FFFFF, "AU", "Australia"),
    (0x800000, 0x83FFFF, "IN", "India"),
    (0x840000, 0x87FFFF, "JP", "Japan"),
    (0x880000, 0x887FFF, "TH", "Thailand"),
    (0x888000, 0x88FFFF, "VN", "Viet Nam"),
    (0x890000, 0x890FFF, "YE", "Yemen"),
    (0x894000, 0x894FFF, "BH", "Bahrain"),
    (0x895000, 0x8953FF, "BN", "Brunei"),
    (0x896000, 0x896FFF, "AE", "United Arab Emirates"),
    (0x897000, 0x8973FF, "SB", "Solomon Islands"),
    (0x898000, 0x898FFF, "PG", "Papua New Guinea"),
    (0x899000, 0x8993FF, "TW", "Taiwan"),
    (0x8A0000, 0x8A7FFF, "ID", "Indonesia"),
    (0x900000, 0x9003FF, "MH", "Marshall Islands"),
    (0x900000, 0x9FFFFF, None, "Unassigned (NAM / PAC regions)"),
    (0x901000, 0x9013FF, "CK", "Cook Islands"),
    (0x902000, 0x9023FF, "WS", "Samoa"),
    (0xA00000, 0xAFFFFF, "US", "United States"),
    (0xB00000, 0xBFFFFF, None, "Unassigned (reserved for future use)"),
    (0xC00000, 0xC3FFFF, "CA", "Canada"),
    (0xC80000, 0xC87FFF, "NZ", "New Zealand"),
    (0xC88000, 0xC88FFF, "FJ", "Fiji"),
    (0xC8A000, 0xC8A3FF, "NR", "Nauru"),
    (0xC8C000, 0xC8C3FF, "LC", "Saint Lucia"),
    (0xC8D000, 0xC8D3FF, "TO", "Tonga"),
    (0xC8E000, 0xC8E3FF, "KI", "Kiribati"),
    (0xC90000, 0xC903FF, "VU", "Vanuatu"),
    (0xD00000, 0xDFFFFF, None, "Unassigned (reserved for future use)"),
    (0xE00000, 0xE3FFFF, "AR", "Argentina"),
    (0xE40000, 0xE7FFFF, "BR", "Brazil"),
    (0xE80000, 0xE80FFF, "CL", "Chile"),
    (0xE84000, 0xE84FFF, "EC", "Ecuador"),
    (0xE88000, 0xE88FFF, "PY", "Paraguay"),
    (0xE8C000, 0xE8CFFF, "PE", "Peru"),
    (0xE90000, 0xE90FFF, "UY", "Uruguay"),
    (0xE94000, 0xE94FFF, "BO", "Bolivia"),
    (0xEC0000, 0xEFFFFF, None, "Unassigned (CAR region)"),
    (0xF00000, 0xF07FFF, None, "ICAO (temporary)"),
    (0xF00000, 0xFFFFFF, None, "Unassigned (reserved for future use)"),
    (0xF09000, 0xF093FF, None, "ICAO (special use)"),
)

def _disjoint_segments():
    """The Annex 10 table contains broad "Unassigned (…)" super-ranges
    that specific country allocations sit inside; flatten into disjoint
    segments where the SMALLEST covering range wins (most specific)."""
    bounds = sorted({r[0] for r in COUNTRY_RANGES}
                    | {r[1] + 1 for r in COUNTRY_RANGES})
    by_size = sorted(COUNTRY_RANGES, key=lambda r: r[1] - r[0])
    segs = []
    for lo, hi in zip(bounds, bounds[1:]):
        for start, end, code, name in by_size:
            if start <= lo and hi - 1 <= end:
                if segs and segs[-1][2] is code and segs[-1][3] is name \
                        and segs[-1][1] == lo - 1:
                    segs[-1] = (segs[-1][0], hi - 1, code, name)
                else:
                    segs.append((lo, hi - 1, code, name))
                break
    return tuple(segs)


_SEGMENTS = _disjoint_segments()
_STARTS = tuple(s[0] for s in _SEGMENTS)


def country(icao: int) -> tuple[str | None, str] | None:
    """(ISO code, country name) owning a 24-bit address, or None.  The
    code is None for reserved/unassigned blocks that have a description
    but no country."""
    i = bisect_right(_STARTS, icao) - 1
    if i >= 0:
        start, end, code, name = _SEGMENTS[i]
        if start <= icao <= end:
            return code, name
    return None


def enrich(icao_hex: str) -> dict:
    """Decode fields for an aircraft cache entry: {registration?,
    country?, ccode?} from the hex address string."""
    try:
        icao = int(icao_hex, 16)
    except (TypeError, ValueError):
        return {}
    out = {}
    reg = registration(icao)
    if reg is not None:
        out["registration"] = reg
    c = country(icao)
    if c is not None:
        out["ccode"], out["country"] = c
    return out
