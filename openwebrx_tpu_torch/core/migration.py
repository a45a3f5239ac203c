"""Settings migrations: upgrade stored settings.json to the current layout.

Reference: ``owrx/config/migration.py:20-153`` (versions 1→8).  Settings
written by any OpenWebRX version since v1 load cleanly: each step is a
pure dict transformation applied in sequence until ``version`` reaches
CURRENT_VERSION.  Works on plain dicts (the JSON as loaded), before the
values enter the property system.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

CURRENT_VERSION = 8

# waterfall schemes the reference recognizes when collapsing explicit
# color tables back to named themes (migration step 3)
_KNOWN_SCHEMES = {
    "default": [0x000000, 0x0000FF, 0x00FFFF, 0x00FF00, 0xFFFF00, 0xFF0000,
                0xFF00FF, 0xFFFFFF],
}


def _rename(config: dict, old: str, new: str):
    if old in config and new not in config:
        config[new] = config.pop(old)


def _v1(config: dict):
    """GPS pair → dict, level margins pair → dict, wsjt queue renames."""
    gps = config.get("receiver_gps")
    if isinstance(gps, (list, tuple)):
        config["receiver_gps"] = {"lat": gps[0], "lon": gps[1]}
    margin = config.get("waterfall_auto_level_margin")
    if isinstance(margin, (list, tuple)):
        config["waterfall_auto_level_margin"] = {"min": margin[0],
                                                 "max": margin[1]}
    _rename(config, "wsjt_queue_workers", "decoding_queue_workers")
    _rename(config, "wsjt_queue_length", "decoding_queue_length")


def _v2(config: dict):
    """RGBA waterfall colors → RGB."""
    colors = config.get("waterfall_colors")
    if colors and any(v > 0xFFFFFF for v in colors):
        config["waterfall_colors"] = [v >> 8 for v in colors]


def _v3(config: dict):
    """Explicit color tables of known themes → named scheme."""
    if "waterfall_scheme" in config:
        if config["waterfall_scheme"] != "custom":
            config.pop("waterfall_colors", None)
        return
    colors = config.get("waterfall_colors")
    if colors is None:
        return
    for name, table in _KNOWN_SCHEMES.items():
        if list(colors) == table:
            config["waterfall_scheme"] = name
            del config["waterfall_colors"]
            return
    config["waterfall_scheme"] = "custom"


def _replace_waterfall_levels(instance: dict):
    if "waterfall_min_level" in instance and \
            "waterfall_max_level" in instance and \
            "waterfall_levels" not in instance:
        instance["waterfall_levels"] = {
            "min": instance.pop("waterfall_min_level"),
            "max": instance.pop("waterfall_max_level"),
        }


def _v4(config: dict):
    """min/max level keys → waterfall_levels dict, at root, device and
    profile level."""
    _replace_waterfall_levels(config)
    for device in (config.get("sdrs") or {}).values():
        if not isinstance(device, dict):
            continue
        _replace_waterfall_levels(device)
        for profile in (device.get("profiles") or {}).values():
            if isinstance(profile, dict):
                _replace_waterfall_levels(profile)


def _v5(config: dict):
    """frequency_display_precision (digits of MHz) → tuning_precision."""
    if "frequency_display_precision" in config:
        config["tuning_precision"] = \
            6 - config.pop("frequency_display_precision")


def _v6(config: dict):
    """auto-level margin dict → waterfall_auto_levels + min_range."""
    margin = config.pop("waterfall_auto_level_margin", None)
    if isinstance(margin, dict):
        if "min_range" in margin:
            config["waterfall_auto_min_range"] = margin["min_range"]
        config["waterfall_auto_levels"] = {
            k: v for k, v in margin.items() if k in ("min", "max")}


def _v7(config: dict):
    """callsign_url → callsign_service."""
    url = config.pop("callsign_url", None)
    if url:
        if "qrzcq.com" in url:
            config["callsign_service"] = "qrzcq"
        elif "qrz.com" in url:
            config["callsign_service"] = "qrz"
        else:
            logger.warning("could not migrate callsign_url %r", url)


_STEPS = {1: _v1, 2: _v2, 3: _v3, 4: _v4, 5: _v5, 6: _v6, 7: _v7}


def migrate(config: dict) -> dict:
    """In-place upgrade to CURRENT_VERSION; returns the dict."""
    version = int(config.get("version", 1))
    if version > CURRENT_VERSION:
        raise ValueError(f"settings version {version} is newer than "
                         f"supported {CURRENT_VERSION}")
    while version < CURRENT_VERSION:
        logger.debug("migrating settings v%d → v%d", version, version + 1)
        _STEPS[version](config)
        version += 1
        config["version"] = version
    return config
