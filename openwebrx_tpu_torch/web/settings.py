"""Settings + admin API: login, runtime config read/write, SDR management.

Reference: the settings web UI (``owrx/controllers/settings/`` + form
framework, SURVEY §2.1).  Round-1 surface is a JSON API with cookie-
session auth driving the same layered config (changes land in the dynamic
layer and persist through Config.store, firing property subscriptions so
running components reconfigure live); the HTML form generation can grow on
top of it.
"""

from __future__ import annotations

import json
import logging

from openwebrx_tpu_torch.core.config import Config
from openwebrx_tpu_torch.core.users import SessionStorage, UserList
from openwebrx_tpu_torch.web.http import Request, json_response, response

logger = logging.getLogger(__name__)

# keys exposed for editing (reference: general settings sections)
EDITABLE_KEYS = [
    "receiver_name", "receiver_location", "receiver_asl", "receiver_admin",
    "receiver_gps", "photo_title", "photo_desc",
    "fft_fps", "fft_size", "fft_voverlap_factor",
    "audio_compression", "fft_compression",
    "waterfall_scheme", "waterfall_levels", "waterfall_auto_levels",
    "max_clients", "max_clients_per_ip", "allow_chat",
    "allow_audio_recording", "allow_center_freq_changes", "magic_key",
    "tuning_precision", "squelch_auto_margin",
    "services_enabled", "services_decoders",
    "decoding_queue_workers", "decoding_queue_length", "wsjt_decoding_depth",
    "pskreporter_enabled", "pskreporter_callsign",
    "wsprnet_enabled", "wsprnet_callsign",
    "aprs_callsign", "aprs_igate_enabled",
    "keep_files", "session_timeout", "ui_theme", "bot_ban_enabled",
    "tpu_block_seconds", "tpu_channel_capacity",
    "rig_enabled", "rig_model", "rig_device", "rig_address",
    "sdrs",
]


def _session_user(request: Request):
    cookies = request.headers.get("cookie", "")
    for part in cookies.split(";"):
        if "=" in part:
            k, v = part.strip().split("=", 1)
            if k == "owrx-session":
                data = SessionStorage.shared().get(v)
                if data is not None:
                    SessionStorage.shared().prolong(v)
                    return data.get("user")
    return None


def require_auth(handler):
    def wrapped(request: Request):
        if _session_user(request) is None:
            return json_response({"error": "unauthorized"}, status=401)
        return handler(request)
    return wrapped


def login(request: Request):
    try:
        body = json.loads(request.body or b"{}")
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    user = UserList.shared().authenticate(body.get("username", ""),
                                          body.get("password", ""))
    if user is None:
        return json_response({"error": "invalid credentials"}, status=401)
    key = SessionStorage.shared().create({"user": user.name})
    return response(
        200, json.dumps({"ok": True,
                         "must_change_password": user.must_change_password}).encode(),
        "application/json",
        {"Set-Cookie": f"owrx-session={key}; HttpOnly; Path=/"})


def logout(request: Request):
    cookies = request.headers.get("cookie", "")
    for part in cookies.split(";"):
        if part.strip().startswith("owrx-session="):
            SessionStorage.shared().invalidate(part.strip().split("=", 1)[1])
    return json_response({"ok": True})


@require_auth
def get_settings(request: Request):
    config = Config.get()
    return json_response({k: config.get(k) for k in EDITABLE_KEYS if k in config})


@require_auth
def update_settings(request: Request):
    try:
        body = json.loads(request.body or b"{}")
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    config = Config.get()
    rejected = [k for k in body if k not in EDITABLE_KEYS]
    if rejected:
        return json_response({"error": f"not editable: {rejected}"}, status=400)
    for k, v in body.items():
        config[k] = v
    Config.store()
    logger.info("settings updated by %s: %s", _session_user(request), list(body))
    return json_response({"ok": True})


def devices_api(request: Request):
    """Device-type catalog with settings schemas (reference
    SdrDeviceDescription.getInputs)."""
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    return json_response({t: {"name": d.name, "inputs": d.inputs(),
                              "requirement": d.requirement}
                          for t, d in DEVICE_TYPES.items()})


# --------------------------------------------------- SDR device CRUD ----
# Reference: owrx/controllers/settings/sdr.py (device list w/ live state,
# device form from the description's inputs, per-profile tabs, delete
# modals).  Changes land in config["sdrs"], persist via Config.store, and
# re-instantiate the affected source so they apply live.

def _plain(obj):
    """Properties/PropertyLayer → plain JSON-able dict (recursive)."""
    if hasattr(obj, "items"):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _sdrs_dict() -> dict:
    return _plain(Config.get().get("sdrs", {}) or {})


def _store_sdrs(sdrs: dict, touched_id: str | None):
    from openwebrx_tpu_torch.sdr import SdrService
    config = Config.get()
    config["sdrs"] = sdrs
    Config.store()
    if touched_id is not None:
        SdrService.reload_device(touched_id)


@require_auth
def sdrs_api(request: Request):
    """Device list + live state (reference SdrDeviceListController)."""
    from openwebrx_tpu_torch.sdr import SdrService
    sources = SdrService.get_sources()
    out = {}
    for sdr_id, conf in _sdrs_dict().items():
        entry = dict(conf)
        src = sources.get(sdr_id)
        if src is not None:
            entry["state"] = str(src.get_state())
            entry["failed"] = src.is_failed()
            entry["current_profile"] = src.profile_carousel.current_id
        else:
            entry["state"] = "Unconfigured"
        out[sdr_id] = entry
    return json_response(out)


@require_auth
def sdrs_schema_api(request: Request):
    from openwebrx_tpu_torch.web import forms
    return json_response(forms.device_schema())


def _validated_device_update(desc, body: dict) -> dict:
    from openwebrx_tpu_torch.web import forms
    return forms.convert_values(forms.device_fields(desc), body)


def _validated_profile_update(desc, body: dict) -> dict:
    from openwebrx_tpu_torch.web import forms
    return forms.convert_values(forms.profile_fields(desc), body)


@require_auth
def create_sdr(request: Request):
    """POST {type, name, ...device fields} → {id} (reference
    NewSdrDeviceController)."""
    import uuid
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    try:
        body = json.loads(request.body or b"{}")
        sdr_type = body.pop("type", None)
        desc = DEVICE_TYPES.get(sdr_type)
        if desc is None:
            return json_response(
                {"error": f"unknown device type {sdr_type!r}",
                 "types": sorted(DEVICE_TYPES)}, status=400)
        update = _validated_device_update(desc, body)
        if not update.get("name"):
            return json_response({"error": "name is required"}, status=400)
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    except (KeyError, ValueError) as e:
        return json_response({"error": str(e)}, status=400)
    sdr_id = str(uuid.uuid4())
    sdrs = _sdrs_dict()
    sdrs[sdr_id] = {"type": sdr_type, "profiles": {}, **update}
    _store_sdrs(sdrs, sdr_id)
    logger.info("sdr %s (%s) created by %s", sdr_id, sdr_type,
                _session_user(request))
    return json_response({"ok": True, "id": sdr_id})


@require_auth
def update_sdr(request: Request):
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    sdr_id = request.matches.group(1)
    sdrs = _sdrs_dict()
    if sdr_id not in sdrs:
        return json_response({"error": "no such device"}, status=404)
    desc = DEVICE_TYPES.get(sdrs[sdr_id].get("type"))
    if desc is None:
        return json_response({"error": "unknown device type"}, status=400)
    try:
        body = json.loads(request.body or b"{}")
        body.pop("type", None)       # type switch not supported (reference)
        body.pop("profiles", None)   # profiles have their own endpoints
        update = _validated_device_update(desc, body)
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    except (KeyError, ValueError) as e:
        return json_response({"error": str(e)}, status=400)
    sdrs[sdr_id].update(update)
    _store_sdrs(sdrs, sdr_id)
    return json_response({"ok": True, "applied": update})


@require_auth
def delete_sdr(request: Request):
    sdr_id = request.matches.group(1)
    sdrs = _sdrs_dict()
    if sdr_id not in sdrs:
        return json_response({"error": "no such device"}, status=404)
    del sdrs[sdr_id]
    _store_sdrs(sdrs, sdr_id)
    logger.info("sdr %s deleted by %s", sdr_id, _session_user(request))
    return json_response({"ok": True})


@require_auth
def create_profile(request: Request):
    import uuid
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    sdr_id = request.matches.group(1)
    sdrs = _sdrs_dict()
    if sdr_id not in sdrs:
        return json_response({"error": "no such device"}, status=404)
    desc = DEVICE_TYPES.get(sdrs[sdr_id].get("type"))
    try:
        body = json.loads(request.body or b"{}")
        update = _validated_profile_update(desc, body)
        if not update.get("name"):
            return json_response({"error": "name is required"}, status=400)
        for req in ("center_freq", "samp_rate"):
            if req not in update:
                return json_response({"error": f"{req} is required"},
                                     status=400)
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    except (KeyError, ValueError) as e:
        return json_response({"error": str(e)}, status=400)
    profile_id = str(uuid.uuid4())
    sdrs[sdr_id].setdefault("profiles", {})[profile_id] = update
    _store_sdrs(sdrs, sdr_id)
    return json_response({"ok": True, "id": profile_id})


@require_auth
def update_profile(request: Request):
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    sdr_id, profile_id = request.matches.group(1), request.matches.group(2)
    sdrs = _sdrs_dict()
    profiles = sdrs.get(sdr_id, {}).get("profiles", {})
    if profile_id not in profiles:
        return json_response({"error": "no such profile"}, status=404)
    desc = DEVICE_TYPES.get(sdrs[sdr_id].get("type"))
    try:
        body = json.loads(request.body or b"{}")
        update = _validated_profile_update(desc, body)
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    except (KeyError, ValueError) as e:
        return json_response({"error": str(e)}, status=400)
    profiles[profile_id].update(update)
    _store_sdrs(sdrs, sdr_id)
    return json_response({"ok": True, "applied": update})


@require_auth
def delete_profile(request: Request):
    sdr_id, profile_id = request.matches.group(1), request.matches.group(2)
    sdrs = _sdrs_dict()
    profiles = sdrs.get(sdr_id, {}).get("profiles", {})
    if profile_id not in profiles:
        return json_response({"error": "no such profile"}, status=404)
    del profiles[profile_id]
    _store_sdrs(sdrs, sdr_id)
    return json_response({"ok": True})


@require_auth
def logs_api(request: Request):
    from openwebrx_tpu_torch.core.loghistory import HistoryHandler
    name = request.query.get("logger", "openwebrx_tpu_torch")
    return json_response({"logger": name,
                          "lines": HistoryHandler.get_handler(name).get_lines()})


@require_auth
def settings_schema(request: Request):
    from openwebrx_tpu_torch.web import forms
    return json_response(forms.schema())


@require_auth
def update_settings_page(request: Request):
    from openwebrx_tpu_torch.web import forms
    page = request.matches.group(1)
    try:
        body = json.loads(request.body or b"{}")
        converted = forms.apply_page(page, body)
    except json.JSONDecodeError:
        return json_response({"error": "bad request"}, status=400)
    except (KeyError, ValueError) as e:
        return json_response({"error": str(e)}, status=400)
    Config.store()
    logger.info("settings page %s updated by %s: %s", page,
                _session_user(request), list(converted))
    return json_response({"ok": True, "applied": converted})


def get_bookmarks(request: Request):
    from openwebrx_tpu_torch.core.bookmarks import Bookmarks
    return json_response([b.to_json() for b in Bookmarks.shared().get_bookmarks()])


@require_auth
def update_bookmarks(request: Request):
    """Replace the bookmark list (reference bookmarks settings editor)."""
    from openwebrx_tpu_torch.core.bookmarks import Bookmark, Bookmarks
    try:
        body = json.loads(request.body or b"[]")
        if not isinstance(body, list):
            raise ValueError("expected a list")
        new = [Bookmark(item) for item in body]
    except (json.JSONDecodeError, ValueError, KeyError) as e:
        return json_response({"error": f"bad bookmarks: {e}"}, status=400)
    bookmarks = Bookmarks.shared()
    for old in list(bookmarks.get_bookmarks()):
        bookmarks.remove(old.name)
    for b in new:
        bookmarks.add(b)
    bookmarks.store()
    logger.info("bookmarks replaced by %s (%d entries)",
                _session_user(request), len(new))
    return json_response({"ok": True, "count": len(new)})


@require_auth
async def profile_api(request: Request):
    """Capture a device profile (SURVEY §5.1 tracing/profiling build
    target).  ?seconds=N (max 10) runs ``torch.profiler`` over every
    thread's CPU ops and, on a card, every CUDA kernel (the hand-written
    ones too, as kernel events outside any ATen range); the directory
    holding its Chrome trace (``trace.json``, for chrome://tracing or
    Perfetto) comes back."""
    import asyncio
    import os
    import tempfile
    import time as _time

    try:
        seconds = min(10.0, float(request.query.get("seconds", "1")))
    except (TypeError, ValueError):
        seconds = 1.0
    out_dir = tempfile.mkdtemp(prefix="owrx-torch-trace-")

    def capture():
        import torch
        from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # the device loops run on their own threads
        every_thread = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=activities,
                     experimental_config=every_thread) as prof:
            _time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))

    await asyncio.to_thread(capture)
    return json_response({"trace_dir": out_dir, "seconds": seconds})


def register_routes(router):
    router.add("/api/devices", devices_api)
    router.add("/api/sdrs", sdrs_api)
    router.add("/api/sdrs", create_sdr, method="POST")
    router.add("/api/sdrs/schema", sdrs_schema_api)
    router.add_regex(r"^/api/sdrs/([0-9a-zA-Z_.-]+)$", update_sdr,
                     method="POST")
    router.add_regex(r"^/api/sdrs/([0-9a-zA-Z_.-]+)/delete$", delete_sdr,
                     method="POST")
    router.add_regex(r"^/api/sdrs/([0-9a-zA-Z_.-]+)/profiles$",
                     create_profile, method="POST")
    router.add_regex(r"^/api/sdrs/([0-9a-zA-Z_.-]+)/profiles/"
                     r"([0-9a-zA-Z_.-]+)$", update_profile, method="POST")
    router.add_regex(r"^/api/sdrs/([0-9a-zA-Z_.-]+)/profiles/"
                     r"([0-9a-zA-Z_.-]+)/delete$", delete_profile,
                     method="POST")
    router.add("/api/logs", logs_api)
    router.add("/api/profile", profile_api, method="POST")
    router.add("/login", login, method="POST")
    router.add("/logout", logout, method="POST")
    router.add("/api/settings", get_settings)
    router.add("/api/settings", update_settings, method="POST")
    router.add("/api/settings/schema", settings_schema)
    router.add_regex(r"^/api/settings/(general|decoding|background|reporting)$",
                     update_settings_page, method="POST")
    router.add("/api/bookmarks", get_bookmarks)
    router.add("/api/bookmarks", update_bookmarks, method="POST")
