"""Schema-driven settings forms.

Reference: ``owrx/form/`` + ``owrx/controllers/settings/*.py`` — the
reference renders HTML forms server-side from typed input classes
(TextInput/NumberInput/DropdownInput/CheckboxInput/…, grouped in
Sections across settings pages).  Here the same page/section/field
structure is DATA: the API serves the schema as JSON and a single page
of client JS renders it, which keeps the server a pure API and the
field inventory auditable in one place.

Field types: text, number, checkbox, textarea, dropdown (options),
list (of strings / numbers), location {lat, lon}, json (free-form).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from openwebrx_tpu_torch.core.config import Config


@dataclass
class Field:
    key: str
    label: str
    type: str = "text"
    options: list | None = None       # [{value, label}] for dropdowns
    append: str = ""                  # unit suffix
    infotext: str = ""
    minimum: float | None = None
    maximum: float | None = None

    def to_json(self) -> dict:
        out = {"key": self.key, "label": self.label, "type": self.type}
        for attr in ("options", "append", "infotext"):
            v = getattr(self, attr)
            if v:
                out[attr] = v
        if self.minimum is not None:
            out["min"] = self.minimum
        if self.maximum is not None:
            out["max"] = self.maximum
        return out

    def convert(self, value):
        """Validate + coerce a submitted value; raises ValueError."""
        if self.type == "number":
            value = float(value)
            if value == int(value):
                value = int(value)
            if self.minimum is not None and value < self.minimum:
                raise ValueError(f"{self.key} below minimum {self.minimum}")
            if self.maximum is not None and value > self.maximum:
                raise ValueError(f"{self.key} above maximum {self.maximum}")
            return value
        if self.type == "checkbox":
            if isinstance(value, str):
                return value.lower() in ("1", "true", "on", "yes")
            return bool(value)
        if self.type == "dropdown":
            allowed = [o["value"] for o in (self.options or [])]
            if allowed and value not in allowed:
                # tolerate numeric dropdowns posted as strings
                if str(value) in [str(a) for a in allowed]:
                    return next(a for a in allowed if str(a) == str(value))
                raise ValueError(f"{self.key}: {value!r} not in {allowed}")
            return value
        if self.type == "list":
            if isinstance(value, str):
                value = [v.strip() for v in value.split(",") if v.strip()]
            if not isinstance(value, list):
                raise ValueError(f"{self.key} must be a list")
            return value
        if self.type == "location":
            if not (isinstance(value, dict) and "lat" in value and "lon" in value):
                raise ValueError(f"{self.key} must be {{lat, lon}}")
            return {"lat": float(value["lat"]), "lon": float(value["lon"])}
        if self.type in ("text", "textarea"):
            return "" if value is None else str(value)
        return value  # json: free-form


@dataclass
class Section:
    title: str
    fields: list = dc_field(default_factory=list)

    def to_json(self):
        return {"title": self.title,
                "fields": [f.to_json() for f in self.fields]}


def _opt(value, label=None):
    return {"value": value, "label": label or str(value)}


# ---------------------------------------------------------------- pages --
# field inventory mirrors the reference settings controllers
# (owrx/controllers/settings/{general,decoding,backgrounddecoding,
# reporting}.py); TPU-specific keys appended where the runtime differs.


def _rig_section() -> Section:
    """Rig control form: hamlib model selectable by name (reference
    owrx/rigcontrol.py:14-301 RIGS table feeds the settings dropdown)."""
    from openwebrx_tpu_torch.core.rigcontrol import rig_models
    return Section("Rig control", [
        Field("rig_enabled", "Mirror tuning to a transceiver", "checkbox"),
        Field("rig_model", "Rig model", "dropdown",
              options=[_opt(m["id"], m["label"]) for m in rig_models()]),
        Field("rig_device", "Rig device",
              infotext="serial port or rigctld host:port"),
        Field("rig_address", "CI-V / bus address", "number",
              minimum=0, maximum=255, infotext="0 = not used"),
    ])


PAGES: dict[str, list[Section]] = {
    "general": [
        Section("Receiver information", [
            Field("receiver_name", "Receiver name"),
            Field("receiver_location", "Receiver location"),
            Field("receiver_asl", "Receiver elevation", "number",
                  append="m ASL"),
            Field("receiver_admin", "Receiver admin"),
            Field("receiver_gps", "Receiver coordinates", "location"),
            Field("photo_title", "Photo title"),
            Field("photo_desc", "Photo description", "textarea",
                  infotext="HTML supported"),
        ]),
        Section("Receiver limits", [
            Field("max_clients", "Maximum number of clients", "number",
                  minimum=1),
            Field("max_clients_per_ip", "Clients per IP", "number",
                  minimum=1),
            Field("session_timeout", "Session timeout", "number",
                  append="seconds", minimum=0),
            Field("keep_files", "Files to keep", "number", minimum=0),
            Field("bot_ban_enabled", "Ban robots", "checkbox"),
            Field("allow_chat", "Allow chat between users", "checkbox"),
            Field("allow_audio_recording", "Allow audio recording",
                  "checkbox"),
            Field("allow_center_freq_changes", "Allow center frequency changes",
                  "checkbox"),
            Field("magic_key", "Magic key",
                  infotext="Key required for frequency changes"),
            Field("bandplan_region", "Bandplan region", "dropdown",
                  options=[_opt("", "Built-in default"),
                           _opt("r1", "ITU Region 1 (EU/Africa)"),
                           _opt("r2", "ITU Region 2 (Americas)"),
                           _opt("r3", "ITU Region 3 (Asia-Pacific)")]),
            Field("bookmark_packs", "Bookmark packs", "json",
                  infotext='List of shipped packs to merge read-only, '
                           'e.g. ["marine", "aviation"] or "all"'),
        ]),
        Section("Waterfall", [
            Field("fft_fps", "Waterfall update rate", "number",
                  append="frames/s", minimum=1, maximum=30),
            Field("fft_size", "FFT size", "dropdown", options=[
                _opt(n) for n in (1024, 2048, 4096, 8192, 16384)]),
            Field("fft_voverlap_factor", "FFT overlap factor", "number",
                  minimum=0.0, maximum=0.9),
            Field("waterfall_scheme", "Color scheme", "dropdown", options=[
                _opt(s) for s in ("GoogleTurboWaterfall", "TeejeezWaterfall",
                                  "Ha7ilmWaterfall", "CustomWaterfall")]),
            Field("waterfall_levels", "Waterfall levels", "json",
                  infotext='{"min": dBFS, "max": dBFS}'),
            Field("waterfall_auto_levels", "Auto levels", "json"),
            Field("tuning_precision", "Tuning precision", "number",
                  append="Hz digits"),
            Field("squelch_auto_margin", "Auto squelch margin", "number",
                  append="dB"),
        ]),
        Section("Compression", [
            Field("audio_compression", "Audio compression", "dropdown",
                  options=[_opt("adpcm", "ADPCM"), _opt("none", "None")]),
            Field("fft_compression", "Waterfall compression", "dropdown",
                  options=[_opt("adpcm", "ADPCM"), _opt("none", "None")]),
        ]),
        Section("Device runtime", [
            Field("tpu_block_seconds", "Processing block length", "number",
                  append="seconds", minimum=0.01, maximum=1.0,
                  infotext="Latency/throughput trade-off of the batched DSP"),
            Field("tpu_channel_capacity", "Channel slots per mode bucket",
                  "number", minimum=1),
        ]),
        _rig_section(),
    ],
    "decoding": [
        Section("Decoding queue", [
            Field("decoding_queue_workers", "Workers", "number", minimum=1),
            Field("decoding_queue_length", "Queue length", "number",
                  minimum=1),
        ]),
        Section("WSJT-X", [
            Field("wsjt_decoding_depth", "Default decoding depth", "number",
                  minimum=1, maximum=3),
            Field("wsjt_decoding_depths", "Per-mode depths", "json",
                  infotext='{"jt65": 1, ...}'),
            Field("fst4_enabled_intervals", "FST4 intervals", "list",
                  infotext="15, 30, 60, 120, 300, 900 or 1800 seconds"),
            Field("fst4w_enabled_intervals", "FST4W intervals", "list"),
            Field("q65_enabled_combinations", "Q65 mode/interval combos",
                  "list", infotext="e.g. A30, E120"),
        ]),
        Section("JS8Call", [
            Field("js8_enabled_profiles", "Enabled speeds", "list",
                  infotext="normal, slow, fast, turbo"),
            Field("js8_decoding_depth", "Decoding depth", "number",
                  minimum=1, maximum=3),
        ]),
        Section("APRS / Packet", [
            Field("aprs_callsign", "Receiver callsign"),
            Field("aprs_igate_enabled", "Enable APRS iGate", "checkbox"),
        ]),
    ],
    "background": [
        Section("Background decoding", [
            Field("services_enabled", "Run background services", "checkbox"),
            Field("services_decoders", "Decoders", "list",
                  infotext="ft8, ft4, wspr, js8, packet, ism, hfdl, ..."),
        ]),
    ],
    "reporting": [
        Section("Map", [
            Field("map_type", "Map engine", "dropdown",
                  options=[_opt("leaflet", "Built-in canvas (OSM tiles)"),
                           _opt("google", "Google Maps")]),
            Field("google_maps_api_key", "Google Maps API key"),
            Field("map_tile_url", "Raster tile URL",
                  infotext="{z}/{x}/{y} template for the canvas engine"),
            Field("map_position_retention_time", "Position retention",
                  "number", append="seconds", minimum=60),
        ]),
        Section("PSK Reporter", [
            Field("pskreporter_enabled", "Report spots", "checkbox"),
            Field("pskreporter_callsign", "Callsign"),
            Field("pskreporter_antenna_information", "Antenna info"),
        ]),
        Section("WSPRnet", [
            Field("wsprnet_enabled", "Report WSPR spots", "checkbox"),
            Field("wsprnet_callsign", "Callsign"),
        ]),
        Section("MQTT", [
            Field("mqtt_enabled", "Publish spots via MQTT", "checkbox"),
            Field("mqtt_host", "Broker", infotext="host or host:port"),
            Field("mqtt_topic", "Topic prefix"),
            Field("mqtt_client_id", "Client ID"),
            Field("mqtt_user", "Username"),
            Field("mqtt_password", "Password"),
            Field("mqtt_use_ssl", "Use TLS", "checkbox"),
        ]),
    ],
}


# ------------------------------------------------------ device/profile --
# The reference generates device/profile forms from
# SdrDeviceDescription.getInputs() with converters + validators
# (owrx/controllers/settings/sdr.py:1-501, owrx/form/input/__init__.py).
# Here the same structure is data: per-type Field lists the settings UI
# renders, and convert_values() validates submissions.

MODE_OPTIONS = [_opt(m) for m in (
    "nfm", "wfm", "am", "sam", "lsb", "usb", "cw", "rawam", "rawsam",
    "bpsk31", "bpsk63", "rtty450", "cwdecoder", "sstv", "fax", "packet",
    "ft8", "ft4", "wspr", "js8")]


def device_fields(desc) -> list[Field]:
    """Device-level settings form for one DeviceDescription."""
    fields = [
        Field("name", "Device name"),
        Field("enabled", "Enabled", "checkbox"),
        Field("always_on", "Always on", "checkbox",
              infotext="Keep the driver running even with no clients"),
        Field("services", "Background services", "checkbox"),
        Field("device", "Device selector",
              infotext="serial number / device string, if more than one"),
    ]
    if desc.supports_ppm:
        fields.append(Field("ppm", "Frequency correction", "number",
                            append="ppm"))
    if desc.supports_bias_tee:
        fields.append(Field("bias_tee", "Bias tee", "checkbox"))
    if desc.supports_direct_sampling:
        fields.append(Field("direct_sampling", "Direct sampling", "dropdown",
                            options=[_opt(0, "Off"), _opt(1, "I branch"),
                                     _opt(2, "Q branch")]))
    for key in desc.extra_keys:
        fields.append(Field(key, key.replace("_", " ").title()))
    return fields


def profile_fields(desc) -> list[Field]:
    """Profile-level settings form (reference profile sections)."""
    fields = [
        Field("name", "Profile name"),
        Field("center_freq", "Center frequency", "number", append="Hz"),
        Field("samp_rate", "Sample rate", "dropdown" if desc.sample_rates
              else "number",
              options=[_opt(r) for r in desc.sample_rates] or None,
              append="S/s"),
        Field("start_freq", "Initial frequency", "number", append="Hz"),
        Field("start_mod", "Initial modulation", "dropdown",
              options=MODE_OPTIONS),
        Field("rf_gain", "RF gain", infotext="number, 'auto', or "
              "stage=value pairs" + (": " + ", ".join(desc.gain_stages)
                                     if desc.gain_stages else "")),
        Field("lfo_offset", "Oscillator offset", "number", append="Hz",
              infotext="Offset between tuned and displayed frequency"),
        Field("waterfall_levels", "Waterfall levels", "json",
              infotext='{"min": dBFS, "max": dBFS} (optional)'),
        Field("scheduling", "Service schedule", "json",
              infotext='e.g. {"type": "static", "schedule": '
                       '{"0000-2400": true}} (optional)'),
    ]
    return fields


def convert_values(fields: list[Field], body: dict) -> dict:
    """Validate + coerce a submitted dict against a Field list.  Unknown
    keys or bad values raise; empty-string optional values are dropped."""
    by_key = {f.key: f for f in fields}
    out = {}
    for key, value in body.items():
        if key not in by_key:
            raise KeyError(f"unknown field {key}")
        if value in ("", None) and key not in ("name",):
            continue
        out[key] = by_key[key].convert(value)
    return out


def device_schema() -> dict:
    """Per-type device + profile form schemas for the settings UI."""
    from openwebrx_tpu_torch.sources.devices import DEVICE_TYPES
    return {
        t: {
            "name": d.name,
            "requirement": d.requirement,
            "device_fields": [f.to_json() for f in device_fields(d)],
            "profile_fields": [f.to_json() for f in profile_fields(d)],
        }
        for t, d in DEVICE_TYPES.items()
    }


def schema() -> dict:
    """Pages → sections → fields, with current values."""
    config = Config.get()
    out = {}
    for page, sections in PAGES.items():
        values = {}
        for section in sections:
            for f in section.fields:
                values[f.key] = config.get(f.key)
        out[page] = {"sections": [s.to_json() for s in sections],
                     "values": values}
    return out


def fields_for_page(page: str) -> dict[str, Field]:
    return {f.key: f for s in PAGES.get(page, []) for f in s.fields}


def apply_page(page: str, body: dict) -> dict:
    """Validate + write one page's values; returns the converted dict.
    Raises KeyError (unknown page/field) or ValueError (bad value)."""
    if page not in PAGES:
        raise KeyError(f"unknown settings page {page}")
    fields = fields_for_page(page)
    converted = {}
    for key, value in body.items():
        if key not in fields:
            raise KeyError(f"{key} is not on page {page}")
        converted[key] = fields[key].convert(value)
    config = Config.get()
    for key, value in converted.items():
        config[key] = value
    if any(k.startswith("rig_") for k in converted):
        from openwebrx_tpu_torch.core.rigcontrol import RigControl
        RigControl.shared().apply_config()
    return converted
