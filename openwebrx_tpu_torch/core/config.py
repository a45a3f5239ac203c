"""Configuration: layered runtime config + core paths.

Behavioral port of the reference's two-tier config (reference
``owrx/config/``): a ``CoreConfig`` for process-level paths/ports (INI,
``owrx/config/core.py:8-106``) and a layered runtime ``Config`` —
dynamic JSON settings over defaults, runtime-mutable and persisted
(``owrx/config/__init__.py:8-43``, ``owrx/config/dynamic.py``,
``owrx/config/defaults.py``).  The default key surface matches the
reference so settings UIs and clients find the same tunables.
"""

from __future__ import annotations

import json
import logging
import os
import threading

logger = logging.getLogger(__name__)

from openwebrx_tpu_torch.core.property import (
    PropertyLayer, PropertyStack, Properties, DELETED,
)

CONFIG_VERSION = 8  # reference migration target (owrx/config/migration.py)


def default_config() -> PropertyLayer:
    """Default runtime settings — same keys as reference defaults
    (owrx/config/defaults.py, 442 LoC; nested dicts instead of nested
    PropertyLayers for JSON friendliness)."""
    return PropertyLayer(
        version=CONFIG_VERSION,
        max_clients=20,
        max_clients_per_ip=20,
        receiver_name="[Callsign]",
        receiver_location="TPU Pod Bay",
        receiver_asl=200,
        receiver_admin="example@example.com",
        receiver_gps={"lat": 0.0, "lon": 0.0},
        receiver_country="",
        photo_title="",
        photo_desc="",
        fft_fps=9,
        fft_size=4096,
        fft_voverlap_factor=0.3,
        audio_compression="adpcm",
        fft_compression="adpcm",
        wfm_deemphasis_tau=50e-6,
        wfm_rds_rbds=False,
        digimodes_fft_size=2048,
        digital_voice_dmr_id_lookup=True,
        digital_voice_nxdn_id_lookup=True,
        sdrs={
            "file": {
                "name": "IQ File Replay",
                "type": "file",
                "profiles": {
                    "default": {
                        "name": "Replay",
                        "center_freq": 145000000,
                        "samp_rate": 2400000,
                        "start_freq": 145145000,
                        "start_mod": "nfm",
                        "tuning_step": "5000",
                    },
                },
            },
        },
        waterfall_scheme="GoogleTurboWaterfall",
        waterfall_levels={"min": -88, "max": -20},
        waterfall_auto_levels={"min": 3, "max": 10},
        waterfall_auto_level_default_mode=False,
        waterfall_auto_min_range=50,
        key_locked=False,
        magic_key="",
        allow_center_freq_changes=False,
        allow_audio_recording=True,
        allow_chat=True,
        tuning_precision=2,
        squelch_auto_margin=10,
        google_maps_api_key="",
        openweathermap_api_key="",
        map_type="leaflet",
        # raster tile template for the map page; "" → offline vector basemap
        map_tile_url="https://tile.openstreetmap.org/{z}/{x}/{y}.png",
        map_position_retention_time=2 * 60 * 60,
        map_call_retention_time=5 * 60,
        map_max_calls=5,
        map_prefer_recent_reports=True,
        map_ignore_indirect_reports=False,
        callsign_url="https://www.qrzcq.com/call/{}",
        vessel_url="https://www.vesselfinder.com/vessels/details/{}",
        flight_url="https://flightaware.com/live/flight/{}",
        modes_url="https://flightaware.com/live/modes/{}/redirect",
        usage_policy_url="policy",
        session_timeout=0,
        keep_files=20,
        decoding_queue_workers=2,
        decoding_queue_length=10,
        wsjt_decoding_depth=3,
        wsjt_decoding_depths={"jt65": 1},
        fst4_enabled_intervals=[15, 30],
        fst4w_enabled_intervals=[120, 300],
        q65_enabled_combinations=["A30", "E120"],
        js8_enabled_profiles=["normal", "slow"],
        js8_decoding_depth=3,
        services_enabled=False,
        services_decoders=["ft8", "ft4", "wspr", "packet"],
        aprs_callsign="N0CALL",
        aprs_igate_enabled=False,
        aprs_igate_server="euro.aprs2.net",
        aprs_igate_password="",
        aprs_igate_beacon=False,
        aprs_igate_symbol="R&",
        aprs_igate_comment="OpenWebRX APRS gateway",
        pskreporter_enabled=False,
        pskreporter_callsign="N0CALL",
        wsprnet_enabled=False,
        wsprnet_callsign="N0CALL",
        mqtt_enabled=False,
        mqtt_host="localhost",
        mqtt_use_ssl=False,
        mqtt_topic="openwebrx",
        mqtt_client_id="",
        mqtt_user=None,
        mqtt_password=None,
        paging_filter=True,
        paging_charset="US",
        eibi_bookmarks_range=0,
        repeater_range=0,
        adsb_ttl=900,
        hfdl_ttl=1800,
        acars_ttl=1800,
        fax_lpm=120,
        fax_min_length=200,
        fax_max_length=1500,
        fax_postprocess=True,
        fax_color=False,
        fax_am=False,
        image_compress=True,
        cw_showcw=False,
        dsc_show_errors=True,
        gps_updates=False,
        bandplan_region=0,
        rig_enabled=False,
        rig_model=2,
        rig_device="127.0.0.1:4533",
        rig_address=0,
        rec_squelch=20,
        rec_hang_time=1000,
        rec_produce_silence=False,
        ssb_agc_profile="Fast",
        dab_output_rate=48000,
        ui_theme="default",
        bot_ban_enabled=True,
        # TPU-specific tunables (no reference analog)
        tpu_block_seconds=0.1,
        tpu_channel_capacity=16,
        tpu_mesh_axes={"chan": 1},
    )


class DynamicConfig(PropertyLayer):
    """JSON-persisted mutable settings layer (reference
    owrx/config/dynamic.py: settings.json, atomic-ish store)."""

    def __init__(self, path: str):
        self.path = path
        values = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    values = json.load(f)
            except (OSError, json.JSONDecodeError):
                values = {}
        if values:
            # upgrade old settings layouts (reference Migrator semantics,
            # owrx/config/migration.py v1→v8)
            from openwebrx_tpu_torch.core.migration import migrate
            try:
                values = migrate(values)
            except ValueError:
                logger.exception("settings file %s not usable", path)
                values = {}
        super().__init__(**values)

    def store(self):
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)
        os.replace(tmp, self.path)


def _json_default(obj):
    if isinstance(obj, Properties):
        return obj.to_dict()
    raise TypeError(f"not JSON serializable: {type(obj)}")


class CoreConfig:
    """Process-level paths/ports (reference owrx/config/core.py)."""

    defaults = {
        "data_directory": "/tmp/openwebrx_tpu",
        "temporary_directory": "/tmp/openwebrx_tpu",
        "web_port": 8073,
        "log_level": "INFO",
        # https is enabled automatically when both files exist
        # (reference: owrx/__main__.py:160-167 with /etc/openwebrx paths)
        "ssl_cert": "/etc/openwebrx/cert.pem",
        "ssl_key": "/etc/openwebrx/key.pem",
    }

    def __init__(self, overrides: dict | None = None):
        self._values = {**self.defaults, **(overrides or {})}

    def get_data_directory(self) -> str:
        return self._values["data_directory"]

    def get_temporary_directory(self) -> str:
        return self._values["temporary_directory"]

    def get_web_port(self) -> int:
        return int(self._values["web_port"])

    def get_log_level(self) -> str:
        return self._values["log_level"]


class Config:
    """Singleton runtime config stack: dynamic settings > defaults
    (reference owrx/config/__init__.py:8-43)."""

    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def get() -> PropertyStack:
        with Config._lock:
            if Config._instance is None:
                Config._instance = Config._build()
            return Config._instance

    @staticmethod
    def _build(settings_path: str | None = None) -> PropertyStack:
        stack = PropertyStack()
        if settings_path is None:
            settings_path = os.path.join(
                CoreConfig.defaults["data_directory"], "settings.json")
        dynamic = DynamicConfig(settings_path)
        stack.add_layer(0, dynamic)
        stack.add_layer(1, default_config())
        stack.dynamic = dynamic
        return stack

    @staticmethod
    def reset():
        with Config._lock:
            Config._instance = None

    @staticmethod
    def store():
        cfg = Config.get()
        if hasattr(cfg, "dynamic"):
            cfg.dynamic.store()
