"""Spot reporting engine: pluggable sinks, config-gated.

Reference: ``owrx/reporting/__init__.py:13-76`` + pskreporter/wsprnet/mqtt
sinks.  Sinks filter by mode; the engine fans each decoded spot to every
enabled sink.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger(__name__)


class Reporter:
    def spot(self, spot: dict):
        raise NotImplementedError

    def supports_mode(self, mode: str) -> bool:
        return True

    def stop(self):
        pass


class ReportingEngine:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "ReportingEngine":
        with ReportingEngine._lock:
            if ReportingEngine._instance is None:
                ReportingEngine._instance = ReportingEngine()
                ReportingEngine._instance.configure()
            return ReportingEngine._instance

    @staticmethod
    def reset():
        with ReportingEngine._lock:
            if ReportingEngine._instance is not None:
                ReportingEngine._instance.stop()
                ReportingEngine._instance = None

    def __init__(self):
        self.reporters: list[Reporter] = []

    def configure(self):
        from openwebrx_tpu_torch.core.config import Config
        config = Config.get()
        if config.get("pskreporter_enabled"):
            from openwebrx_tpu_torch.reporting.pskreporter import PskReporter
            self.reporters.append(PskReporter(
                config.get("pskreporter_callsign", "N0CALL"),
                config.get("pskreporter_antenna_information", "")))
        if config.get("wsprnet_enabled"):
            from openwebrx_tpu_torch.reporting.wsprnet import WsprnetReporter
            self.reporters.append(WsprnetReporter(
                config.get("wsprnet_callsign", "N0CALL")))
        if config.get("mqtt_enabled") and config.get("mqtt_host"):
            from openwebrx_tpu_torch.reporting.mqtt import MqttReporter
            self.reporters.append(MqttReporter(
                config.get("mqtt_host"),
                topic=config.get("mqtt_topic") or "openwebrx",
                client_id=config.get("mqtt_client_id") or "",
                username=config.get("mqtt_user"),
                password=config.get("mqtt_password"),
                use_ssl=bool(config.get("mqtt_use_ssl"))))

    def add(self, reporter: Reporter):
        self.reporters.append(reporter)

    def spot(self, spot: dict):
        for r in list(self.reporters):
            try:
                if r.supports_mode(spot.get("mode", "")):
                    r.spot(spot)
            except Exception:
                logger.exception("reporter failed")

    def stop(self):
        for r in self.reporters:
            try:
                r.stop()
            except Exception:
                pass
        self.reporters = []
