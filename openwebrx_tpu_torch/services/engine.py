"""Background services: automatic decoding of dial frequencies in view.

Reference: ``owrx/service/__init__.py:20-446`` — per-source ServiceHandler
collects bandplan dial frequencies within the device's passband, builds
headless demod chains for each enabled decoder, and pushes decodes to
map/reporting.  (The reference's greedy resampler-grouping optimizer,
:199-252, is unnecessary here: service channels are bank slots of the
device runtime's batched programs.)
"""

from __future__ import annotations

import logging
import threading

from openwebrx_tpu_torch.core.bands import Bandplan
from openwebrx_tpu_torch.core.config import Config, CoreConfig
from openwebrx_tpu_torch.core.map import Map, LocatorLocation
from openwebrx_tpu_torch.core.metrics import Metrics
from openwebrx_tpu_torch.reporting import ReportingEngine
from openwebrx_tpu_torch.services.chopper import AudioChopper
from openwebrx_tpu_torch.services.js8 import JS8_PROFILES
from openwebrx_tpu_torch.services.wsjt import PROFILES as WSJT_PROFILES
from openwebrx_tpu_torch.sources.base import SdrClientClass, SdrSourceEventClient, SdrSourceState

logger = logging.getLogger(__name__)

CHOPPER_MODES = set(WSJT_PROFILES) | set(JS8_PROFILES)

# modes decoded fully natively by a SecondaryHandle chain (reference
# ServiceOnlyMode entries NAVTEX/DSC/SSTV/Fax, owrx/modes.py)
NATIVE_SECONDARY_SERVICES = {"navtex", "dsc", "sstv", "fax",
                             "sitorb", "cwskimmer"}


def report_spot(spot: dict, mode: str, dial_freq: float):
    """Per-band decode metric, map location/call lines, reporting sinks —
    shared by background services and interactive chopper listeners
    (reference WsjtParser push, owrx/wsjt.py:297-305)."""
    band = Bandplan.shared().find_band(dial_freq)
    band_name = band.get_name() if band else "unknown"
    Metrics.shared().counter(
        f"wsjt.decodes.{band_name}.{spot.get('mode', mode)}").inc()
    if "callsign" in spot and "locator" in spot:
        try:
            Map.shared().update_location(
                spot["callsign"], LocatorLocation(spot["locator"]),
                spot.get("mode", mode), band_name)
        except ValueError:
            pass
        ReportingEngine.shared().spot(spot)
    if "callsign" in spot and "callee" in spot:
        Map.shared().update_call(spot["callsign"], spot["callee"],
                                 spot.get("mode", mode), band_name)


class ServiceHandler(SdrSourceEventClient):
    """Runs background decoders on one device (reference ServiceHandler)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.source = runtime.source
        self.services: list[dict] = []
        self._lock = threading.Lock()
        self.source.add_client(self)
        self.source.props.subscribe(self._on_props)

    def get_client_class(self) -> SdrClientClass:
        return SdrClientClass.BACKGROUND

    def on_state_change(self, state: SdrSourceState):
        if state is SdrSourceState.RUNNING:
            self.update_services()
        elif state is SdrSourceState.STOPPED:
            self.stop_services()

    def _on_props(self, changes: dict):
        if "center_freq" in changes or "samp_rate" in changes:
            self.update_services()

    def update_services(self):
        self.stop_services()
        config = Config.get()
        from openwebrx_tpu_torch.services.exec_modes import EXEC_MODES, IQ_EXEC_MODES
        supported = (CHOPPER_MODES | set(EXEC_MODES) | set(IQ_EXEC_MODES)
                     | NATIVE_SECONDARY_SERVICES)
        enabled = [d for d in config.get("services_decoders", [])
                   if d in supported]
        if not enabled:
            return
        center = self.source.get_center_freq()
        half = self.source.get_sample_rate() / 2
        dials = Bandplan.shared().collect_dial_frequencies(center - half,
                                                           center + half)
        with self._lock:
            for dial in dials:
                if dial["mode"] not in enabled:
                    continue
                try:
                    self._start_service(dial["mode"], dial["frequency"], center)
                except Exception:
                    logger.exception("failed to start %s service", dial["mode"])
        logger.info("source %s: %d background services running",
                    self.source.id, len(self.services))

    def _start_service(self, mode: str, dial_freq: float, center: float):
        from openwebrx_tpu_torch.services.exec_modes import (
            EXEC_MODES, IQ_EXEC_MODES, ExecModeService, make_iq_parser,
        )
        from openwebrx_tpu_torch.services.pipeline import SubprocessPipeline

        offset = dial_freq - center
        if mode in CHOPPER_MODES:
            from openwebrx_tpu_torch.services.wsjt import enabled_profiles
            profiles = enabled_profiles(mode)
            if not profiles:
                return
            # profiles sharing an interval share one recording; one chopper
            # per interval group (reference owrx/audio/chopper.py:45-56)
            groups: dict[float, list] = {}
            for p in profiles:
                groups.setdefault(p.interval, []).append(p)
            handle = self.runtime.open_channel("usb", offset, service=True)
            choppers = [
                AudioChopper(
                    group, int(dial_freq),
                    CoreConfig.defaults["temporary_directory"],
                    lambda spot, m=mode, f=dial_freq: self._on_spot(spot, m, f))
                for group in groups.values()
            ]
            handle.audio_cb = lambda wire, hd=False, cs=choppers: [
                c.write(wire) for c in cs]
            self.services.append({"mode": mode, "dial": dial_freq,
                                  "handle": handle, "choppers": choppers})
        elif mode in EXEC_MODES:
            spec = EXEC_MODES[mode]
            handle = self.runtime.open_channel(spec["underlying"], offset,
                                               service=True)
            svc = ExecModeService(mode, lambda ev: self._on_event(ev, dial_freq))
            handle.audio_cb = lambda wire, hd=False, s=svc: s.feed(wire)
            self.services.append({"mode": mode, "dial": dial_freq,
                                  "handle": handle, "exec": svc})
        elif mode in NATIVE_SECONDARY_SERVICES:
            handle = self.runtime.open_secondary(mode, offset)
            handle.text_cb = (lambda text, m=mode, f=dial_freq:
                              self._on_secondary_text(text, m, f))
            self.services.append({"mode": mode, "dial": dial_freq,
                                  "handle": handle})
        elif mode in IQ_EXEC_MODES:
            spec = IQ_EXEC_MODES[mode]
            handle = self.runtime.open_iq_channel(spec["if_rate"], offset,
                                                  spec["wire"])
            parser = make_iq_parser(spec["parser"],
                                    lambda ev: self._on_event(ev, dial_freq))
            pipeline = SubprocessPipeline(
                spec["command"](spec["if_rate"], dial_freq), parser)
            handle.iq_cb = pipeline.feed
            self.services.append({"mode": mode, "dial": dial_freq,
                                  "handle": handle, "pipeline": pipeline})

    def _on_secondary_text(self, text: str, mode: str, dial_freq: float):
        """Native secondary decoders: NAVTEX/DSC emit JSON event lines
        (counted, logged); SSTV/FAX row lines are skipped here — finished
        images land in shared storage by the decoder itself."""
        import json as _json
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                try:
                    event = _json.loads(line)
                except _json.JSONDecodeError:
                    continue
                if "pixels" in event:
                    continue            # image row: panel-only payload
                self._on_event(event, dial_freq)
                if event.get("complete"):
                    logger.info("%s service @%d: saved %s", mode,
                                int(dial_freq), event.get("filename"))
            else:
                Metrics.shared().counter(f"services.events.{mode}").inc()

    def _on_event(self, event: dict, dial_freq: float):
        """Non-spot service events (pages, ISM sensors, aircraft, vessels)
        — counted and pushed to the map when they carry positions."""
        Metrics.shared().counter(
            f"services.events.{event.get('mode', 'unknown')}").inc()
        if "lat" not in event or "lon" not in event:
            return
        from openwebrx_tpu_torch.core.map import LatLngLocation
        if "icao" in event:
            Map.shared().update_location(
                event.get("flight") or event["icao"],
                LatLngLocation(event["lat"], event["lon"]),
                event.get("mode", "AIR"))
        elif "mmsi" in event or "src" in event:
            # DSC distress/position reports put the vessel on the map
            # (reference owrx/marine.py vessel flow)
            Map.shared().update_location(
                str(event.get("mmsi") or event["src"]),
                LatLngLocation(event["lat"], event["lon"]),
                event.get("mode", "DSC"))

    def _on_spot(self, spot: dict, mode: str, dial_freq: float):
        report_spot(spot, mode, dial_freq)

    def stop_services(self):
        with self._lock:
            for svc in self.services:
                handle = svc["handle"]
                if hasattr(handle, "close"):
                    handle.close()
                else:
                    self.runtime.release_secondary(handle)
                for chopper in svc.get("choppers", []):
                    chopper.close()
                if "exec" in svc:
                    svc["exec"].close()
                if "pipeline" in svc:
                    svc["pipeline"].close()
            self.services = []

    def shutdown(self):
        self.stop_services()
        self.source.remove_client(self)


class Services:
    """Registry of service handlers (reference Services.start,
    owrx/service/__init__.py:386)."""

    handlers: list[ServiceHandler] = []

    @classmethod
    def start(cls):
        config = Config.get()
        if not config.get("services_enabled"):
            return
        from openwebrx_tpu_torch.sdr import SdrService
        for sdr_id in list(SdrService.get_sources()):
            runtime = SdrService.get_device(sdr_id)
            if runtime is not None:
                cls.handlers.append(ServiceHandler(runtime))
                runtime.start()

    @classmethod
    def stop(cls):
        for h in cls.handlers:
            h.shutdown()
        cls.handlers = []
