"""SdrService: device registry mapping config → sources → runtimes.

Reference ``owrx/sdr.py:12-286`` (MappedSdrSources reflection, enabled/
failed tracking, AvailableProfiles flattening).  Source classes are
resolved by the ``type`` key; every source gets a DeviceRuntime lazily,
built on ``SdrService.device`` (the server sets it from ``--device``);
``SdrService.warm`` pays the process's one-time costs of those runtimes'
banks before the server listens.
"""

from __future__ import annotations

import logging
import time

from openwebrx_tpu_torch.core.config import Config
from openwebrx_tpu_torch.core.property import PropertyLayer, Properties
from openwebrx_tpu_torch.runtime.device import DeviceRuntime, warm_up
from openwebrx_tpu_torch.sources.base import SdrSource
from openwebrx_tpu_torch.sources.connector import ConnectorSource
from openwebrx_tpu_torch.sources.direct import DirectSource
from openwebrx_tpu_torch.sources.file import FileSource, SignalSource

logger = logging.getLogger(__name__)

SOURCE_TYPES = {
    "file": FileSource,
    "signal": SignalSource,
    # connector family (reference owrx/source/{rtl_sdr,rtl_tcp,soapy,...}.py):
    # all speak the owrx_connector TCP protocol, differing in driver command
    "rtl_sdr": ConnectorSource,
    "rtl_tcp": ConnectorSource,
    "sdrplay": ConnectorSource,
    "airspy": ConnectorSource,
    "airspyhf": ConnectorSource,
    "hackrf": ConnectorSource,
    "lime_sdr": ConnectorSource,
    "pluto_sdr": ConnectorSource,
    "uhd": ConnectorSource,
    "bladerf": ConnectorSource,
    "soapy_remote": ConnectorSource,
    "radioberry": ConnectorSource,
    "fcdpp": ConnectorSource,
    "rtl_sdr_soapy": ConnectorSource,
    "hydrasdr": ConnectorSource,
    "sddc": ConnectorSource,
    "sddc_soapy": ConnectorSource,
    "hpsdr": ConnectorSource,
    "runds": ConnectorSource,
    "afedri": ConnectorSource,
    "mirics": ConnectorSource,
    "connector": ConnectorSource,
    # direct/exec family: stdout IQ, restart on retune (reference
    # owrx/source/direct.py) — nmux is obsolete here, see sources/direct.py
    "fifi_sdr": DirectSource,
    "perseussdr": DirectSource,
    "direct": DirectSource,
}


class SdrService:
    """Singleton registry (reference SdrService)."""

    _sources: dict[str, SdrSource] = {}
    _runtimes: dict[str, DeviceRuntime] = {}
    # the torch device every DeviceRuntime is built on: the server sets it
    # from --device, tests that run without a card set "cpu"
    device = "cuda"

    @classmethod
    def load(cls):
        config = Config.get()
        sdrs = config.get("sdrs", {})
        items = sdrs.items() if hasattr(sdrs, "items") else []
        for sdr_id, conf in items:
            if sdr_id in cls._sources:
                continue
            conf_dict = dict(conf.items()) if hasattr(conf, "items") else dict(conf)
            source_type = conf_dict.get("type", "connector")
            cls_ = SOURCE_TYPES.get(source_type)
            if cls_ is None:
                logger.warning("unknown sdr type %r for %s", source_type, sdr_id)
                continue
            props = PropertyLayer(**conf_dict)
            try:
                cls._sources[sdr_id] = cls_(sdr_id, props)
            except Exception:
                logger.exception("failed to instantiate sdr %s", sdr_id)

    @classmethod
    def get_sources(cls) -> dict[str, SdrSource]:
        if not cls._sources:
            cls.load()
        return cls._sources

    @classmethod
    def get_source(cls, sdr_id: str | None = None) -> SdrSource | None:
        sources = cls.get_sources()
        if sdr_id is not None:
            src = sources.get(sdr_id)
            return src if src is not None and src.is_available() else None
        for src in sources.values():
            if src.is_available():
                return src
        return None

    @classmethod
    def get_device(cls, sdr_id: str | None = None) -> DeviceRuntime | None:
        source = cls.get_source(sdr_id)
        if source is None:
            return None
        rt = cls._runtimes.get(source.id)
        if rt is None:
            rt = cls._new_runtime(source)
            cls._runtimes[source.id] = rt
        return rt

    @classmethod
    def _new_runtime(cls, source) -> DeviceRuntime:
        config = Config.get()
        return DeviceRuntime(
            source,
            fft_size=int(config.get("fft_size", 4096)),
            fft_fps=float(config.get("fft_fps", 9)),
            compression=config.get("audio_compression", "adpcm"),
            fft_compression=config.get("fft_compression", "adpcm"),
            capacity=int(config.get("tpu_channel_capacity", 16)),
            target_seconds=float(config.get("tpu_block_seconds", 0.1)),
            device=cls.device,
        )

    @classmethod
    def warm(cls) -> float:
        """Run ``warm_up`` on a throwaway runtime of every available
        source, built as ``get_device`` builds its runtime; return the
        seconds it took.  The runtimes ``get_device`` hands out are not
        touched."""
        t0 = time.perf_counter()
        for source in cls.get_sources().values():
            if source.is_available():
                warm_up(cls._new_runtime(source))
        return time.perf_counter() - t0

    @classmethod
    def get_profile_list(cls) -> list:
        out = []
        for sdr_id, src in cls.get_sources().items():
            if not src.is_available():
                continue
            for pid, profile in src.get_profiles().items():
                name = profile.get("name", pid)
                out.append({"id": f"{sdr_id}|{pid}",
                            "name": f"{src.get_name()} {name}"})
        return out

    @classmethod
    def reload_device(cls, sdr_id: str):
        """Apply a settings change to one device live: stop the old source
        and runtime, re-instantiate from the current config (reference: the
        settings controllers store into config['sdrs'] and the property
        wires restart the source, owrx/controllers/settings/sdr.py:175)."""
        rt = cls._runtimes.pop(sdr_id, None)
        if rt is not None:
            try:
                rt.stop()
            except Exception:
                logger.exception("runtime stop failed for %s", sdr_id)
        src = cls._sources.pop(sdr_id, None)
        if src is not None:
            try:
                src.shutdown()
            except Exception:
                logger.exception("source shutdown failed for %s", sdr_id)
        config = Config.get()
        sdrs = config.get("sdrs", {}) or {}
        conf = sdrs.get(sdr_id) if hasattr(sdrs, "get") else None
        if conf is None:
            return  # deleted
        conf_dict = dict(conf.items()) if hasattr(conf, "items") else dict(conf)
        cls_ = SOURCE_TYPES.get(conf_dict.get("type", "connector"))
        if cls_ is None:
            logger.warning("unknown sdr type for %s", sdr_id)
            return
        try:
            cls._sources[sdr_id] = cls_(sdr_id, PropertyLayer(**conf_dict))
        except Exception:
            logger.exception("failed to re-instantiate sdr %s", sdr_id)

    @classmethod
    def broadcast_chat(cls, name, text):
        pass  # wired by the client registry (chat) later

    @classmethod
    def stop_all(cls):
        for rt in cls._runtimes.values():
            rt.stop()
        for src in cls._sources.values():
            src.shutdown()
        cls._runtimes.clear()
        cls._sources.clear()

    @classmethod
    def reset(cls):
        cls.stop_all()
