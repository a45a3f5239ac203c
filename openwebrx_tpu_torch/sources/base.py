"""Source base: lifecycle state machine + blocking block queue.

Reference semantics preserved (``owrx/source/__init__.py:113-607``):
states STOPPED/STARTING/RUNNING/STOPPING/TUNING; client classes
USER/BACKGROUND/INACTIVE drive on-demand start/stop; failure marks the
source failed and fans out to event clients; retune goes through the
driver control channel without restart (connector family).
"""

from __future__ import annotations

import enum
import logging
import queue
import threading

import numpy as np

from openwebrx_tpu_torch.core.property import Properties, PropertyCarousel, PropertyLayer, PropertyStack

logger = logging.getLogger(__name__)


class SdrSourceState(enum.Enum):
    STOPPED = "Stopped"
    STARTING = "Starting"
    RUNNING = "Running"
    STOPPING = "Stopping"
    TUNING = "Tuning"

    def __str__(self):
        return self.value


class SdrBusyState(enum.Enum):
    IDLE = 1
    BUSY = 2


class SdrClientClass(enum.Enum):
    INACTIVE = 1
    BACKGROUND = 2
    USER = 3


class SdrSourceEventClient:
    def on_state_change(self, state: SdrSourceState):
        pass

    def on_busy_state_change(self, state: SdrBusyState):
        pass

    def on_fail(self):
        pass

    def on_shutdown(self):
        pass

    def on_disable(self):
        pass

    def on_enable(self):
        pass

    def get_client_class(self) -> SdrClientClass:
        return SdrClientClass.INACTIVE


class SdrSource:
    """Abstract source.  Subclasses implement _run_stream(), which must
    keep calling self._deliver(block) with complex64 blocks of
    self.block_size until self._stop_requested."""

    MAX_RETRIES = 10          # reference: 10 retries × 15 s
    RETRY_DELAY = 15.0

    def __init__(self, source_id: str, props: Properties):
        self.id = source_id
        self.props = self._build_props(props)
        self.profile_carousel = self._build_profiles(props)
        self.clients: list[SdrSourceEventClient] = []
        self.state = SdrSourceState.STOPPED
        self.busy_state = SdrBusyState.IDLE
        self.enabled = bool(props.get("enabled", True))
        self.failed = False
        self.block_size = 0  # set by DeviceRuntime before start
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=8)
        self._thread: threading.Thread | None = None
        self._stop_requested = False
        self._retries = 0
        self._retry_timer: threading.Timer | None = None
        self._lock = threading.RLock()

    # -- property stack (reference owrx/source/__init__.py:114-160) -------
    def _build_props(self, device_props: Properties) -> PropertyStack:
        stack = PropertyStack()
        stack.add_layer(1, device_props)
        return stack

    def _build_profiles(self, device_props: Properties) -> PropertyCarousel:
        carousel = PropertyCarousel()
        profiles = device_props.get("profiles", {})
        items = profiles.items() if hasattr(profiles, "items") else []
        for key, value in items:
            layer = value if isinstance(value, Properties) else PropertyLayer(**dict(value))
            carousel.add_layer(key, layer)
        self_stack = getattr(self, "props", None)
        if items:
            first = next(iter(profiles.keys()))
            carousel.switch(first)
        if self_stack is not None:
            self_stack.add_layer(0, carousel)
        else:
            self._pending_carousel = carousel
        return carousel

    def activate_profile(self, profile_id: str):
        """Reference SdrSource.activateProfile + PropertyCarousel.switch."""
        if self.profile_carousel.has_layer(profile_id):
            self.profile_carousel.switch(profile_id)

    def get_profiles(self) -> dict:
        return {k: dict(v.items() if hasattr(v, "items") else v)
                for k, v in (self.props.get("profiles", {}) or {}).items()}

    # -- naming -----------------------------------------------------------
    def get_name(self) -> str:
        return self.props.get("name", self.id)

    def get_sample_rate(self) -> float:
        return float(self.props.get("samp_rate", 2400000))

    def get_center_freq(self) -> float:
        return float(self.props.get("center_freq", 0))

    # -- state machine ----------------------------------------------------
    def get_state(self) -> SdrSourceState:
        return self.state

    def _set_state(self, state: SdrSourceState):
        self.state = state
        for c in list(self.clients):
            try:
                c.on_state_change(state)
            except Exception:
                logger.exception("source event client failed")

    def set_busy_state(self, state: SdrBusyState):
        if state is self.busy_state:
            return
        self.busy_state = state
        for c in list(self.clients):
            try:
                c.on_busy_state_change(state)
            except Exception:
                logger.exception("source event client failed")

    def is_always_on(self) -> bool:
        return bool(self.props.get("always-on", False))

    def is_enabled(self) -> bool:
        return self.enabled

    def is_failed(self) -> bool:
        return self.failed

    def is_available(self) -> bool:
        return self.enabled and not self.failed

    def fail(self):
        self.failed = True
        self._set_state(SdrSourceState.STOPPED)
        for c in list(self.clients):
            try:
                c.on_fail()
            except Exception:
                logger.exception("source event client failed")

    # -- client management (reference :500-539) ---------------------------
    def add_client(self, c: SdrSourceEventClient):
        with self._lock:
            if c in self.clients:
                return
            self.clients.append(c)
        c.on_state_change(self.get_state())
        has_users = self.has_clients(SdrClientClass.USER)
        has_background = self.has_clients(SdrClientClass.BACKGROUND)
        if has_users or has_background:
            self.start()
            self.set_busy_state(SdrBusyState.BUSY if has_users else SdrBusyState.IDLE)

    def remove_client(self, c: SdrSourceEventClient):
        with self._lock:
            if c not in self.clients:
                return
            self.clients.remove(c)
        self.check_status()

    def get_clients(self, *classes):
        if not classes:
            return list(self.clients)
        return [c for c in self.clients if c.get_client_class() in classes]

    def has_clients(self, *classes) -> bool:
        return len(self.get_clients(*classes)) > 0

    def check_status(self):
        has_users = self.has_clients(SdrClientClass.USER)
        self.set_busy_state(SdrBusyState.BUSY if has_users else SdrBusyState.IDLE)
        if self.is_always_on():
            return
        if not has_users and not self.has_clients(SdrClientClass.BACKGROUND):
            self.stop()

    # -- streaming --------------------------------------------------------
    def start(self):
        with self._lock:
            if self.state is not SdrSourceState.STOPPED or self.failed:
                return
            self._set_state(SdrSourceState.STARTING)
            self._stop_requested = False
            self._thread = threading.Thread(target=self._stream_wrapper,
                                            name=f"source-{self.id}", daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            if self.state in (SdrSourceState.STOPPED, SdrSourceState.STOPPING):
                return
            self._set_state(SdrSourceState.STOPPING)
            self._stop_requested = True
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        # drain queue so a paused reader doesn't see stale blocks
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._set_state(SdrSourceState.STOPPED)

    def shutdown(self):
        if self._retry_timer is not None:
            self._retry_timer.cancel()
        self.stop()
        for c in list(self.clients):
            try:
                c.on_shutdown()
            except Exception:
                logger.exception("source event client failed")

    def _stream_wrapper(self):
        try:
            self._set_state(SdrSourceState.RUNNING)
            self._run_stream()
            self._retries = 0
        except Exception:
            logger.exception("source %s stream failed", self.id)
            self._schedule_retry()

    def _schedule_retry(self):
        """Driver restart budget (reference owrx/source/__init__.py:432-448:
        10 retries every 15 s, then the source is marked failed)."""
        if self._stop_requested:
            return
        self._retries += 1
        if self._retries > self.MAX_RETRIES:
            self.fail()
            return
        logger.warning("source %s retry %d/%d in %.0fs", self.id,
                       self._retries, self.MAX_RETRIES, self.RETRY_DELAY)
        self._set_state(SdrSourceState.STOPPED)

        def retry():
            with self._lock:
                if self._stop_requested or self.failed:
                    return
                if self.has_clients(SdrClientClass.USER, SdrClientClass.BACKGROUND) \
                        or self.is_always_on():
                    self.start()

        self._retry_timer = threading.Timer(self.RETRY_DELAY, retry)
        self._retry_timer.daemon = True
        self._retry_timer.start()

    def _run_stream(self):
        raise NotImplementedError

    def _deliver(self, block: np.ndarray):
        """Blocking put with stop-check (backpressure to the producer)."""
        while not self._stop_requested:
            try:
                self._queue.put(block, timeout=0.25)
                return
            except queue.Full:
                continue

    def read_block(self, timeout: float = 2.0) -> np.ndarray | None:
        """Blocking read by the DeviceRuntime; None on timeout/stop."""
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None
