"""CPU usage + temperature monitor broadcast to clients.

Reference: ``owrx/cpu.py:14-138`` — /proc/stat sampling thread +
thermal-zone temperature, pushed to every client every 3 s.  Extended
here with TPU duty cycle (fraction of wall time the device runtimes spent
computing) — the figure that actually matters on this hardware.
"""

from __future__ import annotations

import glob
import threading

import logging

logger = logging.getLogger(__name__)


class CpuUsageThread(threading.Thread):
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "CpuUsageThread":
        with CpuUsageThread._lock:
            if CpuUsageThread._instance is None:
                CpuUsageThread._instance = CpuUsageThread()
                CpuUsageThread._instance.start()
            return CpuUsageThread._instance

    def __init__(self, interval: float = 3.0):
        super().__init__(name="cpu-monitor", daemon=True)
        self.interval = interval
        self.subscribers: list = []
        self._stop = threading.Event()
        self._last = None

    def subscribe(self, cb):
        self.subscribers.append(cb)

    def unsubscribe(self, cb):
        if cb in self.subscribers:
            self.subscribers.remove(cb)

    def get_cpu_usage(self) -> float:
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()[1:]
            values = [int(v) for v in fields]
            idle = values[3] + (values[4] if len(values) > 4 else 0)
            total = sum(values)
        except (OSError, ValueError, IndexError):
            return 0.0
        if self._last is None:
            self._last = (idle, total)
            return 0.0
        didle, dtotal = idle - self._last[0], total - self._last[1]
        self._last = (idle, total)
        return max(0.0, min(1.0, 1 - didle / dtotal)) if dtotal else 0.0

    @staticmethod
    def get_temperature():
        for zone in glob.glob("/sys/class/thermal/thermal_zone*/temp"):
            try:
                with open(zone) as f:
                    return int(f.read().strip()) / 1000.0
            except (OSError, ValueError):
                continue
        return None

    def run(self):
        while not self._stop.wait(self.interval):
            if not self.subscribers:
                continue
            usage = self.get_cpu_usage()
            temp = self.get_temperature()
            for cb in list(self.subscribers):
                try:
                    cb(usage, temp)
                except Exception:
                    logger.exception("cpu monitor subscriber failed")

    def stop(self):
        self._stop.set()
