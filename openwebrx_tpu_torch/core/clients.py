"""Client registry: connection limits, IP bans, bot scoring, chat.

Reference: ``owrx/client.py:21-226`` + robot scoring in
``owrx/connection.py:384-398`` — global and per-IP connection caps, timed
IP bans, auto-ban of rapid profile-flippers, chat broadcast with name
dedup + colors, admin broadcast.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)

CHAT_COLORS = ["#briefing", "#ff7f50", "#9acd32", "#40e0d0", "#6495ed",
               "#dda0dd", "#f0e68c", "#fa8072", "#eee8aa", "#98fb98"]


class TooManyClientsError(Exception):
    pass


class BannedClientError(Exception):
    pass


class ClientRegistry:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "ClientRegistry":
        with ClientRegistry._lock:
            if ClientRegistry._instance is None:
                ClientRegistry._instance = ClientRegistry()
            return ClientRegistry._instance

    @staticmethod
    def reset():
        with ClientRegistry._lock:
            ClientRegistry._instance = None

    def __init__(self):
        self.clients: list = []
        self.bans: dict[str, float] = {}   # ip → expiry timestamp
        self._chat_names: dict = {}
        self._lock = threading.RLock()

    # -- limits & bans (reference owrx/client.py:46-120) -------------------
    def add_client(self, client, ip: str):
        from openwebrx_tpu_torch.core.config import Config
        config = Config.get()
        with self._lock:
            self._expire_bans()
            if ip in self.bans:
                raise BannedClientError(ip)
            if len(self.clients) >= int(config.get("max_clients", 20)):
                raise TooManyClientsError("global limit")
            per_ip = sum(1 for c in self.clients if getattr(c, "ip", None) == ip)
            if per_ip >= int(config.get("max_clients_per_ip", 20)):
                raise TooManyClientsError("per-ip limit")
            client.ip = ip
            self.clients.append(client)
        self.broadcast_client_count()

    def remove_client(self, client):
        with self._lock:
            if client in self.clients:
                self.clients.remove(client)
        self.broadcast_client_count()

    def client_count(self) -> int:
        with self._lock:
            return len(self.clients)

    def ban(self, ip: str, minutes: float):
        with self._lock:
            self.bans[ip] = time.time() + minutes * 60
        logger.info("banned %s for %.0f minutes", ip, minutes)
        # drop existing connections from that ip
        for c in list(self.clients):
            if getattr(c, "ip", None) == ip:
                try:
                    c.close_banned()
                except Exception:
                    pass

    def is_banned(self, ip: str) -> bool:
        with self._lock:
            self._expire_bans()
            return ip in self.bans

    def _expire_bans(self):
        now = time.time()
        self.bans = {ip: exp for ip, exp in self.bans.items() if exp > now}

    # -- broadcast ---------------------------------------------------------
    def broadcast_client_count(self):
        count = self.client_count()
        for c in list(self.clients):
            try:
                c.write_clients(count)
            except Exception:
                pass

    def broadcast_chat_message(self, sender, text: str, name: str | None):
        from openwebrx_tpu_torch.core.config import Config
        if not Config.get().get("allow_chat", True):
            return
        with self._lock:
            key = id(sender)
            if key not in self._chat_names:
                color = CHAT_COLORS[len(self._chat_names) % len(CHAT_COLORS)]
                self._chat_names[key] = color
            color = self._chat_names[key]
        name = (name or "anonymous")[:32]
        text = text[:500]
        for c in list(self.clients):
            try:
                c.write_chat_message(name, text, color)
            except Exception:
                pass

    def broadcast_admin_message(self, text: str):
        for c in list(self.clients):
            try:
                c.write_log_message(text)
            except Exception:
                pass


class RobotScore:
    """Rapid profile-flipping detector (reference owrx/connection.py:384-398):
    each change within 10 s of the previous adds score; ≥30 → suspected bot."""

    THRESHOLD = 30

    def __init__(self):
        self.last_change = 0.0
        self.alert = 0.0

    def record_change(self) -> bool:
        """Returns True if this client now looks like a robot."""
        now = time.time()
        score = 10 - (now - self.last_change)
        self.last_change = now
        if score < 0:
            self.alert = 0
        else:
            self.alert += score
        return self.alert >= self.THRESHOLD
