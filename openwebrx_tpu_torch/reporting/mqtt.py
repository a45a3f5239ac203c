"""MQTT spot reporter with a built-in minimal MQTT 3.1.1 client.

Reference: ``owrx/reporting/mqtt.py`` — publishes every decoded spot as
JSON to ``<topic>/<mode>`` on a configured broker.  The reference uses
paho-mqtt; this image has no MQTT library, so the small subset the
reporter needs (CONNECT/CONNACK, PUBLISH QoS 0, PINGREQ keepalive,
DISCONNECT) is implemented directly over a socket — MQTT 3.1.1 control
packets are simple length-prefixed frames.  Optional TLS via the ssl
stdlib, optional username/password auth.
"""

from __future__ import annotations

import json
import logging
import socket
import ssl
import struct
import threading
import time

from openwebrx_tpu_torch.reporting import Reporter

logger = logging.getLogger(__name__)

DEFAULT_TOPIC = "openwebrx"
KEEPALIVE_S = 60


def _encode_remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8_field(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def connect_packet(client_id: str, username: str | None = None,
                   password: str | None = None,
                   keepalive: int = KEEPALIVE_S) -> bytes:
    flags = 0x02  # clean session
    payload = _utf8_field(client_id)
    if username is not None:
        flags |= 0x80
        payload += _utf8_field(username)
        if password is not None:
            flags |= 0x40
            payload += _utf8_field(password)
    var = _utf8_field("MQTT") + bytes([4, flags]) + struct.pack(">H", keepalive)
    body = var + payload
    return bytes([0x10]) + _encode_remaining_length(len(body)) + body


def publish_packet(topic: str, payload: bytes) -> bytes:
    body = _utf8_field(topic) + payload
    return bytes([0x30]) + _encode_remaining_length(len(body)) + body


PINGREQ = bytes([0xC0, 0x00])
DISCONNECT = bytes([0xE0, 0x00])


class MqttClient:
    """Blocking QoS-0 publisher.  connect() raises on CONNACK refusal."""

    def __init__(self, host: str, port: int = 1883, client_id: str = "",
                 username: str | None = None, password: str | None = None,
                 use_ssl: bool = False, timeout: float = 10.0):
        self.host, self.port = host, port
        self.client_id = client_id or f"owrx-{int(time.time()) & 0xffff:x}"
        self.username, self.password = username, password
        self.use_ssl = use_ssl
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._last_send = 0.0

    def connect(self):
        sock = socket.create_connection((self.host, self.port), self.timeout)
        if self.use_ssl:
            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=self.host)
        sock.sendall(connect_packet(self.client_id, self.username,
                                    self.password))
        # CONNACK: 0x20 0x02 <session-present> <return-code>
        ack = self._recv_exact(sock, 4)
        if ack[0] != 0x20 or ack[3] != 0:
            sock.close()
            raise ConnectionError(f"MQTT broker refused connection: rc={ack[3]}")
        self._sock = sock
        self._last_send = time.monotonic()

    @staticmethod
    def _recv_exact(sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("MQTT broker closed connection")
            buf += chunk
        return buf

    def publish(self, topic: str, payload: bytes):
        with self._lock:
            if self._sock is None:
                self.connect()
            try:
                self._sock.sendall(publish_packet(topic, payload))
                self._last_send = time.monotonic()
            except OSError:
                # one reconnect attempt, then give up on this spot
                self._close()
                self.connect()
                self._sock.sendall(publish_packet(topic, payload))
                self._last_send = time.monotonic()

    def ping_if_idle(self):
        with self._lock:
            if self._sock is not None and \
                    time.monotonic() - self._last_send > KEEPALIVE_S / 2:
                try:
                    self._sock.sendall(PINGREQ)
                    self._last_send = time.monotonic()
                except OSError:
                    self._close()

    def _close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def disconnect(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(DISCONNECT)
                except OSError:
                    pass
                self._close()


class MqttReporter(Reporter):
    """Publishes spots as JSON to ``<topic>/<mode>``; connects lazily and
    keeps the link alive with a background ping thread."""

    def __init__(self, host: str, topic: str = DEFAULT_TOPIC,
                 client_id: str = "", username: str | None = None,
                 password: str | None = None, use_ssl: bool = False):
        parts = host.split(":")
        port = int(parts[1]) if len(parts) > 1 else (8883 if use_ssl else 1883)
        self.topic = topic or DEFAULT_TOPIC
        self.client = MqttClient(parts[0], port, client_id, username,
                                 password, use_ssl)
        self._stop = threading.Event()
        self._pinger = threading.Thread(target=self._ping_loop,
                                        name="MqttReporter", daemon=True)
        self._pinger.start()

    def _ping_loop(self):
        while not self._stop.wait(5.0):
            try:
                self.client.ping_if_idle()
            except Exception:
                logger.exception("mqtt keepalive failed")

    def spot(self, spot: dict):
        topic = self.topic
        if "mode" in spot:
            topic = f"{self.topic}/{spot['mode']}"
        try:
            self.client.publish(topic, json.dumps(spot).encode())
        except Exception as e:
            logger.warning("mqtt publish failed: %s", e)

    def stop(self):
        self._stop.set()
        self.client.disconnect()
