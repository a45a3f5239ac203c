"""RFC 6455 WebSocket server implementation on asyncio streams.

Fresh implementation of the protocol the reference hand-rolls with
blocking sockets (reference ``owrx/websocket.py:49-303``): HTTP 101
upgrade (SHA1 + magic GUID accept), frame encode/decode with client
masking, fragmentation, ping/pong keepalive, close handshake.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import struct

logger = logging.getLogger(__name__)

MAGIC_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + MAGIC_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head.append(n)
    elif n < 1 << 16:
        head.append(126)
        head += struct.pack(">H", n)
    else:
        head.append(127)
        head += struct.pack(">Q", n)
    return bytes(head) + payload


class WebSocketClosed(Exception):
    pass


class WebSocketConnection:
    """Server-side connection over asyncio (reader, writer), post-upgrade."""

    PING_INTERVAL = 30.0

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False
        self._send_lock = asyncio.Lock()
        self._ping_task: asyncio.Task | None = None

    @staticmethod
    def upgrade_response(headers: dict) -> bytes:
        key = headers.get("sec-websocket-key", "")
        return (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
            "\r\n"
        ).encode()

    def start_keepalive(self):
        self._ping_task = asyncio.get_running_loop().create_task(self._ping_loop())

    async def _ping_loop(self):
        try:
            while not self.closed:
                await asyncio.sleep(self.PING_INTERVAL)
                await self._send_raw(encode_frame(OP_PING, b""))
        except (asyncio.CancelledError, ConnectionError, WebSocketClosed):
            pass

    # -- sending ----------------------------------------------------------
    async def send_text(self, text: str):
        await self._send_raw(encode_frame(OP_TEXT, text.encode()))

    async def send_binary(self, data: bytes):
        await self._send_raw(encode_frame(OP_BINARY, data))

    async def _send_raw(self, data: bytes):
        if self.closed:
            raise WebSocketClosed
        async with self._send_lock:
            self.writer.write(data)
            try:
                await self.writer.drain()
            except ConnectionError:
                self.closed = True
                raise WebSocketClosed

    # -- receiving --------------------------------------------------------
    async def receive(self) -> tuple[int, bytes]:
        """Next complete message → (opcode, payload); handles control
        frames and fragmentation internally."""
        frag_op, frag = None, bytearray()
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == OP_PING:
                await self._send_raw(encode_frame(OP_PONG, payload))
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                await self.close()
                raise WebSocketClosed
            if opcode == OP_CONT:
                frag += payload
                if fin:
                    return frag_op, bytes(frag)
                continue
            if not fin:
                frag_op, frag = opcode, bytearray(payload)
                continue
            return opcode, payload

    async def _read_frame(self):
        try:
            head = await self.reader.readexactly(2)
        except (asyncio.IncompleteReadError, ConnectionError):
            self.closed = True
            raise WebSocketClosed
        fin = bool(head[0] & 0x80)
        opcode = head[0] & 0x0F
        masked = bool(head[1] & 0x80)
        length = head[1] & 0x7F
        if length == 126:
            length, = struct.unpack(">H", await self.reader.readexactly(2))
        elif length == 127:
            length, = struct.unpack(">Q", await self.reader.readexactly(8))
        mask = await self.reader.readexactly(4) if masked else None
        payload = await self.reader.readexactly(length) if length else b""
        if mask:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload)) \
                if length < 4096 else _unmask(payload, mask)
        return fin, opcode, payload

    async def close(self, code: int = 1000):
        if self.closed:
            return
        self.closed = True
        if self._ping_task is not None:
            self._ping_task.cancel()
        try:
            self.writer.write(encode_frame(OP_CLOSE, struct.pack(">H", code)))
            await self.writer.drain()
        except ConnectionError:
            pass
        self.writer.close()


def _unmask(payload: bytes, mask: bytes) -> bytes:
    import numpy as np
    data = np.frombuffer(payload, np.uint8).copy()
    m = np.frombuffer((mask * ((len(payload) + 3) // 4))[: len(payload)], np.uint8)
    return (data ^ m).tobytes()
