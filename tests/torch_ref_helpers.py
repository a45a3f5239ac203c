"""Jax-free helpers the port's test files share: the reference's WebSocket
test client (tests/test_server.py ``WsTestClient``), its wire-audio helpers
(tests/test_passband.py ``decode_wire`` and ``tone_power_ratio``, over the
port's ADPCM decoder), its synchronous runtime pump and its BPSK31 test
signal (tests/test_pfb_interactive.py ``_pump``, tests/test_secondary_bank.py
``psk31_iq``).  Nothing here imports jax or ``openwebrx_tpu``, so the
carried reference files (tests/test_torch_ref_*.py) import it on the card's
machine too.
"""

import asyncio
import base64
import json
import os
import struct

import numpy as np

from openwebrx_tpu_torch.digimodes import psk as pskmod
from openwebrx_tpu_torch.ops.adpcm import SYNC_INTERVAL, adpcm_decode_np

PSK_FS = 48000.0        # tests/test_secondary_bank.py's sample rate


class WsTestClient:
    """Tiny RFC6455 client for protocol tests."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, port, path="/ws/"):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET {path} HTTP/1.1\r\nHost: localhost\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        assert b"101" in head.split(b"\r\n")[0]
        return cls(reader, writer)

    async def send_text(self, text: str):
        await self._send(0x1, text.encode())

    async def _send(self, opcode, payload):
        mask = os.urandom(4)
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        else:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.writer.write(bytes(head) + mask + masked)
        await self.writer.drain()

    async def receive(self):
        while True:
            head = await self.reader.readexactly(2)
            opcode = head[0] & 0x0F
            length = head[1] & 0x7F
            if length == 126:
                length, = struct.unpack(">H", await self.reader.readexactly(2))
            elif length == 127:
                length, = struct.unpack(">Q", await self.reader.readexactly(8))
            payload = await self.reader.readexactly(length) if length else b""
            if opcode == 0x9:  # ping
                await self._send(0xA, payload)
                continue
            return opcode, payload

    async def expect_json(self, msg_type, timeout=10):
        async def _wait():
            while True:
                opcode, payload = await self.receive()
                if opcode == 0x1:
                    msg = json.loads(payload)
                    if msg.get("type") == msg_type:
                        return msg
        return await asyncio.wait_for(_wait(), timeout)

    async def collect_binary(self, prefix, count, timeout=30):
        frames = []

        async def _wait():
            while len(frames) < count:
                opcode, payload = await self.receive()
                if opcode == 0x2 and payload and payload[0] == prefix:
                    frames.append(payload[1:])
            return frames
        return await asyncio.wait_for(_wait(), timeout)

    async def close(self):
        self.writer.close()


def decode_wire(frames: list[bytes]) -> np.ndarray:
    """Decode 0x02 wire bytes (SYNC-framed IMA ADPCM) to int16 PCM."""
    data = b"".join(frames)
    out = []
    pos = 0
    state = (0, 0)
    while pos < len(data):
        if data[pos:pos + 4] == b"SYNC":
            idx, pred = np.frombuffer(data[pos + 4:pos + 8], "<i2")
            state = (int(pred), int(idx))
            pos += 8
        chunk = data[pos:pos + SYNC_INTERVAL]
        pos += len(chunk)
        pcm, state = adpcm_decode_np(chunk, state)
        out.append(pcm)
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def tone_power_ratio(pcm: np.ndarray, f_tone: float, fs: float = 12000.0):
    """Power in ±60 Hz of f_tone relative to total, in dB."""
    x = pcm.astype(np.float32)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f_tone - 60) & (freqs < f_tone + 60)
    total = spec[(freqs > 50)].sum()
    return 10 * np.log10(spec[band].sum() / max(total, 1e-12) + 1e-12)


def pump(rt, src, blocks):
    """Drive the runtime synchronously for N device blocks."""
    src.start()
    for _ in range(blocks):
        b = src.read_block(timeout=5.0)
        assert b is not None
        rt._process_block(b)


def varicode_encode(text: str) -> list[int]:
    bits = []
    for ch in text:
        bits.extend(int(b) for b in pskmod._VARICODE[ord(ch)])
        bits.extend([0, 0])
    return bits


def psk31_iq(text: str, f0: float, amplitude: float = 0.4) -> np.ndarray:
    """BPSK31 IQ of ``text`` on a carrier at ``f0`` Hz, at PSK_FS."""
    baud = 31.25
    bits = [0] * 24 + varicode_encode(text) + [0] * 16
    phases = [1.0]
    for b in bits:
        phases.append(phases[-1] * (1.0 if b else -1.0))
    sym = np.repeat(phases, int(PSK_FS / baud))
    n = np.arange(len(sym))
    return (amplitude * sym * np.exp(2j * np.pi * f0 / PSK_FS * n)) \
        .astype(np.complex64)
