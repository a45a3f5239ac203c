"""Receiver-ID challenge/response signing.

Reference: ``owrx/receiverid.py`` — receiver directories (e.g.
receiverbook) authenticate a listed receiver by sending a
``ReceiverId <source>-<id32>-<challenge32>[,...]`` request header; the
receiver proves key ownership by answering with
``<source>-<id32>-<time8>-<hmac_sha256_64>`` where the HMAC (keyed with
the configured secret) covers challenge bytes + big-endian unix time.
Keys live in config ``receiver_keys`` as ``source-id32hex-secret64hex``.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import re
import time as _time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_KEY_RE = re.compile(r"^([a-zA-Z]+)-([0-9a-f]{32})-([0-9a-f]{64})$")
_CHALLENGE_RE = re.compile(r"^([a-zA-Z]+)-([0-9a-f]{32})-([0-9a-f]{32})$")
_HEADER_RE = re.compile(r"^ReceiverId (.*)$")


class KeyError_(Exception):
    pass


@dataclass
class Key:
    source: str
    id: str
    secret: str

    @classmethod
    def parse(cls, key_string: str) -> "Key":
        m = _KEY_RE.match(key_string)
        if not m:
            raise KeyError_("invalid key format")
        return cls(m.group(1), m.group(2), m.group(3))


@dataclass
class KeyChallenge:
    source: str
    id: str
    challenge: str

    @classmethod
    def parse(cls, challenge_string: str) -> "KeyChallenge":
        m = _CHALLENGE_RE.match(challenge_string)
        if not m:
            raise KeyError_("invalid key challenge format")
        return cls(m.group(1), m.group(2), m.group(3))


def sign_challenge(challenge: KeyChallenge, key: Key,
                   now: int | None = None) -> str:
    """HMAC-SHA256(secret, challenge_bytes || time_be32) → response string."""
    ts = int(now if now is not None else _time.time())
    time_bytes = ts.to_bytes(4, byteorder="big")
    mac = hmac.new(bytes.fromhex(key.secret), digestmod=hashlib.sha256)
    mac.update(bytes.fromhex(challenge.challenge))
    mac.update(time_bytes)
    return f"{challenge.source}-{challenge.id}-{time_bytes.hex()}-{mac.hexdigest()}"


def _configured_keys() -> list[Key]:
    from openwebrx_tpu_torch.core.config import Config
    keys = []
    for key_string in Config.get().get("receiver_keys") or []:
        try:
            keys.append(Key.parse(key_string))
        except KeyError_ as e:
            logger.error("%s: %r", e, key_string)
    return keys


def find_key(challenge: KeyChallenge) -> Key | None:
    for key in _configured_keys():
        if key.source == challenge.source and key.id == challenge.id:
            return key
    return None


def response_header(request_header: str, now: int | None = None) -> str:
    """Answer a ``ReceiverId ...`` header; unknown/invalid challenges are
    silently dropped (reference behavior)."""
    m = _HEADER_RE.match(request_header)
    if not m:
        raise KeyError_("invalid authorization header")
    responses = []
    for part in m.group(1).split(","):
        try:
            challenge = KeyChallenge.parse(part.strip())
        except KeyError_:
            continue
        key = find_key(challenge)
        if key is not None:
            responses.append(sign_challenge(challenge, key, now))
    return ",".join(responses)
