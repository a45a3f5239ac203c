"""User store + password handling + cookie sessions.

Reference: ``owrx/users.py:18-237`` (JSON user file, cleartext + PBKDF2
passwords, must-change flow) and ``owrx/controllers/session.py:13-52``
(in-memory cookie sessions, 6 h lifetime).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import secrets
import threading
import time

SESSION_LIFETIME = 6 * 60 * 60


class Password:
    @staticmethod
    def from_dict(data: dict) -> "Password":
        if data.get("encoding") == "hash":
            return HashedPassword(data["value"], data["algorithm"], data["salt"],
                                  data.get("iterations", 10000))
        return CleartextPassword(data.get("value", ""))

    @staticmethod
    def create(value: str) -> "HashedPassword":
        salt = secrets.token_hex(16)
        iterations = 100000
        digest = hashlib.pbkdf2_hmac("sha256", value.encode(),
                                     bytes.fromhex(salt), iterations)
        return HashedPassword(base64.b64encode(digest).decode(), "sha256",
                              salt, iterations)

    def is_valid(self, value: str) -> bool:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


class CleartextPassword(Password):
    def __init__(self, value: str):
        self.value = value

    def is_valid(self, value: str) -> bool:
        return secrets.compare_digest(self.value, value)

    def to_json(self):
        return {"encoding": "string", "value": self.value}


class HashedPassword(Password):
    def __init__(self, value: str, algorithm: str, salt: str, iterations: int):
        self.value = value
        self.algorithm = algorithm
        self.salt = salt
        self.iterations = iterations

    def is_valid(self, value: str) -> bool:
        digest = hashlib.pbkdf2_hmac(self.algorithm, value.encode(),
                                     bytes.fromhex(self.salt), self.iterations)
        return secrets.compare_digest(base64.b64encode(digest).decode(), self.value)

    def to_json(self):
        return {"encoding": "hash", "value": self.value,
                "algorithm": self.algorithm, "salt": self.salt,
                "iterations": self.iterations}


class User:
    def __init__(self, name: str, enabled: bool, password: Password,
                 must_change_password: bool = False):
        self.name = name
        self.enabled = enabled
        self.password = password
        self.must_change_password = must_change_password

    def to_json(self):
        return {"user": self.name, "enabled": self.enabled,
                "must_change_password": self.must_change_password,
                "password": self.password.to_json()}


class UserList:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "UserList":
        with UserList._lock:
            if UserList._instance is None:
                from openwebrx_tpu_torch.core.config import CoreConfig
                path = os.path.join(CoreConfig.defaults["data_directory"],
                                    "users.json")
                UserList._instance = UserList(path)
            return UserList._instance

    def __init__(self, path: str | None = None):
        self.path = path
        self.users: dict[str, User] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    for entry in json.load(f):
                        self.users[entry["user"]] = User(
                            entry["user"], entry.get("enabled", True),
                            Password.from_dict(entry.get("password", {})),
                            entry.get("must_change_password", False))
            except (OSError, json.JSONDecodeError, KeyError):
                pass

    def store(self):
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump([u.to_json() for u in self.users.values()], f, indent=2)
        os.replace(tmp, self.path)
        os.chmod(self.path, 0o600)

    def add_user(self, name: str, password: str, must_change: bool = False):
        self.users[name] = User(name, True, Password.create(password), must_change)
        self.store()

    def delete_user(self, name: str):
        if name in self.users:
            del self.users[name]
            self.store()

    def set_enabled(self, name: str, enabled: bool):
        if name in self.users:
            self.users[name].enabled = enabled
            self.store()

    def set_password(self, name: str, password: str, must_change: bool = False):
        if name in self.users:
            self.users[name].password = Password.create(password)
            self.users[name].must_change_password = must_change
            self.store()

    def authenticate(self, name: str, password: str) -> User | None:
        user = self.users.get(name)
        if user is not None and user.enabled and user.password.is_valid(password):
            return user
        return None

    def __contains__(self, name):
        return name in self.users

    def values(self):
        return self.users.values()


class SessionStorage:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "SessionStorage":
        with SessionStorage._lock:
            if SessionStorage._instance is None:
                SessionStorage._instance = SessionStorage()
            return SessionStorage._instance

    def __init__(self):
        self.sessions: dict[str, dict] = {}

    def create(self, data: dict) -> str:
        key = secrets.token_urlsafe(32)
        self.sessions[key] = {"data": data, "expires": time.time() + SESSION_LIFETIME}
        return key

    def get(self, key: str) -> dict | None:
        session = self.sessions.get(key)
        if session is None:
            return None
        if session["expires"] < time.time():
            del self.sessions[key]
            return None
        return session["data"]

    def prolong(self, key: str):
        if key in self.sessions:
            self.sessions[key]["expires"] = time.time() + SESSION_LIFETIME

    def invalidate(self, key: str):
        self.sessions.pop(key, None)
