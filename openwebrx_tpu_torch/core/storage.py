"""Shared file storage for decoded images/recordings with retention.

Reference: ``owrx/storage.py:14-233`` — tmp-dir file store, filename
pattern whitelist, collision renaming, `keep_files` retention cleanup,
DataRecorder mixin for rotating capped files.
"""

from __future__ import annotations

import logging
import os
import re
import threading

logger = logging.getLogger(__name__)

# reference name whitelist (owrx/storage.py:16): conservative pattern
NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class Storage:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "Storage":
        with Storage._lock:
            if Storage._instance is None:
                from openwebrx_tpu_torch.core.config import CoreConfig
                Storage._instance = Storage(
                    os.path.join(CoreConfig.defaults["temporary_directory"],
                                 "storage"))
            return Storage._instance

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def valid_name(self, name: str) -> bool:
        return NAME_RE.match(name) is not None

    def path_for(self, name: str) -> str:
        if not self.valid_name(name):
            raise ValueError(f"invalid storage file name {name!r}")
        return os.path.join(self.directory, name)

    def new_file(self, name: str) -> str:
        """Collision-renaming create (reference: -2, -3 … suffixes)."""
        path = self.path_for(name)
        if not os.path.exists(path):
            return path
        stem, ext = os.path.splitext(name)
        i = 2
        while os.path.exists(self.path_for(f"{stem}-{i}{ext}")):
            i += 1
        return self.path_for(f"{stem}-{i}{ext}")

    def list_files(self) -> list[str]:
        try:
            names = [n for n in os.listdir(self.directory) if self.valid_name(n)]
        except OSError:
            return []
        names.sort(key=lambda n: os.path.getmtime(os.path.join(self.directory, n)),
                   reverse=True)
        return names

    def cleanup(self, keep: int | None = None):
        """Retention: keep the newest `keep_files` files (reference
        owrx/storage.py cleanup)."""
        if keep is None:
            from openwebrx_tpu_torch.core.config import Config
            keep = int(Config.get().get("keep_files", 20))
        for name in self.list_files()[keep:]:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                logger.warning("could not delete %s", name)
