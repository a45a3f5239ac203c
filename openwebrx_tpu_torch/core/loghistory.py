"""In-memory log history ring, shown in the admin UI.

Reference: ``owrx/log/__init__.py:31-52`` — HistoryHandler keeping the
last 200 records, surfaced per source in the settings pages.
"""

from __future__ import annotations

import collections
import logging


class HistoryHandler(logging.Handler):
    _handlers: dict[str, "HistoryHandler"] = {}

    @classmethod
    def get_handler(cls, name: str, maxlen: int = 200) -> "HistoryHandler":
        if name not in cls._handlers:
            handler = cls(maxlen)
            cls._handlers[name] = handler
            logging.getLogger(name).addHandler(handler)
        return cls._handlers[name]

    def __init__(self, maxlen: int = 200):
        super().__init__()
        self.records = collections.deque(maxlen=maxlen)
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))

    def emit(self, record):
        self.records.append(self.format(record))

    def get_lines(self) -> list[str]:
        return list(self.records)
