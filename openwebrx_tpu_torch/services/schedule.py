"""Service scheduler: timed profile switching per device.

Reference: ``owrx/service/schedule.py:13-315`` — static ``HHMM-HHMM``
schedules and computed daylight schedules (sunrise/sunset math with
greyline slots), armed with timers, switching profiles while the device
is idle.
"""

from __future__ import annotations

import logging
import math
import threading
from datetime import datetime, timedelta, timezone

logger = logging.getLogger(__name__)


class TimeRange:
    def __init__(self, start: datetime, end: datetime, profile_id: str):
        self.start = start
        self.end = end
        self.profile_id = profile_id

    def contains(self, when: datetime) -> bool:
        return self.start <= when < self.end

    def __repr__(self):
        return f"<{self.profile_id}: {self.start:%H:%M}-{self.end:%H:%M}>"


class Schedule:
    def get_current_entry(self, when: datetime) -> TimeRange | None:
        for entry in self.get_entries(when):
            if entry.contains(when):
                return entry
        return None

    def get_next_change(self, when: datetime) -> datetime | None:
        times = []
        for entry in self.get_entries(when) + self.get_entries(when + timedelta(days=1)):
            for t in (entry.start, entry.end):
                if t > when:
                    times.append(t)
        return min(times) if times else None

    def get_entries(self, when: datetime) -> list[TimeRange]:
        raise NotImplementedError


class StaticSchedule(Schedule):
    """{"HHMM-HHMM": profile_id, ...} (reference StaticSchedule)."""

    def __init__(self, table: dict):
        self.table = table

    def get_entries(self, when: datetime) -> list[TimeRange]:
        day = when.replace(hour=0, minute=0, second=0, microsecond=0)
        entries = []
        for window, profile_id in self.table.items():
            try:
                start_s, end_s = window.split("-")
                start = day + timedelta(hours=int(start_s[:2]), minutes=int(start_s[2:]))
                end = day + timedelta(hours=int(end_s[:2]), minutes=int(end_s[2:]))
            except (ValueError, IndexError):
                continue
            if end <= start:  # crosses midnight
                end += timedelta(days=1)
            entries.append(TimeRange(start, end, profile_id))
        return entries


def sun_times(lat: float, lon: float, date: datetime) -> tuple[datetime, datetime] | None:
    """Approximate sunrise/sunset (UTC) via the standard NOAA-style solar
    position formulas; None in polar day/night."""
    n = date.timetuple().tm_yday
    lat_r = math.radians(lat)
    # solar declination
    decl = math.radians(-23.44) * math.cos(math.radians(360 / 365 * (n + 10)))
    cos_ha = (math.sin(math.radians(-0.83)) - math.sin(lat_r) * math.sin(decl)) / \
        (math.cos(lat_r) * math.cos(decl))
    if cos_ha < -1 or cos_ha > 1:
        return None
    ha = math.degrees(math.acos(cos_ha))
    solar_noon_utc = 12.0 - lon / 15.0
    sunrise = solar_noon_utc - ha / 15.0
    sunset = solar_noon_utc + ha / 15.0
    day = date.replace(hour=0, minute=0, second=0, microsecond=0,
                       tzinfo=timezone.utc)
    return (day + timedelta(hours=sunrise % 24), day + timedelta(hours=sunset % 24))


class DaylightSchedule(Schedule):
    """{"day"/"night"/"greyline": profile_id} using receiver GPS (reference
    DaylightSchedule, owrx/service/schedule.py:137-172)."""

    GREYLINE = timedelta(hours=1)

    def __init__(self, table: dict, lat: float, lon: float):
        self.table = table
        self.lat = lat
        self.lon = lon

    def get_entries(self, when: datetime) -> list[TimeRange]:
        times = sun_times(self.lat, self.lon, when)
        if times is None:
            profile = self.table.get("day") or self.table.get("night")
            day = when.replace(hour=0, minute=0, second=0, microsecond=0)
            return [TimeRange(day, day + timedelta(days=1), profile)] if profile else []
        sunrise, sunset = times
        entries = []
        if "greyline" in self.table:
            for t in (sunrise, sunset):
                entries.append(TimeRange(t - self.GREYLINE, t + self.GREYLINE,
                                         self.table["greyline"]))
            if "day" in self.table:
                entries.append(TimeRange(sunrise + self.GREYLINE,
                                         sunset - self.GREYLINE, self.table["day"]))
            if "night" in self.table:
                entries.append(TimeRange(sunset + self.GREYLINE,
                                         sunrise - self.GREYLINE + timedelta(days=1),
                                         self.table["night"]))
        else:
            if "day" in self.table:
                entries.append(TimeRange(sunrise, sunset, self.table["day"]))
            if "night" in self.table:
                entries.append(TimeRange(sunset, sunrise + timedelta(days=1),
                                         self.table["night"]))
        return entries


class ServiceScheduler:
    """Arms a timer for the next schedule change and switches the device
    profile when it fires (reference ServiceScheduler)."""

    def __init__(self, source, schedule: Schedule, clock=datetime.utcnow):
        self.source = source
        self.schedule = schedule
        self.clock = clock
        self._timer: threading.Timer | None = None
        self.apply()

    def apply(self):
        now = self.clock()
        entry = self.schedule.get_current_entry(now)
        if entry is not None:
            logger.info("scheduler: activating profile %s", entry.profile_id)
            self.source.activate_profile(entry.profile_id)
        nxt = self.schedule.get_next_change(now)
        if nxt is not None:
            delay = max(1.0, (nxt - now).total_seconds())
            self._timer = threading.Timer(delay, self.apply)
            self._timer.daemon = True
            self._timer.start()

    def stop(self):
        if self._timer is not None:
            self._timer.cancel()
