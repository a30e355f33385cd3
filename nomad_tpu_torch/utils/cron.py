"""Cron expression evaluation for periodic jobs (a copy of
``nomad_tpu/utils/cron.py``).

The reference embeds gorhill/cronexpr (used via nomad/periodic.go and
structs.go PeriodicConfig.Next).  This is a 5-field implementation
(minute hour day-of-month month day-of-week) supporting ``*``, lists,
ranges, and ``/step``, plus the common ``@hourly``-style shortcuts, in
the process's local time zone.
"""
from __future__ import annotations

import calendar
import time
from typing import List, Optional, Set

_SHORTCUTS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]

_MONTH_NAMES = {name.lower(): i for i, name in enumerate(calendar.month_abbr) if name}
# cron day-of-week convention: 0=Sunday
_DOW_NAMES = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6}


class CronParseError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int, names=None) -> Set[int]:
    out: Set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError as e:
                raise CronParseError(f"bad step {step_s!r}") from e
            if step <= 0:
                raise CronParseError(f"bad step {step}")
        if part in ("*", "?"):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = _atom(a, names), _atom(b, names)
        else:
            start = _atom(part, names)
            end = start if step == 1 else hi
        if start < lo or end > hi or start > end:
            raise CronParseError(f"field value out of range: {part!r}")
        out.update(range(start, end + 1, step))
    return out


def _atom(s: str, names) -> int:
    s = s.strip().lower()
    if names and s in names:
        return names[s]
    try:
        return int(s)
    except ValueError as e:
        raise CronParseError(f"bad value {s!r}") from e


class CronExpr:
    def __init__(self, spec: str):
        spec = spec.strip()
        spec = _SHORTCUTS.get(spec, spec)
        fields = spec.split()
        # Field-count conventions follow gorhill/cronexpr (used by the
        # reference): 5 = standard; 6 = standard + trailing year;
        # 7 = leading seconds + standard + year (seconds are floored to :00).
        self.years: Optional[Set[int]] = None
        if len(fields) == 7:
            fields = fields[1:]
        if len(fields) == 6:
            year_field = fields[5]
            if year_field not in ("*", "?"):
                self.years = _parse_field(year_field, 1970, 2099)
            fields = fields[:5]
        if len(fields) != 5:
            raise CronParseError(f"expected 5 cron fields, got {len(fields)}")
        self.minutes = _parse_field(fields[0], *_RANGES[0])
        self.hours = _parse_field(fields[1], *_RANGES[1])
        self.dom = _parse_field(fields[2], *_RANGES[2])
        self.months = _parse_field(fields[3], *_RANGES[3], names=_MONTH_NAMES)
        self.dow = _parse_field(fields[4], *_RANGES[4], names=_DOW_NAMES)
        self.dom_star = fields[2] in ("*", "?")
        self.dow_star = fields[4] in ("*", "?")

    def _day_matches(self, tm: time.struct_time) -> bool:
        dow_cron = (tm.tm_wday + 1) % 7  # python Mon=0 → cron Sun=0
        dom_ok = tm.tm_mday in self.dom
        dow_ok = dow_cron in self.dow
        # Standard cron: if both dom and dow are restricted, either may match.
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next(self, after: float) -> float:
        """The next matching time strictly after ``after`` (unix seconds);
        0.0 if none within ~4 years."""
        t = int(after) - (int(after) % 60) + 60
        limit = int(after) + 4 * 366 * 86400
        if self.years:
            # An explicit year field may point far ahead; search to its end.
            horizon = int(time.mktime((max(self.years) + 1, 1, 1, 0, 0, 0, 0, 1, -1)))
            limit = max(limit, horizon)
        while t < limit:
            tm = time.localtime(t)
            if self.years is not None and tm.tm_year not in self.years:
                if all(tm.tm_year > y for y in self.years):
                    return 0.0
                t = int(time.mktime((tm.tm_year + 1, 1, 1, 0, 0, 0, 0, 1, -1)))
                continue
            if tm.tm_mon not in self.months:
                # jump to the 1st of next month
                year, month = tm.tm_year, tm.tm_mon + 1
                if month > 12:
                    year, month = year + 1, 1
                t = int(time.mktime((year, month, 1, 0, 0, 0, 0, 1, -1)))
                continue
            if not self._day_matches(tm):
                # Advance to the next calendar day's midnight; mktime
                # normalizes mday+1 and DST so a 23-hour day can't skip it.
                t = int(time.mktime((tm.tm_year, tm.tm_mon, tm.tm_mday + 1, 0, 0, 0, 0, 1, -1)))
                continue
            if tm.tm_hour not in self.hours:
                t += 3600 - tm.tm_min * 60 - tm.tm_sec
                continue
            if tm.tm_min not in self.minutes:
                t += 60 - tm.tm_sec
                continue
            return float(t)
        return 0.0


def cron_next(spec: str, after: float) -> float:
    return CronExpr(spec).next(after)
