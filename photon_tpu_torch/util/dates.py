"""Date-partitioned input resolution (reference photon-client
util/DateRange.scala, DaysRange.scala and IOUtils.getInputPathsWithinDateRange:
input dirs laid out as ``<root>/daily/yyyy/MM/dd``).

Copy of photon_tpu/util/dates.py."""
from __future__ import annotations

import dataclasses
import datetime as _dt
import os
import re

_DATE_RE = re.compile(r"^(\d{4})(\d{2})(\d{2})$")
_RANGE_SEP = "-"


def _parse_date(s: str) -> _dt.date:
    m = _DATE_RE.match(s.strip())
    if not m:
        raise ValueError(f"bad date {s!r}; expected yyyyMMdd")
    return _dt.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] date range, parsed from ``yyyyMMdd-yyyyMMdd``."""

    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(f"start {self.start} after end {self.end}")

    @staticmethod
    def parse(s: str) -> "DateRange":
        parts = s.split(_RANGE_SEP)
        if len(parts) != 2:
            raise ValueError(f"bad date range {s!r}; expected yyyyMMdd-yyyyMMdd")
        return DateRange(_parse_date(parts[0]), _parse_date(parts[1]))

    def dates(self) -> list[_dt.date]:
        n = (self.end - self.start).days + 1
        return [self.start + _dt.timedelta(days=i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """Relative range ``start-end`` in days-ago, resolved against today
    (reference DaysRange.toDateRange)."""

    start_days_ago: int
    end_days_ago: int

    def __post_init__(self):
        if self.start_days_ago < self.end_days_ago:
            raise ValueError("start (further past) must be >= end (nearer past)")

    @staticmethod
    def parse(s: str) -> "DaysRange":
        parts = s.split(_RANGE_SEP)
        if len(parts) != 2:
            raise ValueError(f"bad days range {s!r}; expected start-end")
        return DaysRange(int(parts[0]), int(parts[1]))

    def to_date_range(self, today: _dt.date | None = None) -> DateRange:
        today = today or _dt.date.today()
        return DateRange(
            today - _dt.timedelta(days=self.start_days_ago),
            today - _dt.timedelta(days=self.end_days_ago),
        )


def resolve_date_range_paths(
    root: str | os.PathLike,
    date_range: DateRange,
    *,
    require_exists: bool = True,
) -> list[str]:
    """Expand ``<root>/daily/yyyy/MM/dd`` paths within the range."""
    root = str(root)
    paths = []
    for d in date_range.dates():
        p = os.path.join(root, "daily", f"{d.year:04d}", f"{d.month:02d}", f"{d.day:02d}")
        if not require_exists or os.path.isdir(p):
            paths.append(p)
    if require_exists and not paths:
        raise FileNotFoundError(
            f"no daily partitions under {root} within {date_range}"
        )
    return paths
