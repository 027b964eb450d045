"""No-leap (365-day) calendar: Date, Ticker, and monthly-interpolation
helpers — host-side Python.

The port's own copy of ``elmkernels_tpu/utils/dates.py``: a rebuild of
the reference's ``src/utils/date_time.hh:12-301`` and
``src/data/monthly_data.cc`` (month fraction / bracketing indices /
weights, centered-on-mid-month scheme documented in ``monthly_data.h``).
"""

from __future__ import annotations

import dataclasses

DAYS_PER_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
SEC_PER_DAY = 86400


def to_doy(month: int, day: int) -> int:
    return sum(DAYS_PER_MONTH[:month - 1]) + day - 1


def to_date(year: int, doy: int) -> tuple[int, int, int]:
    assert 0 <= doy < 365
    month = 0
    while doy >= 0:
        doy -= DAYS_PER_MONTH[month]
        month += 1
    doy += DAYS_PER_MONTH[month - 1]
    return year, month, doy + 1


@dataclasses.dataclass
class Date:
    """A date on the no-leap calendar (year, day-of-year, second-of-day)."""
    year: int = 0
    doy: int = 0
    sec: int = 0

    @classmethod
    def from_ymd(cls, year: int, month: int, day: int,
                 seconds: int = 0) -> "Date":
        d = cls(year, to_doy(month, day))
        d.increment_seconds(seconds)
        return d

    def date(self) -> tuple[int, int, int]:
        return to_date(self.year, self.doy)

    @property
    def month(self) -> int:
        return self.date()[1]

    @property
    def day(self) -> int:
        return self.date()[2]

    def copy(self) -> "Date":
        return Date(self.year, self.doy, self.sec)

    def increment_day(self, days: int = 1) -> "Date":
        self.doy += days
        while self.doy >= 365:
            self.year += 1
            self.doy -= 365
        while self.doy < 0:
            self.year -= 1
            self.doy += 365
        return self

    def increment_month(self, months: int = 1) -> "Date":
        for _ in range(months):
            self.increment_day(DAYS_PER_MONTH[self.month - 1])
        return self

    def increment_seconds(self, seconds: int) -> "Date":
        self.sec += seconds
        while self.sec >= SEC_PER_DAY:
            self.increment_day()
            self.sec -= SEC_PER_DAY
        while self.sec < 0:
            self.increment_day(-1)
            self.sec += SEC_PER_DAY
        return self

    def decimal_doy(self) -> float:
        return self.doy + self.sec / 86400.0

    def days_since(self, other: "Date") -> float:
        return (self.decimal_doy() - other.decimal_doy()
                + 365.0 * (self.year - other.year))

    def months_since(self, other: "Date") -> int:
        y1, m1, _ = self.date()
        y2, m2, _ = other.date()
        return (m1 - m2) + 12 * (y1 - y2)

    def _key(self):
        return (self.year, self.doy, self.sec)

    def __lt__(self, o): return self._key() < o._key()
    def __le__(self, o): return self._key() <= o._key()
    def __gt__(self, o): return self._key() > o._key()
    def __ge__(self, o): return self._key() >= o._key()
    def __eq__(self, o): return self._key() == o._key()

    def __repr__(self):
        y, m, d = self.date()
        return f"{y:04d}-{m:02d}-{d:02d}+{self.sec}s"


@dataclasses.dataclass
class Ticker:
    """Sub-daily step counter anchored at a start date."""
    start: Date
    ticks_per_day: int
    days: int = 0
    ticks: int = 0

    def now(self) -> Date:
        d = self.start.copy()
        d.increment_day(self.days)
        d.increment_seconds(self.ticks * (SEC_PER_DAY // self.ticks_per_day))
        return d

    def ticks_since(self) -> int:
        return self.ticks + self.ticks_per_day * self.days

    def advance(self, d_ticks: int = 1) -> "Ticker":
        self.ticks += d_ticks
        while self.ticks >= self.ticks_per_day:
            self.days += 1
            self.ticks -= self.ticks_per_day
        while self.ticks < 0:
            self.days -= 1
            self.ticks += self.ticks_per_day
        return self


# ---------------------------------------------------------------------------
# monthly interpolation helpers (reference: monthly_data.cc)
# ---------------------------------------------------------------------------

def month_frac(t: Date) -> float:
    """Elapsed fraction of the current month."""
    _, kmo, kda = t.date()
    return (kda - 1 + t.sec / 86400.0) / DAYS_PER_MONTH[kmo - 1]


def first_month_idx(t: Date) -> int:
    t1 = 0 if month_frac(t) < 0.5 else 1
    m1 = t.month + t1 - 2
    return 11 if m1 < 0 else m1


def month_indices(t: Date) -> tuple[int, int]:
    m1 = first_month_idx(t)
    m2 = m1 + 1
    return m1, 0 if m2 > 11 else m2


def monthly_data_weights(t: Date) -> tuple[float, float]:
    frac = month_frac(t)
    t1 = 0 if frac < 0.5 else 1
    wt1 = (t1 + 0.5) - frac
    return wt1, 1.0 - wt1


def triple_month_indices(t: Date) -> tuple[int, int, int]:
    m1, m2 = month_indices(t)
    m3 = m2 + 1
    return m1, m2, 0 if m3 > 11 else m3
