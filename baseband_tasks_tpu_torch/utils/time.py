"""Two-double precision time scale for baseband_tasks_tpu_torch.

Replaces ``astropy.time.Time`` for this framework.  A :class:`Time` holds a
pair of float64 Julian dates ``(jd1, jd2)`` whose *sum* is the true Julian
date; keeping ``jd2`` small preserves ~10 ps resolution near any epoch,
which comfortably exceeds the ~ns bookkeeping the reference needs
(`upstream baseband_tasks/base.py:312-377` seeks streams by absolute
Time; `upstream baseband_tasks/phases/core.py:34-36` quotes ~10 ns
phase-model precision).

All arithmetic uses error-free two-sum (Knuth/Dekker) so that
``(t + dt) - t == dt`` to float64 rounding of the *small* component.

Host-only: never used inside device code.  Device kernels receive sample
offsets (ints) and rates (floats); absolute time stays on the host.
"""

from __future__ import annotations

import re

import numpy as np

from . import units as u

__all__ = ["Time", "TimeDelta", "two_sum", "delta_at"]

SECONDS_PER_DAY = 86400.0
MJD_ZEROPOINT = 2400000.5
TT_MINUS_TAI_SEC = 32.184


def two_sum(a, b):
    """Error-free transformation: a + b = hi + lo exactly."""
    hi = a + b
    v = hi - a
    lo = (a - (hi - v)) + (b - v)
    return hi, lo


def _split(a):
    """Dekker split of a float64 into two 26-bit halves."""
    c = 134217729.0 * a  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free transformation: a * b = p + err exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def two_div(a, b):
    """a / b = q + err to full double-double precision."""
    q = a / b
    ph, pl = two_prod(q, b)
    return q, ((a - ph) - pl) / b


def _normalize(jd1, jd2):
    """Renormalize so jd1 carries the big part and jd2 the residual."""
    hi, lo = two_sum(jd1, jd2)
    return hi, lo


class TimeDelta:
    """A duration held as a two-double pair of days."""

    __slots__ = ("d1", "d2")

    def __init__(self, d1, d2=0.0):
        if isinstance(d1, TimeDelta):
            d1, d2 = d1.d1, d1.d2 + d2
        elif isinstance(d1, u.Quantity):
            d1 = d1.to_value(u.day)
        d1 = np.asarray(d1, dtype=np.float64)
        d2 = np.asarray(d2, dtype=np.float64)
        self.d1, self.d2 = _normalize(d1, d2)

    @classmethod
    def from_sec(cls, sec1, sec2=0.0):
        # compensated division: the rounding error of sec1/86400 alone
        # is ~0.5 sample at GHz rates for month-scale durations
        q, err = two_div(np.asarray(sec1, dtype=np.float64),
                         SECONDS_PER_DAY)
        return cls(q, err + np.asarray(sec2, dtype=np.float64)
                   / SECONDS_PER_DAY)

    @classmethod
    def from_samples(cls, n, rate_hz):
        """Exact two-double duration of ``n`` samples at ``rate_hz``.

        Compensated division (two_div) so hi + err == n/rate to full
        double-double precision even at petasample offsets (the shared
        sample<->time conversion used by stream bookkeeping: never bare
        float64 seconds)."""
        hi, err = two_div(np.asarray(n, dtype=np.float64), float(rate_hz))
        return cls.from_sec(hi, err)

    @property
    def jd(self):
        return self.d1 + self.d2

    @property
    def sec(self):
        """Duration in seconds (lossy single float64)."""
        return (self.d1 + self.d2) * SECONDS_PER_DAY \
            if np.ndim(self.d1) else float((self.d1 + self.d2) * SECONDS_PER_DAY)

    @property
    def sec_pair(self):
        """Duration as an exact (hi, lo) pair of seconds (compensated
        product: d1*86400 alone rounds by ~0.5 ns per month of span)."""
        p, err = two_prod(self.d1, SECONDS_PER_DAY)
        return _normalize(p, err + self.d2 * SECONDS_PER_DAY)

    def to(self, unit):
        return u.Quantity(self.sec, u.s).to(unit)

    def to_value(self, unit):
        return self.to(unit).value

    @property
    def shape(self):
        return np.shape(self.d1)

    @property
    def isscalar(self):
        return np.ndim(self.d1) == 0

    def __add__(self, other):
        if isinstance(other, Time):
            return other + self
        other = TimeDelta(other) if not isinstance(other, TimeDelta) else other
        hi, lo = two_sum(self.d1, other.d1)
        return TimeDelta(hi, lo + self.d2 + other.d2)

    __radd__ = __add__

    def __sub__(self, other):
        other = TimeDelta(other) if not isinstance(other, TimeDelta) else other
        return self + (-other)

    def __neg__(self):
        return TimeDelta(-self.d1, -self.d2)

    def __mul__(self, k):
        if isinstance(k, u.Quantity):
            k = k.to_value(u.dimensionless)
        return TimeDelta(self.d1 * k, self.d2 * k)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, TimeDelta):
            return (self.d1 + self.d2) / (other.d1 + other.d2)
        if isinstance(other, u.Quantity):
            return u.Quantity(self.sec, u.s) / other
        return TimeDelta(self.d1 / other, self.d2 / other)

    def _cmp(self, other):
        other = TimeDelta(other) if not isinstance(other, TimeDelta) else other
        return (self.d1 - other.d1) + (self.d2 - other.d2)

    def __lt__(self, other):
        return self._cmp(other) < 0

    def __le__(self, other):
        return self._cmp(other) <= 0

    def __gt__(self, other):
        return self._cmp(other) > 0

    def __ge__(self, other):
        return self._cmp(other) >= 0

    def __eq__(self, other):
        try:
            return self._cmp(other) == 0
        except Exception:
            return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else ~np.asarray(eq) \
            if np.ndim(eq) else not eq

    def __abs__(self):
        neg = (self.d1 + self.d2) < 0
        if np.ndim(self.d1) == 0:
            return -self if neg else self
        return TimeDelta(np.where(neg, -self.d1, self.d1),
                         np.where(neg, -self.d2, self.d2))

    def __getitem__(self, item):
        return TimeDelta(np.asarray(self.d1)[item], np.asarray(self.d2)[item])

    def __repr__(self):
        return f"<TimeDelta {self.sec} s>"


_ISOT_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2}):(\d{2})(?::(\d{2}(?:\.\d+)?))?)?$")


def _cal_to_jd(year, month, day):
    """Gregorian calendar date -> integer-offset Julian date (Fliegel-Van Flandern).

    Returns JD at noon of that date (an integer as float).
    """
    a = (14 - month) // 12
    y = year + 4800 - a
    mth = month + 12 * a - 3
    jdn = day + (153 * mth + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045
    return float(jdn)


def _jd_to_cal(jdn):
    """Integer Julian day number -> (year, month, day)."""
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    mth = (5 * e + 2) // 153
    day = e - (153 * mth + 2) // 5 + 1
    month = mth + 3 - 12 * (mth // 10)
    year = 100 * b + d - 4800 + mth // 10
    return year, month, day


# -- leap seconds ---------------------------------------------------------
# TAI - UTC step table (IERS Bulletin C; complete as of 2017-01-01, the
# most recent leap second).  MJDs are computed from the calendar dates so
# the table cannot drift from the calendar conversion above.
_LEAP_ENTRIES = [
    (1972, 1, 10), (1972, 7, 11), (1973, 1, 12), (1974, 1, 13),
    (1975, 1, 14), (1976, 1, 15), (1977, 1, 16), (1978, 1, 17),
    (1979, 1, 18), (1980, 1, 19), (1981, 7, 20), (1982, 7, 21),
    (1983, 7, 22), (1985, 7, 23), (1988, 1, 24), (1990, 1, 25),
    (1991, 1, 26), (1992, 7, 27), (1993, 7, 28), (1994, 7, 29),
    (1996, 1, 30), (1997, 7, 31), (1999, 1, 32), (2006, 1, 33),
    (2009, 1, 34), (2012, 7, 35), (2015, 7, 36), (2017, 1, 37),
]
_LEAP_MJD = np.array([_cal_to_jd(y, m, 1) - 0.5 - MJD_ZEROPOINT
                      for y, m, _ in _LEAP_ENTRIES], dtype=np.float64)
_LEAP_TAI_UTC = np.array([d for _, _, d in _LEAP_ENTRIES], dtype=np.float64)


def delta_at(mjd_utc):
    """TAI - UTC in seconds at the given UTC MJD.

    Step function over the IERS leap-second table; clamped to the first
    entry (10 s) before 1972 and held at the last entry (37 s, current
    since 2017-01-01) afterwards — the same data astropy's ERFA bundles
    (the reference relies on astropy Time for this,
    upstream baseband_tasks/base.py:312-377).
    """
    idx = np.searchsorted(_LEAP_MJD, np.asarray(mjd_utc), side="right") - 1
    idx = np.clip(idx, 0, len(_LEAP_TAI_UTC) - 1)
    out = _LEAP_TAI_UTC[idx]
    return out if np.ndim(mjd_utc) else float(out)


_SCALES = ("utc", "tai", "tt")


class Time:
    """An absolute epoch as a two-double Julian date, with a timescale.

    Construct from MJD (``Time(mjd, format='mjd')`` or ``Time.from_mjd``),
    ISO string (``Time('2018-01-01T12:00:00.0')``), or a raw ``(jd1, jd2)``
    pair.  ``scale`` is one of ``'utc'`` (default — what baseband file
    timestamps are in), ``'tai'`` or ``'tt'``; ``.utc``/``.tai``/``.tt``
    convert.  Arithmetic is scale-correct the way astropy's Time is (the
    reference leans on that, upstream baseband_tasks/base.py:312-377):
    differences and offsets of UTC times are measured in true SI seconds by
    routing through TAI, so durations spanning a leap second come out 1 s
    longer than the wall-clock label difference.  The inserted second
    itself (``23:59:60``) has no JD representation and cannot be
    constructed or formatted — the only deviation from astropy, and one no
    baseband stream timestamp falls on in practice.
    """

    __slots__ = ("jd1", "jd2", "scale")

    def __init__(self, value, jd2=None, format=None, scale=None):
        if isinstance(value, Time):
            # astropy semantics: Time(t, scale=...) CONVERTS to the
            # requested scale (same instant), never relabels the pair
            if scale is not None and self._chk(scale) != value.scale:
                value = value.to_scale(scale)
            self.jd1, self.jd2 = value.jd1, value.jd2
            self.scale = value.scale
            return
        self.scale = self._chk(scale) if scale is not None else "utc"
        if isinstance(value, str):
            self.jd1, self.jd2 = self._parse_isot(value)
            return
        if isinstance(value, (list, tuple)) and value and isinstance(value[0], (str, Time)):
            parts = [Time(v, scale=scale) for v in value]
            self.jd1 = np.array([p.jd1 for p in parts])
            self.jd2 = np.array([p.jd2 for p in parts])
            return
        if isinstance(value, np.ndarray) and value.dtype.kind == "U":
            parts = [Time(str(v), scale=scale) for v in value.ravel()]
            self.jd1 = np.array([p.jd1 for p in parts]).reshape(value.shape)
            self.jd2 = np.array([p.jd2 for p in parts]).reshape(value.shape)
            return
        value = np.asarray(value, dtype=np.float64)
        if format == "mjd":
            extra = np.asarray(jd2, dtype=np.float64) if jd2 is not None else 0.0
            hi, lo = two_sum(value, MJD_ZEROPOINT)
            self.jd1, self.jd2 = _normalize(hi, lo + extra)
        elif format in (None, "jd"):
            extra = np.asarray(jd2, dtype=np.float64) if jd2 is not None else 0.0
            self.jd1, self.jd2 = _normalize(value, extra)
        else:
            raise ValueError(f"unknown time format {format!r}")

    @staticmethod
    def _chk(scale):
        if scale not in _SCALES:
            raise ValueError(f"unknown timescale {scale!r}; "
                             f"supported: {_SCALES}")
        return scale

    # -- timescale conversions --------------------------------------------
    def _shifted_days(self, d, scale):
        """New Time offset by ``d`` days, compensated so the pair sum is
        exact (a bare ``jd2 + d`` float add would cost ~5 ps)."""
        s, e = two_sum(self.jd2, d)
        hi, lo = two_sum(self.jd1, s)
        return Time(hi, lo + e, scale=scale)

    @property
    def tai(self):
        if self.scale == "tai":
            return self
        if self.scale == "utc":
            return self._shifted_days(delta_at(self.mjd) / SECONDS_PER_DAY,
                                      "tai")
        # tt
        return self._shifted_days(-TT_MINUS_TAI_SEC / SECONDS_PER_DAY, "tai")

    @property
    def utc(self):
        if self.scale == "utc":
            return self
        t = self.tai
        # delta_at is keyed on UTC; two fixed-point passes settle any
        # boundary straddle (the step is 1 s, far below an era's width)
        guess = t._shifted_days(-delta_at(t.mjd) / SECONDS_PER_DAY, "utc")
        return t._shifted_days(-delta_at(guess.mjd) / SECONDS_PER_DAY, "utc")

    @property
    def tt(self):
        if self.scale == "tt":
            return self
        return self.tai._shifted_days(TT_MINUS_TAI_SEC / SECONDS_PER_DAY,
                                      "tt")

    def to_scale(self, scale):
        return getattr(self, self._chk(scale))

    @staticmethod
    def _parse_isot(string):
        match = _ISOT_RE.match(string.strip())
        if not match:
            raise ValueError(f"cannot parse time string {string!r}")
        yy, mo, dd = (int(match.group(i)) for i in range(1, 4))
        hh = int(match.group(4) or 0)
        mm = int(match.group(5) or 0)
        ss = float(match.group(6) or 0.0)
        jd_noon = _cal_to_jd(yy, mo, dd)
        frac_day = (hh * 3600.0 + mm * 60.0 + ss) / SECONDS_PER_DAY - 0.5
        return _normalize(jd_noon, frac_day)

    @classmethod
    def from_mjd(cls, mjd, frac=0.0, scale=None):
        return cls(mjd, frac, format="mjd", scale=scale)

    # -- views ----------------------------------------------------------
    @property
    def jd(self):
        return self.jd1 + self.jd2

    @property
    def mjd(self):
        hi, lo = two_sum(self.jd1, -MJD_ZEROPOINT)
        return hi + (lo + self.jd2)

    @property
    def mjd_pair(self):
        """(hi, lo) float64 pair whose sum is the exact MJD."""
        hi, lo = two_sum(self.jd1, -MJD_ZEROPOINT)
        hi2, lo2 = two_sum(hi, lo + self.jd2)
        return hi2, lo2

    @property
    def unix(self):
        """Seconds since 1970-01-01T00:00:00 on this scale (lossy)."""
        return (self.mjd - 40587.0) * SECONDS_PER_DAY

    @property
    def shape(self):
        return np.shape(self.jd1)

    @property
    def ndim(self):
        return np.ndim(self.jd1)

    @property
    def isscalar(self):
        return np.ndim(self.jd1) == 0

    def __getitem__(self, item):
        return Time(np.asarray(self.jd1)[item], np.asarray(self.jd2)[item],
                    scale=self.scale)

    def reshape(self, shape):
        return Time(np.reshape(self.jd1, shape), np.reshape(self.jd2, shape),
                    scale=self.scale)

    def ravel(self):
        return Time(np.ravel(self.jd1), np.ravel(self.jd2),
                    scale=self.scale)

    # -- arithmetic ------------------------------------------------------
    # TimeDelta is a duration in SI seconds; on the (uniform) TAI/TT
    # scales it adds directly, while UTC routes through TAI so that
    # offsets crossing a leap second land on the correct wall-clock
    # label.  Within one leap era the delta_at offset cancels exactly
    # (the same float is added and subtracted through compensated sums),
    # so non-spanning arithmetic is unchanged from a uniform scale.
    def __add__(self, other):
        if isinstance(other, u.Quantity):
            other = TimeDelta.from_sec(other.to_value(u.s))
        if not isinstance(other, TimeDelta):
            return NotImplemented
        if self.scale == "utc":
            return (self.tai + other).utc
        hi, lo = two_sum(self.jd1, other.d1)
        return Time(hi, lo + self.jd2 + other.d2, scale=self.scale)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Time):
            a = self if self.scale == "tai" else self.tai
            b = other if other.scale == "tai" else other.tai
            hi, lo = two_sum(a.jd1, -b.jd1)
            return TimeDelta(hi, lo + (a.jd2 - b.jd2))
        if isinstance(other, u.Quantity):
            other = TimeDelta.from_sec(other.to_value(u.s))
        if isinstance(other, TimeDelta):
            return self + (-other)
        return NotImplemented

    def _cmp(self, other):
        if not isinstance(other, Time):
            return NotImplemented
        if other.scale != self.scale:
            other = other.to_scale(self.scale) if self.scale != "utc" \
                else other.utc
        return (self.jd1 - other.jd1) + (self.jd2 - other.jd2)

    def __lt__(self, other):
        d = self._cmp(other)
        return NotImplemented if d is NotImplemented else d < 0

    def __le__(self, other):
        d = self._cmp(other)
        return NotImplemented if d is NotImplemented else d <= 0

    def __gt__(self, other):
        d = self._cmp(other)
        return NotImplemented if d is NotImplemented else d > 0

    def __ge__(self, other):
        d = self._cmp(other)
        return NotImplemented if d is NotImplemented else d >= 0

    def __eq__(self, other):
        if not isinstance(other, Time):
            return NotImplemented
        return self._cmp(other) == 0

    def __ne__(self, other):
        eq = self.__eq__(other)
        if eq is NotImplemented:
            return eq
        return ~np.asarray(eq) if np.ndim(eq) else not eq

    def __hash__(self):
        # equality converts scales, so hash on the TAI pair
        t = self if self.scale == "tai" else self.tai
        return hash((float(np.sum(t.jd1)), float(np.sum(t.jd2))))

    # -- formatting ------------------------------------------------------
    @property
    def isot(self):
        if self.isscalar:
            return self._format_one(float(self.jd1), float(self.jd2))
        flat = [self._format_one(a, b)
                for a, b in zip(np.ravel(self.jd1), np.ravel(self.jd2))]
        return np.array(flat).reshape(self.shape)

    @staticmethod
    def _format_one(jd1, jd2, precision=9):
        # Shift so we measure from midnight: JDN at noon.
        jd_plus = jd1 + 0.5
        day_int = np.floor(jd_plus)
        frac = (jd_plus - day_int) + jd2
        # fold frac into [0, 1)
        extra = np.floor(frac)
        day_int += extra
        frac -= extra
        sec = frac * SECONDS_PER_DAY
        # rounding to requested precision, handle carry to next day
        sec = round(sec, precision)
        if sec >= SECONDS_PER_DAY:
            sec -= SECONDS_PER_DAY
            day_int += 1
        year, month, day = _jd_to_cal(int(day_int))
        hh = int(sec // 3600)
        mm = int((sec - hh * 3600) // 60)
        ss = sec - hh * 3600 - mm * 60
        return (f"{year:04d}-{month:02d}-{day:02d}T"
                f"{hh:02d}:{mm:02d}:{ss:0{3 + precision}.{precision}f}")

    def __repr__(self):
        val = self.isot if np.size(self.jd1) < 5 else f"shape={self.shape}"
        return f"<Time {val} scale={self.scale}>"
