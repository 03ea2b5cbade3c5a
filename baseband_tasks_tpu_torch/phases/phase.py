"""Extended-precision pulse phase.

Counterpart of `upstream baseband_tasks/phases/phase.py`: a
:class:`Phase` stores a phase as two float64 parts — an integer cycle count
and a fractional part in [-0.5, 0.5) — giving ~1e-16 cycle precision even
at 1e10 cycles (phase.py:350-352), which is what pulsar folding needs.
:class:`FractionalPhase` is the wrapped fractional part.

Host-only (numpy): phases feed the fold binning at frame granularity; the
device only ever sees the per-sample bin indices derived from them.
"""

from __future__ import annotations

import numpy as np

from ..utils import units as u
from ..utils.time import two_sum

__all__ = ["Phase", "FractionalPhase", "check_imaginary"]


def check_imaginary(a):
    """Split a value into a real float array and an is-imaginary flag.

    Purely real input returns ``(a, False)``; purely imaginary returns
    ``(a.imag, True)``; mixed complex raises ValueError (reference
    phases/phase.py:113-140).
    """
    a = np.asanyarray(a)
    if a.dtype.kind == "c":
        if np.all(a.real == 0):
            return a.imag, True
        if np.all(a.imag == 0):
            return a.real, False
        raise ValueError("cannot have mixed real/imaginary Phase")
    return a, False


def _split(value):
    """Split float64 cycles into (integer part, fraction in [-0.5, 0.5)).

    Non-finite values keep the count (inf/nan) and a zero fraction so
    isinf/isnan see them and inf - inf does not trip warnings-as-errors.
    """
    value = np.asarray(value, dtype=np.float64)
    int_part = np.round(value)
    with np.errstate(invalid="ignore"):
        frac = np.where(np.isfinite(value), value - int_part, 0.0)
    return int_part, frac


def _normalize(count, frac):
    """Renormalize so count is integral and frac in [-0.5, 0.5)."""
    extra = np.round(frac)
    count = count + extra
    frac = frac - extra
    return count, frac


def _parse_decimal(string):
    """Parse a decimal-cycle string losslessly into (count, frac, imaginary).

    Handles optional sign, exponents ('e' or Fortran 'd'), and a trailing
    'j' marking a purely imaginary phase (reference phase.py:22-64).  The
    exponent is folded in by shifting the decimal point digit-by-digit so
    no precision is lost for values representable as (int, frac) doubles.
    """
    string = string.strip().lower().replace("d", "e")
    imaginary = string.endswith("j")
    if imaginary:
        string = string[:-1]
    neg = string.startswith("-")
    body = string.lstrip("+-")
    mantissa, _, exp_str = body.partition("e")
    exponent = int(exp_str) if exp_str else 0
    ip, _, fp = mantissa.partition(".")
    # shift the decimal point by the exponent
    if exponent > 0:
        n = min(len(fp), exponent)
        ip, fp = ip + fp[:n], fp[n:]
        ip += "0" * (exponent - n)
    elif exponent < 0:
        n = min(len(ip), -exponent)
        fp = (ip[-n:] if n else "") + fp
        ip = ip[:-n] if n else ip
        fp = "0" * (-exponent - n) + fp
    count = float(ip or 0)
    frac = float("0." + fp) if fp else 0.0
    if neg:
        count, frac = -count, -frac
    return count, frac, imaginary


_SPLITTER = 134217729.0  # 2**27 + 1, Dekker splitting constant


def _two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker/Veltkamp)."""
    p = a * b
    ac = a * _SPLITTER
    ah = ac - (ac - a)
    al = a - ah
    bc = b * _SPLITTER
    bh = bc - (bc - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class FractionalPhase(u.Quantity):
    """Fractional phase: angle wrapped to [-0.5, 0.5) cycle.

    Counterpart of the reference's ``Longitude`` subclass with
    ``wrap_angle=0.5 cycle`` (phase.py:70-103): accepts any angular unit
    (cycle, rad, deg), extracts the fractional part of a :class:`Phase`,
    and keeps results of +/-/negation wrapped.

    >>> from baseband_tasks_tpu_torch.phases import FractionalPhase
    >>> from baseband_tasks_tpu_torch.utils import units as u
    >>> print(FractionalPhase(0.75))
    -0.25 cycle
    >>> import numpy as np
    >>> print(FractionalPhase(np.pi * u.rad))
    -0.5 cycle
    >>> print(FractionalPhase(0.375) + FractionalPhase(0.25))
    -0.375 cycle
    """

    def __init__(self, value, unit=None):
        if isinstance(value, Phase):
            value = value.frac
        if unit is None:
            unit = u.cycle if not isinstance(value, u.Quantity) else None
        q = u.Quantity(value, unit)
        val = np.asarray(q.to_value(u.cycle), dtype=np.float64)
        val = val - np.round(val)
        # round maps exact .5 up: fold +0.5 to -0.5 so range is [-0.5, 0.5)
        val = np.where(val >= 0.5, val - 1.0, val)
        super().__init__(val, u.cycle)

    def _rewrap(self, q):
        return FractionalPhase(q) if isinstance(q, u.Quantity) \
            and q.unit.is_equivalent(u.cycle) else q

    def __add__(self, other):
        return self._rewrap(u.Quantity.__add__(self, other))

    def __radd__(self, other):
        return self._rewrap(u.Quantity.__add__(self, other))

    def __sub__(self, other):
        return self._rewrap(u.Quantity.__sub__(self, other))

    def __neg__(self):
        return self._rewrap(u.Quantity.__neg__(self))


class Phase:
    """Two-double extended precision phase (in cycles).

    Construct from one or two values (cycles; Quantity or float); the two
    are summed exactly.  ``Phase(count, frac)`` mirrors the reference's
    ``Phase.from_angles`` usage.

    Examples
    --------
    >>> from baseband_tasks_tpu_torch.phases import Phase
    >>> p = Phase(1e10, 1e-10)   # 20 decimal digits, exactly
    >>> p - Phase(1e10)
    Phase(np.float64(0.0), np.float64(1e-10))
    >>> (Phase(0.75) + Phase(0.75)).int
    <Quantity 2.0 cycle>
    >>> (Phase(0.75) + Phase(0.75)).frac
    <Quantity -0.5 cycle>
    """

    __slots__ = ("count", "fraction", "imaginary")
    # numpy should defer to us
    __array_priority__ = 20000

    def __init__(self, phase1, phase2=0, imaginary=False):
        def coerce(ph):
            nonlocal imaginary
            if isinstance(ph, u.Quantity):
                ph = ph.to_value(u.cycle)
            if isinstance(ph, str):
                c, f, im = _parse_decimal(ph)
                imaginary = imaginary or im
                return c, f
            if isinstance(ph, (list, tuple)) and ph and \
                    isinstance(ph[0], str):
                parsed = [_parse_decimal(x) for x in ph]
                imaginary = imaginary or any(im for _, _, im in parsed)
                return (np.array([a for a, b, im in parsed]),
                        np.array([b for a, b, im in parsed]))
            ph = np.asarray(ph)
            if ph.dtype.kind == "U":
                parsed = [_parse_decimal(x) for x in ph.ravel()]
                imaginary = imaginary or any(im for _, _, im in parsed)
                return (np.array([a for a, b, im in parsed]
                                 ).reshape(ph.shape),
                        np.array([b for a, b, im in parsed]
                                 ).reshape(ph.shape))
            if ph.dtype.kind == "c":
                # purely imaginary values mark an imaginary phase
                # (reference check_imaginary, phase.py:113)
                if np.any(ph.real != 0):
                    raise ValueError("phase must be real or purely "
                                     "imaginary")
                imaginary = True
                ph = ph.imag
            return ph

        def parts(ph):
            if isinstance(ph, Phase):
                nonlocal imaginary
                imaginary = imaginary or ph.imaginary
                return ph.count, ph.fraction
            coerced = coerce(ph)
            if isinstance(coerced, tuple):  # pre-split decimal strings
                return coerced
            return _split(coerced)

        c1, f1 = parts(phase1)
        c2, f2 = parts(phase2)
        count = c1 + c2
        hi, lo = two_sum(f1, f2)
        count, frac = _normalize(count, hi)
        frac = frac + lo
        count, frac = _normalize(count, frac)
        self.count = count
        self.fraction = frac
        self.imaginary = bool(imaginary)

    @classmethod
    def from_angles(cls, count, frac, imaginary=False):
        """Exact construction from separately-supplied parts
        (reference phase.py:208)."""
        return cls(count, frac, imaginary=imaginary)

    @classmethod
    def from_string(cls, string):
        """Create a Phase from (an array of) long decimal strings,
        losslessly (reference phase.py:418-429).  Strings may carry
        'e'/'d' exponents and a trailing 'j' for imaginary phases."""
        arr = np.asarray(string)
        if arr.dtype.kind not in "SU":
            raise ValueError("require string input.")
        return cls(string if isinstance(string, str) else arr)

    # -- numpy ufunc interop --------------------------------------------
    # Full dispatch table mirroring the reference's semantics
    # (phase.py:653-753): exact two-part paths where precision can be
    # kept, decay to a lossy cycle Quantity otherwise.
    _COMPARISONS = frozenset((
        "equal", "not_equal", "less", "less_equal", "greater",
        "greater_equal"))
    _FRACTION_UFUNCS = frozenset(("sin", "cos", "tan", "spacing"))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        name = ufunc.__name__

        if name in ("add", "subtract"):
            a, b = inputs
            try:
                a = a if isinstance(a, Phase) else Phase(a)
                return a + b if name == "add" else a - b
            except (u.UnitsError, ValueError):
                return self._ufunc_fallback(ufunc, inputs, kwargs)

        if name in self._COMPARISONS:
            a, b = inputs
            try:
                a = a if isinstance(a, Phase) else Phase(a)
                b = b if isinstance(b, Phase) else Phase(b)
            except (u.UnitsError, ValueError, TypeError):
                return NotImplemented
            if a.imaginary != b.imaginary:
                return NotImplemented
            diff = a._diff(b)
            return getattr(np, name)(diff, 0)

        if name == "multiply":
            a, b = inputs
            phase, k = (a, b) if isinstance(a, Phase) else (b, a)
            return phase * k

        if name in ("divide", "true_divide"):
            a, b = inputs
            if a is self or isinstance(a, Phase):
                return a / b
            return self._ufunc_fallback(ufunc, inputs, kwargs)

        if name in ("floor_divide", "remainder", "mod", "divmod"):
            a, b = inputs
            if not (isinstance(a, Phase) and not a.imaginary):
                return self._ufunc_fallback(ufunc, inputs, kwargs)
            if name == "floor_divide":
                return a // b
            if name == "divmod":
                return divmod(a, b)
            return a % b

        if name == "positive":
            return +self
        if name == "negative":
            return -self
        if name in ("absolute", "fabs"):
            return abs(self)
        if name == "rint":
            # round to nearest cycle: exactly the integer part
            # (reference phase.py:743-744)
            return u.Quantity(np.positive(self.count), u.cycle)
        if name in ("isnan", "isinf", "isfinite"):
            return ufunc(np.asarray(self.count)
                         + np.asarray(self.fraction))
        if name == "sign":
            return np.sign(np.asarray(self.count)
                           + np.asarray(self.fraction))

        if name in self._FRACTION_UFUNCS and not self.imaginary:
            # only the fraction matters (reference phase.py:746-748)
            if name == "spacing":
                return u.Quantity(np.spacing(np.asarray(self.fraction)),
                                  u.cycle)
            return ufunc(2.0 * np.pi * np.asarray(self.fraction))

        if name == "exp" and self.imaginary:
            # exp of an *imaginary* phase: integer cycles drop exactly, so
            # only the fraction enters (reference phase.py:750-753)
            return np.exp(2j * np.pi * np.asarray(self.fraction))

        return self._ufunc_fallback(ufunc, inputs, kwargs)

    def _ufunc_fallback(self, ufunc, inputs, kwargs):
        """Decay Phase inputs to lossy cycle Quantities and retry
        (reference phase.py:755-765)."""
        quantities = tuple(x.cycle if isinstance(x, Phase) else x
                           for x in inputs)
        for q in quantities:
            if isinstance(q, u.Quantity):
                result = q.__array_ufunc__(ufunc, "__call__", *quantities,
                                           **kwargs)
                if result is not NotImplemented:
                    return result
                break
        return NotImplemented

    # -- views -----------------------------------------------------------
    @property
    def int(self):
        """Integer cycles as a Quantity."""
        return u.Quantity(self.count, u.cycle)

    @property
    def frac(self):
        """Fractional part as a FractionalPhase."""
        return FractionalPhase(self.fraction)

    @property
    def cycle(self):
        """Lossy single-float total phase as a Quantity."""
        return u.Quantity(self.count + self.fraction, u.cycle)

    @property
    def cycle_pair(self):
        """(hi, lo) float64 pair whose sum is the exact phase in cycles."""
        return self.count, self.fraction

    @property
    def shape(self):
        return np.shape(self.count)

    @property
    def ndim(self):
        return np.ndim(self.count)

    @property
    def size(self):
        return np.size(self.count)

    @property
    def isscalar(self):
        return np.ndim(self.count) == 0

    def __len__(self):
        return len(np.asarray(self.count))

    def __getitem__(self, item):
        return Phase.from_angles(np.asarray(self.count)[item],
                                 np.asarray(self.fraction)[item],
                                 imaginary=self.imaginary)

    def reshape(self, shape):
        return Phase.from_angles(np.reshape(self.count, shape),
                                 np.reshape(self.fraction, shape),
                                 imaginary=self.imaginary)

    def ravel(self):
        return Phase.from_angles(np.ravel(self.count),
                                 np.ravel(self.fraction),
                                 imaginary=self.imaginary)

    def to(self, unit):
        return self.cycle.to(unit)

    def to_value(self, unit=u.cycle):
        return self.cycle.to_value(unit)

    def astype(self, dtype, order="K", casting="unsafe", subok=True,
               copy=True):
        """Plain array of the phase in cycles, cast to ``dtype``.

        As `numpy.ndarray.astype`, but using knowledge of the two-double
        format: each part is cast separately and then summed, so casting
        to float128-like or float64 keeps the maximum precision the
        target type can hold (reference phases/phase.py:785-802).

        A structured ``dtype`` with exactly two float fields (e.g.
        ``[('int', 'f8'), ('frac', 'f8')]``) receives the two parts
        separately — the lossless serialization form.  ``subok`` and
        ``copy`` are accepted for signature compatibility only: the
        result is always a freshly-built plain ndarray (the reference's
        fallback to ndarray.astype behaves the same way for the summed
        representation).
        """
        dtype = np.dtype(dtype)
        if dtype.fields:
            names = dtype.names
            if len(names) != 2:
                raise TypeError(
                    f"structured target for Phase.astype needs exactly "
                    f"two fields (count, fraction), got {dtype}")
            out = np.empty(self.shape, dtype)
            out[names[0]] = np.asarray(self.count).astype(
                dtype[names[0]], casting=casting)
            out[names[1]] = np.asarray(self.fraction).astype(
                dtype[names[1]], casting=casting)
            return out
        if casting not in ("same_kind", "unsafe"):
            raise TypeError(
                f"Phase.astype supports casting='same_kind'/'unsafe' "
                f"only (each two-double part is summed into the target "
                f"type, which numpy deems unsafe), not {casting!r}")
        out = np.asarray(self.count).astype(dtype, order=order,
                                            casting=casting, copy=True)
        out += np.asarray(self.fraction).astype(dtype, order=order,
                                                casting=casting, copy=False)
        return out

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Phase):
            other = Phase(other)
        if other.imaginary != self.imaginary:
            raise ValueError("cannot mix real and imaginary phases")
        count = self.count + other.count
        hi, lo = two_sum(self.fraction, other.fraction)
        return Phase.from_angles(count, hi + lo,
                                 imaginary=self.imaginary)

    __radd__ = __add__

    def __sub__(self, other):
        if not isinstance(other, Phase):
            other = Phase(other)
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return Phase.from_angles(-self.count, -self.fraction,
                                 imaginary=self.imaginary)

    def __pos__(self):
        return Phase.from_angles(np.positive(self.count),
                                 np.positive(self.fraction),
                                 imaginary=self.imaginary)

    def copy(self):
        return Phase.from_angles(np.array(self.count, copy=True),
                                 np.array(self.fraction, copy=True),
                                 imaginary=self.imaginary)

    def __abs__(self):
        neg = (self.count + self.fraction) < 0
        return Phase.from_angles(np.where(neg, -self.count, self.count),
                                 np.where(neg, -self.fraction,
                                          self.fraction),
                                 imaginary=self.imaginary)

    @staticmethod
    def _real_factor(k):
        """Coerce a dimensionless factor to (real array, is_imaginary).

        Mirrors the reference's ``check_imaginary`` (phase.py:113-140):
        purely real and purely imaginary factors keep the exact two-part
        path; mixed complex raises ValueError so callers can decay to a
        lossy Quantity instead.
        """
        if isinstance(k, u.Unit):
            k = u.Quantity(1.0, k)
        if isinstance(k, u.Quantity):
            k = k.to_value(u.one)
        k = np.asarray(k)
        if k.dtype.kind == "c":
            if np.all(k.imag == 0):
                return np.asarray(k.real, dtype=np.float64), False
            if np.all(k.real == 0):
                return np.asarray(k.imag, dtype=np.float64), True
            raise ValueError("cannot have mixed real/imaginary factor")
        return np.asarray(k, dtype=np.float64), False

    def __mul__(self, k):
        try:
            k, k_imag = self._real_factor(k)
        except u.UnitsError:
            # unit-full factor: decay to a lossy cycle Quantity
            # (reference phase.py:679-694 falls through the same way)
            return self.cycle * k
        except ValueError:
            return self.cycle * np.asarray(k)
        # error-free products keep the result exact to a double-double ulp
        pc, ec = _two_prod(np.asarray(self.count, dtype=np.float64), k)
        pf, ef = _two_prod(np.asarray(self.fraction, dtype=np.float64), k)
        return Phase(pc, pf + (ec + ef),
                     imaginary=self.imaginary ^ k_imag)

    __rmul__ = __mul__

    def __truediv__(self, k):
        try:
            k, k_imag = self._real_factor(k)
        except u.UnitsError:
            return self.cycle / k
        except ValueError:
            return self.cycle / np.asarray(k)
        if k_imag:
            # x / (i k) = -i (x / k): flips sign unless already imaginary
            # (then i x / i k = x / k)
            if not self.imaginary:
                k = -k
        divided = (self * (1.0 / k) if np.all(k != 0)
                   else Phase(self.count / k, self.fraction / k,
                              imaginary=self.imaginary))
        if k_imag:
            divided = Phase.from_angles(divided.count, divided.fraction,
                                        imaginary=not self.imaginary)
        return divided

    def __floordiv__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        div = other.count + other.fraction
        q = np.floor((self.count + self.fraction) / div)
        r = self - other * q
        # one-step correction for boundary rounding: floor semantics
        # require 0 <= r/other < 1, i.e. the remainder has the divisor's
        # sign (or is zero) and |r| < |divisor| — sign-aware, unlike a
        # plain r < 0 test, which is wrong for negative divisors
        rd = np.asarray(r._diff(_ZERO))
        sign = np.sign(div)
        step = np.where(rd * sign < 0, -1.0, 0.0)
        over = np.asarray((r - other)._diff(_ZERO)) * sign >= 0
        step = step + np.where(over, 1.0, 0.0)
        return q + step

    def __mod__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        q = self.__floordiv__(other)
        return self - other * q

    def __divmod__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        q = self.__floordiv__(other)
        return q, self - other * q

    def _diff(self, other):
        return (self.count - other.count) + (self.fraction - other.fraction)

    # -- comparisons (via exact differenced parts, phase.py:666-677) ----
    def __eq__(self, other):
        try:
            other = other if isinstance(other, Phase) else Phase(other)
        except u.UnitsError:
            # incompatible units are simply unequal (reference
            # phase.py:591-597)
            return False
        except Exception:
            return NotImplemented
        return self._diff(other) == 0

    def __ne__(self, other):
        eq = self.__eq__(other)
        if eq is NotImplemented:
            return eq
        if eq is False:
            return True
        return ~np.asarray(eq) if np.ndim(eq) else not eq

    def __lt__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        return self._diff(other) < 0

    def __le__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        return self._diff(other) <= 0

    def __gt__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        return self._diff(other) > 0

    def __ge__(self, other):
        other = other if isinstance(other, Phase) else Phase(other)
        return self._diff(other) >= 0

    def __hash__(self):
        if not self.isscalar:
            raise TypeError("unhashable array Phase")
        return hash((float(self.count), float(self.fraction)))

    # -- reductions / sorting (precision-preserving, phase.py:490-559) --
    def min(self, axis=None):
        idx = self.argmin(axis)
        if axis is None:
            return self.ravel()[idx]
        return Phase.from_angles(
            np.take_along_axis(np.asarray(self.count),
                               np.expand_dims(idx, axis), axis).squeeze(axis),
            np.take_along_axis(np.asarray(self.fraction),
                               np.expand_dims(idx, axis), axis).squeeze(axis),
            imaginary=self.imaginary)

    def max(self, axis=None):
        idx = self.argmax(axis)
        if axis is None:
            return self.ravel()[idx]
        return Phase.from_angles(
            np.take_along_axis(np.asarray(self.count),
                               np.expand_dims(idx, axis), axis).squeeze(axis),
            np.take_along_axis(np.asarray(self.fraction),
                               np.expand_dims(idx, axis), axis).squeeze(axis),
            imaginary=self.imaginary)

    def ptp(self, axis=None):
        """Peak-to-peak (max - min), full precision (reference
        phase.py:532-544)."""
        return self.max(axis) - self.min(axis)

    def argmin(self, axis=None):
        if axis is None:
            flat = self.ravel()
            return int(np.lexsort((np.asarray(flat.fraction),
                                   np.asarray(flat.count)))[0])
        return np.take(self.argsort(axis), 0, axis=axis)

    def argmax(self, axis=None):
        if axis is None:
            flat = self.ravel()
            return int(np.lexsort((np.asarray(flat.fraction),
                                   np.asarray(flat.count)))[-1])
        return np.take(self.argsort(axis), -1, axis=axis)

    def argsort(self, axis=-1):
        # lexsort: count is the primary key, fraction breaks exact ties —
        # never loses precision to a combined float key (phase.py:490-559).
        count = np.asarray(self.count)
        frac = np.broadcast_to(np.asarray(self.fraction), count.shape)
        return np.lexsort((frac, count), axis=axis)

    def sort(self, axis=-1):
        idx = self.argsort(axis)
        return Phase.from_angles(
            np.take_along_axis(np.asarray(self.count), idx, axis),
            np.take_along_axis(np.asarray(self.fraction), idx, axis),
            imaginary=self.imaginary)

    def __repr__(self):
        return f"Phase({self.count!r}, {self.fraction!r})"

    def to_string(self, precision=16):
        """Full-precision decimal string(s) (reference phase.py:345-429):
        integer cycles and fraction concatenated losslessly."""
        def one(c, f):
            neg = (c + f) < 0
            if neg:
                c, f = -c, -f
            if f < 0:
                c -= 1
                f += 1
            frac = f"{f:.{precision}f}"
            if frac.startswith("1"):  # rounded up to 1.000...
                c += 1
                frac = f"{0.0:.{precision}f}"
            return ("-" if neg else "") + f"{int(c)}" + frac[1:]
        if self.isscalar:
            return one(float(self.count), float(self.fraction))
        flat = [one(float(c), float(f))
                for c, f in zip(np.ravel(self.count),
                                np.ravel(self.fraction))]
        return np.array(flat).reshape(self.shape)

    def __str__(self):
        if self.isscalar:
            return self.to_string()
        return repr(self)


_ZERO = None  # placeholder replaced below (Phase needs to exist first)


def _init_zero():
    global _ZERO
    _ZERO = Phase(0.0)


_init_zero()
