"""Tempo polyco files: parse, evaluate, write.

Counterpart of `upstream baseband_tasks/phases/predictor.py`: a
:class:`Polyco` holds one or more polynomial phase-prediction entries in
the tempo1/tempo2 polyco format and evaluates phase and spin frequency at
arbitrary times with two-double precision (RPHASE is parsed as separate
integer and fractional strings so no precision is lost,
predictor.py:332-356).

Format (per entry)::

    PSRNAME  DATE  UTC  TMID(MJD)  DM  DOPPLER  LOGRMS
    RPHASE  F0(Hz)  OBS  SPAN(min)  NCOEFF  OBSFREQ(MHz)  [BINPHASE]
    COEFF1  COEFF2  COEFF3          (NCOEFF values, 3/line, D-exponents)

phase(t) = RPHASE + 60 * F0 * dt_min + sum_k COEFF[k] * dt_min**k,
dt_min = (t - TMID) in minutes.
"""

from __future__ import annotations

import io

import numpy as np

from ..utils import Time, units as u
from ..utils.time import two_sum
from .phase import Phase

__all__ = ["Polyco", "fortran_fmt", "int_frac"]


def fortran_fmt(x, base_fmt="23.16e"):
    """Render ``x`` in Fortran D-notation with a ``0.`` mantissa, e.g.
    ``0.8966709123456789012D+05`` (reference predictor.py:408-412)."""
    s = format(x, base_fmt)
    mant, _, exp = s.partition("e")
    sign = "-" if mant.lstrip().startswith("-") else ""
    lead = len(s) - len(s.lstrip())
    digits = mant.strip().lstrip("-").replace(".", "")
    return (" " * lead + sign + "0." + digits
            + "D{:+03d}".format(int(exp) + 1))


def int_frac(s):
    """Losslessly split a decimal string into integer and fractional
    float64 parts (reference predictor.py:315-318)."""
    int_part, _, frac = str(s).strip().partition(".")
    return np.array((int("0" + int_part), float("0." + frac)),
                    dtype=[("int", np.int64), ("frac", np.float64)])


def _parse_d_float(s):
    return float(s.replace("D", "E").replace("d", "e"))


def _fortran_d17(x):
    """Fortran D-format with mantissa in [0.1, 1): ``0.x{17}D±ee``, 24
    chars with sign column — the tempo1 polyco coefficient format
    (reference predictor.py:408-412 defines the same convention)."""
    m, e = f"{x:.16e}".split("e")
    neg = m.startswith("-")
    digits = m.lstrip("-").replace(".", "")
    return ("-" if neg else " ") + "0." + digits + f"D{int(e) + 1:+03d}"


def _two_part_fixed(int_part, frac_part, width, decimals):
    """Fixed-point rendering of a two-double value without losing the
    extra precision to a single float64 sum (e.g. RPHASE with 12 integer
    digits and 6 decimals needs 18 significant digits)."""
    neg = int_part < 0 or (int_part == 0 and frac_part < 0)
    ip = abs(int(int_part))
    fs = f"{abs(frac_part):.{decimals}f}"
    if fs.startswith("1"):          # fraction rounded up to 1.0
        ip += 1
        fs = f"{0.0:.{decimals}f}"
    return (("-" if neg else "") + str(ip) + fs[1:]).rjust(width)


class PolycoEntry:
    __slots__ = ("psr", "date", "utc", "tmid", "dm", "doppler", "log10rms",
                 "rphase_int", "rphase_frac", "f0", "obs", "span", "ncoeff",
                 "obsfreq", "binphase", "forb", "coeff")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class Polyco:
    """A set of polyco entries with phase/frequency evaluation."""

    def __init__(self, data):
        if isinstance(data, Polyco):
            self.entries = list(data.entries)
        elif isinstance(data, (list, tuple)) and data and \
                isinstance(data[0], PolycoEntry):
            self.entries = list(data)
        else:
            self.entries = self._parse(data)
        if not self.entries:
            raise ValueError("no polyco entries found")

    # -- parsing ---------------------------------------------------------
    @staticmethod
    def _parse(source):
        if isinstance(source, str) and "\n" not in source:
            with open(source) as fh:
                lines = fh.read().splitlines()
        elif isinstance(source, io.IOBase):
            lines = source.read().splitlines()
        else:
            lines = str(source).splitlines()
        lines = [ln for ln in lines if ln.strip()]
        entries = []
        i = 0
        while i < len(lines):
            h1 = lines[i].split()
            h2 = lines[i + 1].split()
            psr, date, utc, tmid_s, dm = h1[0], h1[1], h1[2], h1[3], h1[4]
            doppler = float(h1[5]) if len(h1) > 5 else 0.0
            log10rms = float(h1[6]) if len(h1) > 6 else 0.0
            # keep tmid as an exact two-part MJD; tempo polyco TMID is a
            # UTC MJD (tempo1 convention)
            if "." in tmid_s:
                ip, fp = tmid_s.split(".")
                tmid = Time(float(ip), float("0." + fp), format="mjd",
                            scale="utc")
            else:
                tmid = Time(float(tmid_s), format="mjd", scale="utc")
            rphase_s = h2[0]
            if "." in rphase_s:
                ip, fp = rphase_s.split(".")
                rphase_int = float(ip)
                rphase_frac = float(("-0." if ip.startswith("-") else "0.")
                                    + fp)
            else:
                rphase_int, rphase_frac = float(rphase_s), 0.0
            f0 = _parse_d_float(h2[1])
            obs = h2[2]
            span = int(h2[3])
            ncoeff = int(h2[4])
            obsfreq = float(h2[5])
            binphase = float(h2[6]) if len(h2) > 6 else None
            forb = float(h2[7]) if len(h2) > 7 else None
            ncoeff_lines = (ncoeff + 2) // 3
            coeff = []
            for j in range(ncoeff_lines):
                coeff.extend(_parse_d_float(v)
                             for v in lines[i + 2 + j].split())
            entries.append(PolycoEntry(
                psr=psr, date=date, utc=utc, tmid=tmid, dm=float(dm),
                doppler=doppler, log10rms=log10rms,
                rphase_int=rphase_int, rphase_frac=rphase_frac, f0=f0,
                obs=obs, span=span, ncoeff=ncoeff, obsfreq=obsfreq,
                binphase=binphase, forb=forb,
                coeff=np.array(coeff[:ncoeff])))
            i += 2 + ncoeff_lines
        return entries

    @classmethod
    def read(cls, filename):
        return cls(filename)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.entries[item]
        return Polyco(self.entries[item])

    # -- evaluation ------------------------------------------------------
    def searchclosest(self, t):
        """Index of the entry whose TMID is nearest each time
        (predictor.py:306-312)."""
        t = t if isinstance(t, Time) else Time(t, format="mjd")
        if self.entries and t.scale != self.entries[0].tmid.scale:
            t = t.to_scale(self.entries[0].tmid.scale)
        tm = np.array([e.tmid.mjd for e in self.entries])
        mjd = np.atleast_1d(np.asarray(t.mjd))
        idx = np.argmin(np.abs(mjd[..., np.newaxis] - tm), axis=-1)
        return idx if np.ndim(t.mjd) else int(idx[0])

    def _dt_minutes(self, entry, t):
        # tempo evaluates DTMIN = (T - TMID) * 1440 on raw UTC MJD
        # *labels* (not elapsed SI seconds), so use label arithmetic on
        # the two-double MJD pairs — leap-aware Time subtraction would
        # shift polycos whose span straddles a leap-second midnight.
        # A differently-scaled Time must first convert to TMID's scale
        # (a TAI label is 37 s ahead of the same instant's UTC label —
        # x642 Hz that is tens of thousands of cycles).
        if t.scale != entry.tmid.scale:
            t = t.to_scale(entry.tmid.scale)
        h1, l1 = t.mjd_pair
        h2, l2 = entry.tmid.mjd_pair
        hi, lo = two_sum(h1, -h2)
        return hi * 1440.0 + (lo + (l1 - l2)) * 1440.0

    def __call__(self, t, index=None, rphase=None, deriv=0, time_unit=None):
        """Evaluate phase (deriv=0, as Phase) or its time derivatives.

        deriv=1 gives the spin frequency in Hz (Quantity); higher
        derivatives accordingly (reference predictor.py:134-202).

        rphase : None, 'fraction', 'ignored', or Phase-like
            None keeps the absolute reference phase; 'fraction' references
            to the first entry's rphase; 'ignored' drops RPHASE entirely.
        """
        t = t if isinstance(t, Time) else Time(t, format="mjd")
        scalar = t.isscalar
        times = t.reshape((1,)) if scalar else t.ravel()
        mjds = np.asarray(times.mjd)
        if index is None:
            indices = np.atleast_1d(self.searchclosest(times))
        else:
            indices = np.full(mjds.shape, index, dtype=int)

        if deriv == 0:
            count = np.zeros(mjds.shape)
            frac = np.zeros(mjds.shape)
        else:
            out = np.zeros(mjds.shape)
        for i in np.unique(indices):
            e = self.entries[i]
            sel = indices == i
            dt_min = np.atleast_1d(self._dt_minutes(e, times[sel]))
            in_span = np.abs(dt_min) <= e.span / 2 + 1e-6
            if not np.all(in_span):
                import warnings
                warnings.warn("some times outside polyco span; "
                              "extrapolating.")
            if deriv == 0:
                poly = np.polynomial.Polynomial(e.coeff)
                ph_poly = poly(dt_min)
                ph_spin = 60.0 * e.f0 * dt_min
                base = Phase(e.rphase_int, e.rphase_frac) if rphase is None \
                    else (Phase(0.0)
                          if rphase in ("ignore", "ignored")
                          else (Phase(0.0, e.rphase_frac)
                                if rphase == "fraction" else Phase(rphase)))
                ph = base + Phase(ph_spin) + Phase(ph_poly)
                count[sel] = ph.count
                frac[sel] = ph.fraction
            else:
                dcoeff = np.polynomial.Polynomial(e.coeff).deriv(deriv)
                val = dcoeff(dt_min) / 60.0 ** deriv
                if deriv == 1:
                    val = val + e.f0
                out[sel] = val
        if deriv == 0:
            result = Phase.from_angles(count, frac)
            return result[0] if scalar else result.reshape(t.shape)
        unit = u.Hz if deriv == 1 else u.Hz / u.s ** (deriv - 1)
        result = u.Quantity(out, unit)
        return result[0] if scalar else result.reshape(t.shape)

    def polynomial(self, index, rphase=None, deriv=0,
                   t0=None, time_unit=u.minute, out_unit=None,
                   convert=False):
        """Prediction polynomial for one entry, as a
        `numpy.polynomial.Polynomial` (reference predictor.py:204-304).

        Parameters
        ----------
        index : int or float or Time
            Entry index, or an MJD/time for nearest-entry lookup.
        rphase : None, 'fraction', 'ignore', or float
            Phase zero point: None adds the stored RPHASE (large — loses
            precision in a single float64 coefficient), 'fraction' adds
            only its fractional part (fine for folding; breaks cycle
            continuity between entries), 'ignore' keeps the raw
            coefficients, a float replaces the zero point outright.
        deriv : int
            Phase derivative (1 = spin frequency, 2 = fdot, ...).
        t0 : Time or float (MJD), optional
            If given, the polynomial's domain is re-anchored so its
            argument is (t - t0) in ``time_unit`` (e.g. ``t0=0,
            time_unit=u.day`` makes the argument the MJD itself).
        time_unit : Unit
            Unit of the polynomial argument when ``t0`` is given.
        out_unit : Unit, optional
            Unit of time in the output for ``deriv > 0`` (default
            ``time_unit``): coefficients are scaled so values come out
            in cycles / out_unit**deriv.
        convert : bool
            Return ``polynomial.convert()`` (coefficients re-expanded in
            the domain variable) instead of the windowed polynomial.

        Notes
        -----
        Without ``t0``, the argument is minutes since the entry's TMID
        and values are cycles (/minute**deriv before out_unit scaling),
        exactly the tempo convention.
        """
        out_unit = out_unit or time_unit
        import operator
        try:
            index = operator.index(index)
        except TypeError:
            index = int(self.searchclosest(index))
        e = self.entries[index]
        window = np.array([-0.5, 0.5]) * float(e.span)  # minutes
        coef = np.array(e.coeff, dtype=np.float64)
        if coef.size < 2:
            coef = np.concatenate([coef, np.zeros(2 - coef.size)])
        pol = np.polynomial.Polynomial(coef, window.copy(), window.copy())
        pol.coef[1] += 60.0 * e.f0  # F0 (Hz) in cycles/minute

        if deriv == 0:
            if rphase is None:
                pol.coef[0] += e.rphase_int + e.rphase_frac
            elif rphase == "fraction":
                pol.coef[0] += e.rphase_frac % 1
            elif rphase not in ("ignore", "ignored"):
                pol.coef[0] = rphase
        else:
            pol = pol.deriv(deriv)
            pol.coef /= u.minute.to(out_unit) ** deriv

        if t0 is not None:
            # label arithmetic, like _dt_minutes: the polynomial is
            # evaluated on raw MJD labels (t0=0, time_unit=day makes the
            # argument the MJD itself), so the domain shift must be a
            # label difference too.
            tt = t0 if isinstance(t0, Time) else Time(float(t0),
                                                      format="mjd")
            dt_min = self._dt_minutes(e, tt)
            pol.domain = (window - dt_min) * u.minute.to(time_unit)

        return pol.convert() if convert else pol

    def phasepol(self, index=0, rphase=None, t0=0., time_unit=u.day,
                 convert=False):
        """Phase polynomial in MJD (by default): cycles as a function of
        ``(t - t0)`` in ``time_unit`` (reference predictor.py:264-283)."""
        return self.polynomial(index, rphase, t0=t0, time_unit=time_unit,
                               convert=convert)

    def fpol(self, index=0, t0=0., time_unit=u.day, convert=False):
        """Spin-frequency polynomial: Hz as a function of ``(t - t0)`` in
        ``time_unit`` (default: of the MJD; reference
        predictor.py:285-298)."""
        return self.polynomial(index, deriv=1, t0=t0, time_unit=time_unit,
                               out_unit=u.s, convert=convert)

    # -- writing ---------------------------------------------------------
    def to_string(self, style="tempo2"):
        """Polyco text in tempo1 or tempo2 style.

        Matches the packages' own fixed-column layout byte-for-byte
        (reference predictor.py:95-132 converter formats: psr <10s,
        date >10s, utc 11.2f, mjd 20.11f, dm 21.6f, doppler 7.3f,
        lgrms 7.3f / rphase 20.6f, f0 18.12f, obs >5s, span 5.0f,
        ncoeff 5d, freq 10.3f [, binphase 7.4f, forb 9.4f]); the two
        styles differ only in the coefficient float format (tempo1
        Fortran ``0.x…D±ee``, tempo2 ``.17e``).  Verified by byte-exact
        round-trips of the reference's real B1937 (tempo1) and B1957
        (tempo2) polyco files.
        """
        out = []
        for e in self.entries:
            mjd_hi, mjd_lo = e.tmid.mjd_pair
            ip = np.floor(mjd_hi)
            line1 = (f"{e.psr:<10s}{e.date:>10s}{float(e.utc):11.2f}"
                     + _two_part_fixed(ip, (mjd_hi - ip) + mjd_lo, 20, 11)
                     + f"{e.dm:21.6f}{e.doppler:7.3f}{e.log10rms:7.3f}")
            line2 = (_two_part_fixed(e.rphase_int, e.rphase_frac, 20, 6)
                     + f"{e.f0:18.12f}{e.obs:>5s}{e.span:5d}{e.ncoeff:5d}"
                     + f"{e.obsfreq:10.3f}")
            if e.binphase is not None:
                line2 += f"{e.binphase:7.4f}"
                if e.forb is not None:
                    line2 += f"{e.forb:9.4f}"
            out.append(line1)
            out.append(line2)
            if style == "tempo1":
                def cfmt(c):
                    return _fortran_d17(c)
            else:
                def cfmt(c):
                    return f"{c:24.17e}"
            for j in range(0, e.ncoeff, 3):
                out.append(" " + " ".join(cfmt(c)
                                          for c in e.coeff[j:j + 3]))
        return "\n".join(out) + "\n"

    def write(self, filename, style="tempo2"):
        with open(filename, "w") as fh:
            fh.write(self.to_string(style=style))

    to_polyco = write
