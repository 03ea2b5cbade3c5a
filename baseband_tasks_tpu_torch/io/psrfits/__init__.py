"""PSRFITS fold-mode read/write.

Counterpart of ``baseband_tasks_tpu/io/psrfits/`` and of the upstream
``baseband_tasks/io/psrfits/`` (``open``/readers core.py:16-131, SUBINT
property bridge hdu.py:104-571):
fold-mode PSRFITS files are exposed as streams of subintegrations with
sample shape ``(nbin, nchan, npol)``; DAT_SCL/DAT_OFFS/ZERO_OFF scaling and
optional DAT_WTS weighting are applied on read, and the writer quantizes to
16-bit integers with per-subint, per-(pol,chan) scales.

Built on the pure-python FITS layer in ``fitsio`` (astropy is not a
dependency of this framework).  Readers decode on the host and hand out
tensors on their ``device`` (the card when there is one), as the port's
other readers do (``io/_host.py``); writers take numpy or tensors on any
device and write the same bytes as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ...utils import Time, units as u
from ...utils.dtypes import to_numpy
from .._host import FileReader
from . import fitsio
from .fitsio import HDU, Header, bintable_header, read_fits, write_fits

from .search import SearchReader, SearchWriter

__all__ = ["open", "get_readers", "get_writer", "PSRFITSReader",
           "PSRFITSWriter", "SearchReader", "SearchWriter"]

def _float_card(header, key, default=0.0):
    """Float card value, tolerating undefined markers real telescope
    files carry (e.g. PUPPI writes ``ZERO_OFF= '*'``)."""
    value = header.get(key, default)
    try:
        return float(value)
    except (TypeError, ValueError):
        return float(default)


def _timesys_scale(primary_header):
    """Timescale of the STT_* epoch, from the file's TIMESYS card.

    PSRFITS STT_IMJD/SMJD/OFFS are in the scale named by TIMESYS
    (almost always UTC; the upstream package gets this from astropy
    Time, its io/psrfits/hdu.py:104-124).  Unknown/unsupported values
    (e.g. TDB, which stream bookkeeping never needs) fall back to UTC
    with a warning rather than failing the read.
    """
    value = str(primary_header.get("TIMESYS", "UTC")).strip().lower()
    if value in ("", "utc", "tai", "tt"):
        return value or "utc"
    import warnings
    warnings.warn(f"PSRFITS TIMESYS={value!r} not supported; "
                  "treating STT_* epoch as UTC")
    return "utc"


_POL_LABELS = {
    "AA,BB": ["AA", "BB"],
    "AABB": ["AA", "BB"],
    "AABBCRCI": ["AA", "BB", "CR", "CI"],
    "IQUV": ["I", "Q", "U", "V"],
    "INTEN": ["I"],
    "STOKES": ["I", "Q", "U", "V"],
}


class PSRFITSReader(FileReader):
    """Stream of fold-mode subintegrations from a PSRFITS file; ``device``
    is where ``read()`` puts them (default: the card when there is
    one)."""

    def __init__(self, name, weighted=True, device=None):
        hdus = read_fits(name)
        primary = hdus[0]
        subint = None
        for hdu in hdus[1:]:
            if str(hdu.header.get("EXTNAME", "")).strip() == "SUBINT":
                subint = hdu
        if subint is None:
            raise ValueError(f"no SUBINT extension found in {name}")
        self._primary = primary
        self._subint = subint
        self._weighted = weighted
        hdr = subint.header
        nrow = hdr["NAXIS2"]
        nbin = hdr["NBIN"]
        nchan = hdr["NCHAN"]
        npol = hdr["NPOL"]
        tbin = hdr.get("TBIN", 0.0)
        # start time: STT_IMJD/SMJD/OFFS plus first-subint centring
        # (reference hdu.py:104-124, 521-554)
        p = primary.header
        stt = Time(float(p["STT_IMJD"]), 0.0, format="mjd",
                   scale=_timesys_scale(p)) \
            + u.Quantity(float(p["STT_SMJD"]) + float(p.get("STT_OFFS", 0.0)),
                         u.s)
        rows = subint.data
        tsubint = float(np.asarray(rows["TSUBINT"][0]).ravel()[0])
        offs_sub0 = float(np.asarray(rows["OFFS_SUB"][0]).ravel()[0])
        start = stt + u.Quantity(offs_sub0 - tsubint / 2.0, u.s)
        freq = np.atleast_1d(np.asarray(rows["DAT_FREQ"][0],
                                        dtype=np.float64))[:nchan]
        pol_type = str(hdr.get("POL_TYPE", "")).strip()
        pols = _POL_LABELS.get(pol_type)
        # sideband from the sign of OBSBW (reference hdu.py:169-170)
        obsbw = float(p.get("OBSBW", hdr.get("OBSBW", 0.0)) or 0.0)
        sideband = np.int8(-1) if obsbw < 0 else np.int8(1)
        super().__init__(
            shape=(nrow, nbin, nchan, npol), start_time=start,
            sample_rate=u.Quantity(1.0 / tsubint, u.Hz),
            samples_per_frame=1, dtype=np.float32,
            frequency=u.Quantity(freq.reshape(nchan, 1), u.MHz),
            sideband=sideband,
            polarization=np.asarray(pols) if pols and len(pols) == npol
            else None, device=device)
        self._nbin, self._nchan, self._npol = nbin, nchan, npol
        self._zero_off = _float_card(hdr, "ZERO_OFF")

    @property
    def telescope(self):
        return str(self._primary.header.get("TELESCOP", "")).strip()

    @property
    def source(self):
        return str(self._primary.header.get("SRC_NAME", "")).strip()

    def _read_frame_host(self, frame_index):
        row = self._subint.data[frame_index]
        nbin, nchan, npol = self._nbin, self._nchan, self._npol
        data = np.asarray(row["DATA"], dtype=np.float32)
        data = data.reshape(npol, nchan, nbin)
        scl = np.asarray(row["DAT_SCL"], dtype=np.float32
                         ).reshape(npol, nchan)
        offs = np.asarray(row["DAT_OFFS"], dtype=np.float32
                          ).reshape(npol, nchan)
        out = (data - self._zero_off) * scl[:, :, np.newaxis] \
            + offs[:, :, np.newaxis]
        if self._weighted:
            wts = np.atleast_1d(np.asarray(row["DAT_WTS"],
                                           dtype=np.float32))[:nchan]
            out = out * wts[np.newaxis, :, np.newaxis]
        # (npol, nchan, nbin) -> stream convention (nbin, nchan, npol)
        # (reference core.py:215-217)
        return out.transpose(2, 1, 0)[np.newaxis]


class PSRFITSWriter:
    """Write a folded stream to a fold-mode PSRFITS file.

    ``template`` must be a stream with shape (nt, nbin, nchan[, npol]),
    ``sample_rate = 1/TSUBINT``, a start_time, and a per-channel
    ``frequency``; rows accumulate via ``write`` and the file is emitted on
    ``close`` (reference core.py:225-278 fills a template HDU then writes).
    """

    def __init__(self, name, template, *, source="", telescope="",
                 pol_type=None, dm=0.0, rm=0.0):
        self._name = name
        shape = template.shape
        while len(shape) < 4:
            shape = shape + (1,)
        if len(shape) != 4:
            raise ValueError("template must be (nt, nbin[, nchan[, npol]])")
        self._shape = shape
        self._rows = []
        self._template = template
        self._source = source
        self._telescope = telescope
        self._dm = float(getattr(dm, "value", dm))
        self._rm = float(rm)
        attrs = getattr(template, "meta", {}).get("__attributes__", {})
        freq = attrs.get("frequency")
        if freq is None:
            raise ValueError("template needs per-channel frequency labels")
        fv = np.asarray(freq.to_value(u.MHz), dtype=np.float64)
        # broadcast against the template's true sample shape (before any
        # channel/pol padding), then reduce to one frequency per channel
        full = np.broadcast_to(fv, template.shape[1:])
        while full.ndim < 3:
            full = full[..., np.newaxis]
        self._freq = np.asarray(full[0, :, 0], dtype=np.float64)
        self._pol_type = pol_type or ("AABBCRCI" if shape[3] == 4
                                      else "AA,BB" if shape[3] == 2
                                      else "INTEN")
        self._closed = False

    def write(self, data):
        data = to_numpy(data).astype(np.float32, copy=False)
        sample_ndim = len(self._template.shape) - 1
        if data.ndim == sample_ndim:  # a single subintegration
            data = data[np.newaxis]
        while data.ndim < 4:  # pad missing channel/polarization axes
            data = data[..., np.newaxis]
        self._rows.extend(data)

    def close(self):
        if self._closed:
            return
        nt = len(self._rows)
        _, nbin, nchan, npol = self._shape
        tmpl = self._template
        tsubint = float(1.0 / tmpl.sample_rate.to_value(u.Hz))
        t0 = tmpl.start_time
        imjd = int(np.floor(t0.mjd))
        day_frac_hi, day_frac_lo = t0.mjd_pair
        sec_of_day = ((day_frac_hi - imjd) + day_frac_lo) * 86400.0
        smjd = int(np.floor(sec_of_day))
        offs = sec_of_day - smjd

        primary = Header()
        primary.set("HDRVER", "5.4", "header version")
        primary.set("FITSTYPE", "PSRFITS", "FITS definition for pulsar data")
        primary.set("OBS_MODE", "PSR", "fold mode")
        primary.set("SRC_NAME", self._source)
        primary.set("TELESCOP", self._telescope)
        primary.set("OBSFREQ", float(np.mean(self._freq)))
        primary.set("OBSBW", float((self._freq[-1] - self._freq[0]))
                    if nchan > 1 else 0.0)
        primary.set("OBSNCHAN", nchan)
        primary.set("STT_IMJD", imjd, "start MJD (int day)")
        primary.set("STT_SMJD", smjd, "start second of day")
        primary.set("STT_OFFS", round(offs, 12), "start fractional second")

        columns = [
            ("TSUBINT", "1D", None, "s"),
            ("OFFS_SUB", "1D", None, "s"),
            ("DAT_FREQ", f"{nchan}E", None, "MHz"),
            ("DAT_WTS", f"{nchan}E", None, None),
            ("DAT_OFFS", f"{nchan * npol}E", None, None),
            ("DAT_SCL", f"{nchan * npol}E", None, None),
            ("DATA", f"{nbin * nchan * npol}I", (nbin, nchan, npol), None),
        ]
        # spec-required SUBINT description cards, using the conventions
        # of real PUPPI files (reference data
        # B1855+09.430.PUPPI.11y.x.sum.sm; '*' marks not-applicable)
        hdr = bintable_header(columns, nt, "SUBINT")
        hdr.set("EPOCHS", "VALID", "epoch convention (VALID/MIDTIME/STT_MJD)")
        hdr.set("INT_TYPE", "TIME", "subint axis: time")
        hdr.set("INT_UNIT", "SEC", "subint axis unit")
        hdr.set("SCALE", "FluxDen", "data scale (FluxDen/RefFlux/Jansky)")
        hdr.set("NPOL", npol)
        hdr.set("POL_TYPE", self._pol_type)
        hdr.set("TBIN", tsubint / nbin)
        hdr.set("NBIN", nbin)
        hdr.set("NBIN_PRD", nbin, "bins in one period")
        hdr.set("PHS_OFFS", 0.0, "phase offset of bin 0")
        hdr.set("NBITS", 1, "unused in fold mode")
        hdr.set("ZERO_OFF", 0.0)
        hdr.set("SIGNINT", 0, "1 if data are signed ints")
        hdr.set("NSUBOFFS", 0, "subint offset")
        hdr.set("NCHAN", nchan)
        hdr.set("CHAN_BW", float(self._freq[1] - self._freq[0])
                if nchan > 1 else 0.0)
        hdr.set("DM", self._dm, "pc/cm^3")
        hdr.set("RM", self._rm, "rad m^-2")
        hdr.set("NCHNOFFS", 0, "channel offset")
        hdr.set("NSBLK", 1)
        hdr.set("NSTOT", nt, "total subints")
        dtype = fitsio._table_dtype(hdr)
        rows = np.zeros(nt, dtype=dtype)
        for i, frame in enumerate(self._rows):
            # frame: (nbin, nchan, npol) -> storage (npol, nchan, nbin)
            d = frame.transpose(2, 1, 0)
            dmin = d.min(axis=-1)
            dmax = d.max(axis=-1)
            scl = (dmax - dmin) / 65534.0
            scl[scl == 0] = 1.0
            offs_pc = (dmax + dmin) / 2.0
            q = np.round((d - offs_pc[:, :, None]) / scl[:, :, None])
            # Repeat-1 table columns make scalar structured fields; assign
            # a 0-d value there (ndim>0 -> scalar assignment is a numpy
            # deprecation on its way to an error).
            def _put(field, value):
                value = np.asarray(value).reshape(-1)
                rows[i][field] = value if rows[i][field].ndim else value[0]

            rows[i]["TSUBINT"] = tsubint
            rows[i]["OFFS_SUB"] = (i + 0.5) * tsubint
            _put("DAT_FREQ", self._freq.astype(np.float32))
            rows[i]["DAT_WTS"] = 1.0
            _put("DAT_OFFS", offs_pc)
            _put("DAT_SCL", scl)
            rows[i]["DATA"] = q.astype(">i2")
        write_fits(self._name, [HDU(primary, None), HDU(hdr, rows)])
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def _peek_obs_mode(name):
    """OBS_MODE from the primary header only (no payload read — a
    search-mode file can be many GB)."""
    import builtins
    from .fitsio import BLOCK, Header
    raw = b""
    with builtins.open(name, "rb") as fh:
        while True:
            chunk = fh.read(BLOCK)
            if len(chunk) < BLOCK:
                raise ValueError(f"truncated FITS header in {name}")
            raw += chunk
            if b"END     " in chunk or chunk.rstrip(b" ").endswith(b"END"):
                break
            if len(raw) > 200 * BLOCK:
                raise ValueError("FITS primary header too long")
    hdr = Header.from_bytes(raw)
    return str(hdr.get("OBS_MODE", "PSR")).strip().upper()


def get_readers(name, **kwargs):
    """All stream readers a PSRFITS file supports, one per data HDU
    (reference core.py:92-131 builds one reader per SUBINT HDU; our
    container keeps a single SUBINT, so this is a 1-element list, with
    search-mode files dispatched to :class:`SearchReader`)."""
    if _peek_obs_mode(name) == "SEARCH":
        return [SearchReader(name, **kwargs)]
    return [PSRFITSReader(name, **kwargs)]


def get_writer(name, template, *, obs_mode="PSR", **kwargs):
    """Writer for a PSRFITS file of the given observation mode
    (reference core.py:134-166 dispatches on ``hdu.obs_mode``)."""
    if str(obs_mode).upper() == "SEARCH":
        return SearchWriter(name, template=template, **kwargs)
    return PSRFITSWriter(name, template, **kwargs)


def open(name, mode="r", obs_mode=None, **kwargs):
    """Open a PSRFITS file.

    'r' auto-detects fold vs search mode from OBS_MODE; 'w' writes fold
    mode by default, pass ``obs_mode='search'`` for streaming files.  Both
    writers need ``template=``.
    """
    if mode == "r":
        if obs_mode is None:
            hdus = read_fits(name)
            obs_mode = str(hdus[0].header.get("OBS_MODE", "PSR")).strip()
        if obs_mode.upper() == "SEARCH":
            return SearchReader(name, **kwargs)
        return PSRFITSReader(name, **kwargs)
    if mode == "w":
        if obs_mode and obs_mode.upper() == "SEARCH":
            return SearchWriter(name, **kwargs)
        return PSRFITSWriter(name, **kwargs)
    raise ValueError(f"unknown mode {mode!r}")
