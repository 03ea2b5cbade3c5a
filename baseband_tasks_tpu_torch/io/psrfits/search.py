"""PSRFITS search-mode (OBS_MODE='SEARCH') read/write.

Search-mode files stream detected (or raw) samples: each SUBINT row holds
``NSBLK`` time samples × ``NCHAN`` × ``NPOL`` at ``TBIN`` sampling, scaled
per row by DAT_SCL/DAT_OFFS and optionally packed at 1/2/4/8 bits
(NBITS).  The upstream ``baseband_tasks`` covers only fold mode; search
mode is provided because survey/FRB users of PSRFITS rely on it.

Counterpart of ``baseband_tasks_tpu/io/psrfits/search.py``: the reader
decodes on the host (``native/``) and hands out tensors on its
``device`` (the card when there is one), as the port's other readers do
(``io/_host.py``); the writer takes numpy or tensors on any device and
writes the same bytes as the JAX package's.

Stream convention: shape ``(nrow * NSBLK, nchan, npol)`` (squeezed of
trailing singleton pol), one SUBINT row per frame.
"""

from __future__ import annotations

import numpy as np

from ... import native
from ...utils import Time, units as u
from ...utils.dtypes import to_numpy
from .._host import FileReader
from . import fitsio
from .fitsio import HDU, Header, bintable_header, write_fits, read_fits

__all__ = ["SearchReader", "SearchWriter"]


def _unpack_bits(raw, nbits):
    raw = np.ascontiguousarray(raw, dtype=np.uint8).ravel()
    if nbits == 8:
        return raw.astype(np.float32)
    if nbits == 4:
        return native.unpack_4bit(raw, offset=0.0)
    if nbits == 2:
        return native.unpack_2bit(raw, np.arange(4, dtype=np.float32))
    if nbits == 1:
        bits = np.unpackbits(raw[:, np.newaxis], axis=1, bitorder="little")
        return bits.ravel().astype(np.float32)
    raise ValueError(f"unsupported NBITS {nbits}")


class SearchReader(FileReader):
    """Stream head over a search-mode PSRFITS file; ``device`` is where
    ``read()`` puts the samples (default: the card when there is one)."""

    def __init__(self, name, weighted=True, device=None):
        hdus = read_fits(name)
        self._primary = hdus[0]
        subint = None
        for hdu in hdus[1:]:
            if str(hdu.header.get("EXTNAME", "")).strip() == "SUBINT":
                subint = hdu
        if subint is None:
            raise ValueError(f"no SUBINT extension found in {name}")
        self._subint = subint
        self._weighted = weighted
        hdr = subint.header
        nrow = hdr["NAXIS2"]
        self._nsblk = hdr["NSBLK"]
        self._nchan = hdr["NCHAN"]
        self._npol = hdr["NPOL"]
        self._nbits = hdr.get("NBITS", 8)
        tbin = float(hdr["TBIN"])
        p = self._primary.header
        from . import _timesys_scale
        stt = Time(float(p["STT_IMJD"]), 0.0, format="mjd",
                   scale=_timesys_scale(p)) \
            + u.Quantity(float(p["STT_SMJD"])
                         + float(p.get("STT_OFFS", 0.0)), u.s)
        rows = subint.data
        offs_sub0 = float(np.asarray(rows["OFFS_SUB"][0]).ravel()[0])
        tsubint = self._nsblk * tbin
        start = stt + u.Quantity(offs_sub0 - tsubint / 2.0, u.s)
        freq = np.atleast_1d(np.asarray(rows["DAT_FREQ"][0],
                                        dtype=np.float64))[:self._nchan]
        self._zero_off = float(hdr.get("ZERO_OFF", 0.0) or 0.0)
        sample_shape = (self._nchan,) + ((self._npol,)
                                         if self._npol > 1 else ())
        super().__init__(
            shape=(nrow * self._nsblk,) + sample_shape,
            start_time=start,
            sample_rate=u.Quantity(1.0 / tbin, u.Hz),
            samples_per_frame=self._nsblk, dtype=np.float32,
            frequency=u.Quantity(
                freq.reshape((self._nchan,) + (1,) * (len(sample_shape) - 1)),
                u.MHz),
            # sideband from the sign of OBSBW (reference hdu.py:169-170)
            sideband=np.int8(-1) if float(
                p.get("OBSBW", hdr.get("OBSBW", 0.0)) or 0.0) < 0
            else np.int8(1), device=device)

    def _read_frame_host(self, frame_index):
        row = self._subint.data[frame_index]
        nsblk, nchan, npol = self._nsblk, self._nchan, self._npol
        comp = _unpack_bits(np.asarray(row["DATA"]), self._nbits)
        data = comp[:nsblk * npol * nchan].reshape(nsblk, npol, nchan)
        scl = np.atleast_1d(np.asarray(row["DAT_SCL"], dtype=np.float32)
                            ).reshape(npol, nchan)
        offs = np.atleast_1d(np.asarray(row["DAT_OFFS"], dtype=np.float32)
                             ).reshape(npol, nchan)
        out = (data - self._zero_off) * scl[np.newaxis] + offs[np.newaxis]
        if self._weighted:
            wts = np.atleast_1d(np.asarray(row["DAT_WTS"],
                                           dtype=np.float32))[:nchan]
            out = out * wts[np.newaxis, np.newaxis, :]
        out = out.transpose(0, 2, 1)  # (nsblk, nchan, npol)
        if npol == 1:
            out = out[:, :, 0]
        return out


def _pack_bits(q, nbits):
    """Pack quantized levels (uint8, flat, C-order) LSB-first per byte —
    the exact inverse of ``_unpack_bits``."""
    q = q.astype(np.uint8).ravel()
    if nbits == 8:
        return q
    if nbits == 4:
        return (q[0::2] | (q[1::2] << 4)).astype(np.uint8)
    if nbits == 2:
        return (q[0::4] | (q[1::4] << 2) | (q[2::4] << 4)
                | (q[3::4] << 6)).astype(np.uint8)
    if nbits == 1:
        return np.packbits(q, bitorder="little")
    raise ValueError(f"unsupported nbits {nbits}")


class SearchWriter:
    """Write a detected stream to search-mode PSRFITS.

    ``template``: stream with shape (n, nchan[, npol]), per-channel
    ``frequency``, and the sample rate defining TBIN; samples accumulate
    via ``write`` into rows of ``nsblk`` and the file is emitted on close.
    ``nbits`` may be 8 (default), 4, 2 or 1; sub-byte modes pack LSB-first
    with per-row DAT_SCL/DAT_OFFS min/max scaling.
    """

    def __init__(self, name, template, *, nsblk=4096, source="",
                 telescope="", nbits=8):
        self._name = name
        shape = template.shape
        if len(shape) == 2:
            shape = shape + (1,)
        if len(shape) != 3:
            raise ValueError("template must be (n, nchan[, npol])")
        self._shape = shape
        if nbits not in (1, 2, 4, 8):
            raise ValueError("nbits must be 1, 2, 4 or 8")
        self._nbits = int(nbits)
        nsblk = int(nsblk)
        if (nsblk * shape[1] * shape[2] * nbits) % 8:
            raise ValueError("nsblk*nchan*npol*nbits must fill whole bytes")
        self._nsblk = nsblk
        self._template = template
        self._source = source
        self._telescope = telescope
        attrs = getattr(template, "meta", {}).get("__attributes__", {})
        freq = attrs.get("frequency")
        if freq is None:
            raise ValueError("template needs per-channel frequency labels")
        fv = np.asarray(freq.to_value(u.MHz), dtype=np.float64)
        full = np.broadcast_to(fv, template.shape[1:])
        while full.ndim < 2:
            full = full[..., np.newaxis]
        self._freq = np.asarray(full.reshape(shape[1], -1)[:, 0],
                                dtype=np.float64)
        self._buffer = np.zeros((0,) + shape[1:], np.float32)
        self._rows = []
        self._closed = False

    def write(self, data):
        data = to_numpy(data).astype(np.float32, copy=False)
        if data.ndim == 2:
            data = data[..., np.newaxis]
        self._buffer = np.concatenate([self._buffer, data])
        while len(self._buffer) >= self._nsblk:
            self._rows.append(self._buffer[:self._nsblk])
            self._buffer = self._buffer[self._nsblk:]

    def close(self):
        if self._closed:
            return
        nt = len(self._rows)
        _, nchan, npol = self._shape
        nsblk = self._nsblk
        tmpl = self._template
        tbin = float(1.0 / tmpl.sample_rate.to_value(u.Hz))
        t0 = tmpl.start_time
        imjd = int(np.floor(t0.mjd))
        hi, lo = t0.mjd_pair
        sec_of_day = ((hi - imjd) + lo) * 86400.0
        smjd = int(np.floor(sec_of_day))
        offs = sec_of_day - smjd

        primary = Header()
        primary.set("FITSTYPE", "PSRFITS")
        primary.set("OBS_MODE", "SEARCH", "search (streaming) mode")
        primary.set("SRC_NAME", self._source)
        primary.set("TELESCOP", self._telescope)
        primary.set("OBSFREQ", float(np.mean(self._freq)))
        primary.set("OBSBW", float(self._freq[-1] - self._freq[0])
                    if nchan > 1 else 0.0)
        primary.set("OBSNCHAN", nchan)
        primary.set("STT_IMJD", imjd)
        primary.set("STT_SMJD", smjd)
        primary.set("STT_OFFS", round(offs, 12))

        nbits = self._nbits
        nbytes = nsblk * nchan * npol * nbits // 8
        data_dim = (nchan, npol, nsblk) if nbits == 8 else (nbytes,)
        columns = [
            ("TSUBINT", "1D", None, "s"),
            ("OFFS_SUB", "1D", None, "s"),
            ("DAT_FREQ", f"{nchan}E", None, "MHz"),
            ("DAT_WTS", f"{nchan}E", None, None),
            ("DAT_OFFS", f"{nchan * npol}E", None, None),
            ("DAT_SCL", f"{nchan * npol}E", None, None),
            ("DATA", f"{nbytes}B", data_dim, None),
        ]
        hdr = bintable_header(columns, nt, "SUBINT")
        hdr.set("NBITS", nbits)
        hdr.set("NCHAN", nchan)
        hdr.set("NPOL", npol)
        hdr.set("NSBLK", nsblk)
        hdr.set("TBIN", tbin)
        hdr.set("CHAN_BW", float(self._freq[1] - self._freq[0])
                if nchan > 1 else 0.0)
        hdr.set("ZERO_OFF", 0.0)
        dtype = fitsio._table_dtype(hdr)
        rows = np.zeros(nt, dtype=dtype)
        tsub = nsblk * tbin
        maxval = (1 << nbits) - 1
        for i, block in enumerate(self._rows):
            d = block.transpose(0, 2, 1)        # (nsblk, npol, nchan)
            dmin = d.min(axis=0)
            dmax = d.max(axis=0)
            scl = (dmax - dmin) / maxval
            scl[scl == 0] = 1.0
            offs_pc = dmin
            q = np.round((d - offs_pc[np.newaxis]) / scl[np.newaxis])
            q = np.clip(q, 0, maxval).astype(np.uint8)
            rows[i]["TSUBINT"] = tsub
            rows[i]["OFFS_SUB"] = (i + 0.5) * tsub
            rows[i]["DAT_FREQ"] = self._freq.astype(np.float32)
            rows[i]["DAT_WTS"] = 1.0
            rows[i]["DAT_OFFS"] = offs_pc.reshape(-1)
            rows[i]["DAT_SCL"] = scl.reshape(-1)
            rows[i]["DATA"] = _pack_bits(q, nbits).reshape(
                rows[i]["DATA"].shape)
        write_fits(self._name, [HDU(primary, None), HDU(hdr, rows)])
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
