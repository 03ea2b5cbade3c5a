"""Minimal FITS reader/writer (primary HDUs + binary tables).

astropy is not a dependency of this framework, so this module implements
the small subset of FITS needed for PSRFITS fold-mode files: 2880-byte
blocks of 80-character header cards, and BINTABLE extensions encoded as
big-endian numpy structured arrays (TFORM codes A/B/I/J/K/E/D, repeat
counts, TDIM shapes).

A copy of ``baseband_tasks_tpu/io/psrfits/fitsio.py`` (host code, no
device), the counterpart of the upstream ``baseband_tasks``' use of
``astropy.io.fits`` in ``io/psrfits/core.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Header", "HDU", "read_fits", "write_fits"]

BLOCK = 2880
CARD = 80

_TFORM_DTYPES = {
    "L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8", "A": "S",
}


class Header:
    """Ordered FITS header: mapping plus comments."""

    def __init__(self, cards=None):
        self._keys = []
        self._values = {}
        self._comments = {}
        if cards:
            for key, value, comment in cards:
                self[key] = value
                if comment:
                    self._comments[key] = comment

    def __contains__(self, key):
        return key in self._values

    def __getitem__(self, key):
        return self._values[key]

    def get(self, key, default=None):
        return self._values.get(key, default)

    def __setitem__(self, key, value):
        if key not in self._values:
            self._keys.append(key)
        self._values[key] = value

    def set(self, key, value, comment=None):
        self[key] = value
        if comment:
            self._comments[key] = comment

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self._values[k]) for k in self._keys]

    # -- serialization ---------------------------------------------------
    @staticmethod
    def _format_value(value):
        if isinstance(value, bool):
            return "T" if value else "F", True
        if isinstance(value, (int, np.integer)):
            return str(int(value)), True
        if isinstance(value, (float, np.floating)):
            s = f"{float(value):.14G}"
            if "." not in s and "E" not in s:
                s += "."
            return s, True
        s = str(value).replace("'", "''")
        return f"'{s:<8s}'", False

    def to_bytes(self):
        out = []
        for key in self._keys:
            value = self._values[key]
            comment = self._comments.get(key, "")
            if key in ("COMMENT", "HISTORY"):
                card = f"{key:<8s}{value}"[:CARD]
            else:
                vs, right = self._format_value(value)
                vs = vs.rjust(20) if right else vs
                card = f"{key:<8s}= {vs}"
                if comment:
                    card += f" / {comment}"
            out.append(card[:CARD].ljust(CARD))
        out.append("END".ljust(CARD))
        data = "".join(out).encode("ascii")
        pad = (-len(data)) % BLOCK
        return data + b" " * pad

    @classmethod
    def from_bytes(cls, raw):
        hdr = cls()
        for i in range(0, len(raw), CARD):
            card = raw[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] != "= ":
                continue
            body = card[10:]
            # strip comment (respect quoted strings)
            if body.lstrip().startswith("'"):
                start = body.index("'")
                j = start + 1
                while j < len(body):
                    if body[j] == "'":
                        if j + 1 < len(body) and body[j + 1] == "'":
                            j += 2
                            continue
                        break
                    j += 1
                value = body[start + 1:j].replace("''", "'").rstrip()
                comment = body[j + 1:].lstrip().lstrip("/").strip()
            else:
                parts = body.split("/", 1)
                vs = parts[0].strip()
                comment = parts[1].strip() if len(parts) > 1 else ""
                if vs == "T":
                    value = True
                elif vs == "F":
                    value = False
                else:
                    try:
                        value = int(vs)
                    except ValueError:
                        try:
                            value = float(vs)
                        except ValueError:
                            value = vs
            hdr[key] = value
            if comment:
                hdr._comments[key] = comment
        return hdr


def _parse_tform(tform):
    """TFORM like '16E' -> (16, 'E')."""
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    count = int(tform[:i]) if i else 1
    return count, tform[i]


def _table_dtype(header):
    """Build a big-endian structured dtype from BINTABLE header."""
    fields = []
    for n in range(1, header["TFIELDS"] + 1):
        name = header[f"TTYPE{n}"].strip()
        count, code = _parse_tform(header[f"TFORM{n}"])
        base = _TFORM_DTYPES[code]
        if code == "A":
            fields.append((name, f"S{count}"))
            continue
        tdim = header.get(f"TDIM{n}")
        if tdim:
            shape = tuple(int(x) for x in
                          tdim.strip().strip("()").split(","))[::-1]
        else:
            # count == 0 (legal FITS: an absent column) must consume
            # zero bytes, not a scalar slot
            shape = (count,) if count != 1 else ()
        fields.append((name, base, shape) if shape else (name, base))
    return np.dtype(fields)


class HDU:
    """One header-data unit: header plus (possibly empty) data."""

    def __init__(self, header=None, data=None):
        self.header = header if header is not None else Header()
        self.data = data

    @property
    def name(self):
        return self.header.get("EXTNAME", "PRIMARY").strip() \
            if isinstance(self.header.get("EXTNAME", "PRIMARY"), str) \
            else "PRIMARY"


def read_fits(name):
    """Read all HDUs from a FITS file."""
    hdus = []
    with open(name, "rb") as fh:
        while True:
            raw = fh.read(BLOCK)
            if len(raw) < BLOCK:
                break
            blocks = [raw]
            while b"END" not in _card_keys(blocks[-1]):
                cont = fh.read(BLOCK)
                if len(cont) < BLOCK:
                    raise ValueError(
                        f"truncated FITS header in {name}: EOF before END "
                        f"card")
                blocks.append(cont)
            header = Header.from_bytes(b"".join(blocks))
            data = None
            nbytes = _data_nbytes(header)
            if nbytes:
                payload = fh.read(nbytes)
                fh.read((-nbytes) % BLOCK)
                if header.get("XTENSION", "").strip() == "BINTABLE":
                    dtype = _table_dtype(header)
                    data = np.frombuffer(payload, dtype=dtype,
                                         count=header["NAXIS2"])
                else:
                    data = payload
            hdus.append(HDU(header, data))
    return hdus


def _card_keys(block):
    keys = []
    for i in range(0, len(block), CARD):
        keys.append(block[i:i + 8].strip())
    return keys


def _data_nbytes(header):
    naxis = header.get("NAXIS", 0)
    if not naxis:
        return 0
    size = 1
    for i in range(1, naxis + 1):
        size *= header[f"NAXIS{i}"]
    bitpix = abs(header["BITPIX"])
    return size * bitpix // 8


def write_fits(name, hdus):
    """Write HDUs to a FITS file (primary first)."""
    with open(name, "wb") as fh:
        for k, hdu in enumerate(hdus):
            hdr = hdu.header
            if k == 0 and "SIMPLE" not in hdr:
                full = Header()
                full.set("SIMPLE", True)
                full.set("BITPIX", 8)
                full.set("NAXIS", 0)
                full.set("EXTEND", True)
                for key, val in hdr.items():
                    full[key] = val
                full._comments.update(hdr._comments)
                hdr = full
            fh.write(hdr.to_bytes())
            if hdu.data is not None:
                raw = hdu.data.tobytes() if isinstance(hdu.data, np.ndarray) \
                    else hdu.data
                fh.write(raw)
                fh.write(b"\x00" * ((-len(raw)) % BLOCK))


def bintable_header(columns, nrows, extname):
    """Header for a BINTABLE with ``columns`` = [(name, tform, tdim|None, unit|None)]."""
    hdr = Header()
    hdr.set("XTENSION", "BINTABLE")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 2)
    row_bytes = 0
    for name, tform, tdim, unit in columns:
        count, code = _parse_tform(tform)
        itemsize = 1 if code in "LBA" else np.dtype(
            _TFORM_DTYPES[code]).itemsize
        row_bytes += count * itemsize
    hdr.set("NAXIS1", row_bytes)
    hdr.set("NAXIS2", nrows)
    hdr.set("PCOUNT", 0)
    hdr.set("GCOUNT", 1)
    hdr.set("TFIELDS", len(columns))
    for i, (name, tform, tdim, unit) in enumerate(columns, 1):
        hdr.set(f"TTYPE{i}", name)
        hdr.set(f"TFORM{i}", tform)
        if tdim:
            hdr.set(f"TDIM{i}", "(" + ",".join(str(x) for x in tdim) + ")")
        if unit:
            hdr.set(f"TUNIT{i}", unit)
    hdr.set("EXTNAME", extname)
    return hdr
