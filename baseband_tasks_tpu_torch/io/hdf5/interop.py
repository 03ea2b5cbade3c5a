"""Interoperability with the reference package's HDF5 container format.

Counterpart of ``baseband_tasks_tpu/io/hdf5/interop.py`` (host code: the
header and the payload coding; the reader in ``io/hdf5`` hands the
decoded samples to the device).  The reference package, the upstream
``baseband_tasks`` (``baseband_tasks/io/hdf5/``), serializes its
header as astropy-flavoured yaml (astropy.io.misc.yaml tags such as
``!astropy.time.Time`` and ``!astropy.units.Quantity``; header.py:67-81)
and stores the payload either raw (including the structured
half-precision-complex ``DTYPE_C4``, payload.py:19), or VDIF-bps-encoded
into little-endian uint32 words (payload.py:164-178).

This module reads and writes that exact on-disk layout **without
astropy**: a pyyaml loader/dumper pair implements the astropy yaml tags
over this framework's own `~baseband_tasks_tpu_torch.utils.Time` /
`~baseband_tasks_tpu_torch.utils.units.Quantity` objects, so files written by
the reference open here as ordinary streams, and files written with
``open(name, 'w', style='reference')`` open in the reference package
unchanged.

Scope notes:

- Time scales: this framework keeps a single uniform timescale
  (utils/time.py); headers whose Time carries a location or a scale other
  than utc/tai are rejected rather than silently misread.
- Unit strings: the generic-unit grammar astropy emits for the quantities
  a stream header holds (products/quotients/powers of named units, e.g.
  ``MHz``, ``1 / s``, ``pc / cm3``) is supported; exotic units raise.
"""

from __future__ import annotations

import base64
import re

import numpy as np
import yaml

from ...utils import Time, units as u
from ...utils.dtypes import to_numpy

__all__ = ["load_astropy_yaml", "dump_astropy_yaml", "parse_unit",
           "unit_to_string", "ReferenceHDF5Reader", "ReferenceHDF5Writer"]


# The reference stores half-precision complex with *named* fields
# (payload.py:19).
_REF_DTYPE_C4 = np.dtype([("real", "<f2"), ("imag", "<f2")])


# -- unit string grammar ---------------------------------------------------

def _named_units():
    table = {}
    for name in u.__all__:
        obj = getattr(u, name, None)
        if isinstance(obj, u.Unit):
            table[name] = obj
    # astropy's to_string spellings that differ from our attribute names
    table.setdefault("min", u.minute)
    table.setdefault("h", u.hour)
    table.setdefault("d", u.day)
    table.setdefault("cy", u.cycle)
    return table


_NAMED = _named_units()
_TOKEN = re.compile(r"([A-Za-z_]+?)(?:\*\*|\^)?\(?(-?\d+)?\)?$")


def _parse_product(text):
    result = u.Unit(1.0)
    for token in text.replace("**", "^").split():
        if token in ("*", "."):
            continue
        match = _TOKEN.match(token)
        if not match or match.group(1) not in _NAMED:
            raise u.UnitsError(f"cannot parse unit token {token!r}")
        power = int(match.group(2)) if match.group(2) else 1
        result = result * _NAMED[match.group(1)] ** power
    return result


def parse_unit(string):
    """Parse an astropy ``unit.to_string()`` spelling into our Unit."""
    string = str(string).strip()
    if string in ("", "1", "one", "dimensionless"):
        return u.one
    num, slash, den = string.partition("/")
    if num.strip() in ("", "1"):
        unit = u.Unit(1.0)
    else:
        unit = _parse_product(num)
    if slash:
        unit = unit / _parse_product(den)
    return unit


def unit_to_string(unit):
    """Astropy-compatible spelling of one of our units (named units and
    the compositions the headers use)."""
    for name, known in _NAMED.items():
        if unit == known:
            return name
    # compose: scale must be 1 relative to some named product; fall back
    # to base-dimension spelling  m^a s^b cycle^c Jy^d
    if unit.scale != 1.0:
        raise u.UnitsError(f"cannot spell unit with scale {unit.scale}")
    num, den = [], []
    for name, power in zip(("m", "s", "cycle", "Jy"), unit.powers):
        if power > 0:
            num.append(name if power == 1 else f"{name}{power}")
        elif power < 0:
            den.append(name if power == -1 else f"{name}{-power}")
    if not num:
        num = ["1"]
    out = " ".join(num)
    if den:
        out += " / " + " ".join(den)
    return out


# -- astropy-tagged yaml ---------------------------------------------------

class _AstropyCompatLoader(yaml.SafeLoader):
    pass


class _AstropyCompatDumper(yaml.SafeDumper):
    pass


def _construct_tuple(loader, node):
    return tuple(loader.construct_sequence(node))


def _construct_complex(loader, node):
    return complex(loader.construct_scalar(node))


def _construct_unit(loader, node):
    mapping = loader.construct_mapping(node)
    return parse_unit(mapping["unit"])


def _construct_ndarray(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    # astropy stores base64 *text* (itself wrapped in !!binary by yaml),
    # so after yaml's own decode one more b64decode is always needed
    # (astropy.io.misc.yaml _ndarray_constructor does the same).
    buf = base64.b64decode(mapping["buffer"])
    return np.ndarray(shape=tuple(mapping["shape"]),
                      dtype=np.dtype(mapping["dtype"]),
                      buffer=buf, order=mapping.get("order", "C")).copy()


def _construct_quantity(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    unit = mapping["unit"]
    if not isinstance(unit, u.Unit):
        unit = parse_unit(unit)
    return u.Quantity(mapping["value"], unit)


def _construct_time(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    scale = str(mapping.get("scale", "utc")).lower()
    if scale not in ("utc", "tai"):
        raise ValueError(f"cannot represent time scale {scale!r} (this "
                         f"framework keeps a single uniform timescale)")
    if mapping.get("location") is not None:
        raise ValueError("location-carrying Times are not supported")
    if "jd1" in mapping:
        return Time(np.asarray(mapping["jd1"], dtype=np.float64),
                    np.asarray(mapping["jd2"], dtype=np.float64))
    # string-valued serialization (isot/mjd value)
    value = mapping["value"]
    if mapping.get("format") == "mjd":
        return Time(float(value), format="mjd")
    return Time(str(value))


def _construct_numpy_scalar(loader, node):
    value = loader.construct_mapping(node, deep=True) \
        if isinstance(node, yaml.MappingNode) else loader.construct_scalar(node)
    return float(value)


for _tag, _fn in [
        ("tag:yaml.org,2002:python/tuple", _construct_tuple),
        ("tag:yaml.org,2002:python/complex", _construct_complex),
        ("!astropy.units.Unit", _construct_unit),
        ("!astropy.units.CompositeUnit", _construct_unit),
        ("!numpy.ndarray", _construct_ndarray),
        ("!astropy.units.Quantity", _construct_quantity),
        ("!astropy.time.Time", _construct_time),
        ("!numpy.float64", _construct_numpy_scalar),
]:
    _AstropyCompatLoader.add_constructor(_tag, _fn)


def _represent_tuple(dumper, data):
    return dumper.represent_sequence("tag:yaml.org,2002:python/tuple",
                                     list(data))


def _represent_unit(dumper, data):
    return dumper.represent_mapping("!astropy.units.Unit",
                                    {"unit": unit_to_string(data)})


def _represent_quantity(dumper, data):
    value = np.asarray(data.value)
    if value.ndim == 0:
        value = float(value)
    return dumper.represent_mapping("!astropy.units.Quantity",
                                    {"unit": data.unit, "value": value})


def _represent_time(dumper, data):
    out = {"jd1": float(np.asarray(data.jd1)),
           "jd2": float(np.asarray(data.jd2)),
           "format": "jd", "scale": "utc", "precision": 3,
           "in_subfmt": "*", "out_subfmt": "*"}
    return dumper.represent_mapping("!astropy.time.Time", out)


def _represent_ndarray(dumper, data):
    data = np.ascontiguousarray(data)
    out = {"buffer": base64.b64encode(data.tobytes()),
           "dtype": str(data.dtype), "shape": tuple(data.shape),
           "order": "C"}
    return dumper.represent_mapping("!numpy.ndarray", out)


_AstropyCompatDumper.add_representer(tuple, _represent_tuple)
_AstropyCompatDumper.add_representer(u.Unit, _represent_unit)
_AstropyCompatDumper.add_representer(u.Quantity, _represent_quantity)
_AstropyCompatDumper.add_representer(Time, _represent_time)
_AstropyCompatDumper.add_representer(np.ndarray, _represent_ndarray)
for _np_scalar in (np.float64, np.float32):
    _AstropyCompatDumper.add_representer(
        _np_scalar, yaml.representer.SafeRepresenter.represent_float)
for _np_int in (np.int64, np.int32, np.int16, np.int8):
    _AstropyCompatDumper.add_representer(
        _np_int, yaml.representer.SafeRepresenter.represent_int)
_AstropyCompatDumper.add_representer(
    np.bool_, yaml.representer.SafeRepresenter.represent_bool)


def load_astropy_yaml(text):
    """Load astropy-flavoured yaml into this framework's objects."""
    if isinstance(text, bytes):
        text = text.decode()
    return yaml.load(text, Loader=_AstropyCompatLoader)


def dump_astropy_yaml(obj):
    """Dump a header dict in astropy-flavoured yaml (reference-readable)."""
    return yaml.dump(obj, Dumper=_AstropyCompatDumper,
                     default_flow_style=False)


def is_reference_header(data):
    """Whether raw yaml header bytes came from the reference package."""
    if isinstance(data, bytes):
        data = data.decode(errors="replace")
    return "!astropy." in data


# -- reading ----------------------------------------------------------------

def _decode_coded(words, bps, complex_data, count_shape, dtype):
    """Decode VDIF-bps-coded uint32 words (reference payload.py:164-178;
    LSB-first within each little-endian word, so a plain byte view keeps
    sample order)."""
    from ..vdif import _decode_payload

    n_comp = int(np.prod(count_shape)) * (2 if complex_data else 1)
    raw = np.ascontiguousarray(words).view("<u4").view(np.uint8)
    comp = _decode_payload(raw, bps)[:n_comp]
    if complex_data:
        comp = comp.reshape(count_shape + (2,))
        return (comp[..., 0] + 1j * comp[..., 1]).astype(dtype)
    return comp.reshape(count_shape).astype(dtype)


def _encode_coded(data, bps, complex_data):
    from ..vdif import _encode_payload

    if complex_data:
        comp = np.stack([data.real, data.imag], axis=-1).ravel()
    else:
        comp = np.asarray(data).ravel()
    raw = np.frombuffer(_encode_payload(comp.astype(np.float32), bps),
                        np.uint8)
    pad = (-raw.size) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    return raw.view("<u4")


class ReferenceHDF5Reader:
    """Build the stream-head kwargs and frame decoder for a reference file.

    Used by :class:`~baseband_tasks_tpu_torch.io.hdf5.HDF5StreamReader`
    through ``hdf5.open``; kept separate so it can also be driven
    directly.
    """

    def __init__(self, h5file):
        self._h5 = h5file
        hdr = load_astropy_yaml(h5file["header"][()])
        self.header = hdr
        self.sample_shape = tuple(hdr["sample_shape"])
        self.samples_per_frame = int(hdr["samples_per_frame"])
        self.sample_rate = hdr["sample_rate"]
        self.start_time = hdr["time"]
        self.bps = hdr.get("bps")
        if self.bps is not None:
            self.complex_data = bool(hdr["complex_data"])
            self.dtype = np.dtype("c8" if self.complex_data else "f4")
            self.encoded_dtype = np.dtype("<u4")
        else:
            encoded = hdr.get("encoded_dtype", hdr["dtype"])
            if str(encoded) in ("<c4", "c4", "complex32"):
                self.encoded_dtype = _REF_DTYPE_C4
            else:
                self.encoded_dtype = np.dtype(encoded)
            self.dtype = np.dtype(hdr["dtype"])
            self.complex_data = self.dtype.kind == "c"
        self.shape = (self.samples_per_frame,) + self.sample_shape

    @property
    def attributes(self):
        out = {}
        for name in ("frequency", "sideband", "polarization"):
            if self.header.get(name) is not None:
                out[name] = self.header[name]
        # streams need frequency/sideband as a pair; tolerate files
        # carrying only one (default upper sideband / drop unpaired)
        if "frequency" in out and "sideband" not in out:
            out["sideband"] = np.int8(1)
        elif "sideband" in out and "frequency" not in out:
            del out["sideband"]
        return out

    def read_range(self, start, stop):
        """Decoded samples [start, stop) as a numpy array."""
        payload = self._h5["payload"]
        if self.bps is None:
            raw = payload[start:stop]
            if raw.dtype == _REF_DTYPE_C4:
                return (raw["real"].astype(np.float32)
                        + 1j * raw["imag"].astype(np.float32)
                        ).astype(self.dtype)
            return np.asarray(raw).astype(self.dtype, copy=False)
        # coded: whole frame is one flat word stream; decode the byte-
        # aligned superset covering [start, stop) and slice.
        comp_per_sample = int(np.prod(self.sample_shape)) \
            * (2 if self.complex_data else 1)
        comp_per_word = 32 // self.bps
        w0 = start * comp_per_sample // comp_per_word
        w1 = -(-(stop * comp_per_sample) // comp_per_word)
        words = payload[w0:w1]
        first = w0 * comp_per_word // comp_per_sample
        count = -(-w1 * comp_per_word // comp_per_sample)
        count = min(count, self.shape[0]) - first
        out = _decode_coded(words, self.bps, self.complex_data,
                            (count,) + self.sample_shape, self.dtype)
        return out[start - first:stop - first]


class ReferenceHDF5Writer:
    """Write a stream into the reference package's on-disk layout.

    Parameters mirror
    :class:`~baseband_tasks_tpu_torch.io.hdf5.HDF5StreamWriter`:
    a ``template`` stream supplies shape/rate/time/attribute metadata;
    ``encoded_dtype`` may be a numpy dtype or ``'c4'``; ``bps`` (1/2/4/8)
    selects VDIF-coded storage.
    """

    def __init__(self, name, template, *, encoded_dtype=None, bps=None,
                 **overrides):
        import h5py

        dtype = np.dtype(template.dtype)
        header = {
            "sample_shape": tuple(int(n) for n in template.shape[1:]),
            "samples_per_frame": int(template.shape[0]),
            "sample_rate": template.sample_rate,
            "time": template.start_time,
        }
        attrs = getattr(template, "meta", {}).get("__attributes__", {})
        for key in ("frequency", "sideband", "polarization"):
            value = overrides.get(key, attrs.get(key))
            if value is not None:
                header[key] = value
        if bps is not None:
            header["bps"] = int(bps)
            header["complex_data"] = dtype.kind == "c"
            payload_dtype = np.dtype("<u4")
            comp = (2 if dtype.kind == "c" else 1) \
                * int(np.prod(template.shape))
            payload_shape = ((bps * comp + 31) // 32,)
        else:
            if encoded_dtype is None:
                encoded_dtype = dtype
            if str(encoded_dtype) in ("<c4", "c4", "complex32"):
                header["encoded_dtype"] = "<c4"
                header["dtype"] = "complex64"
                payload_dtype = _REF_DTYPE_C4
            else:
                payload_dtype = np.dtype(encoded_dtype)
                header["encoded_dtype"] = str(payload_dtype)
                header["dtype"] = str(np.dtype(
                    "f4" if payload_dtype == np.dtype("f2") else dtype))
            payload_shape = tuple(template.shape)
        self._bps = bps
        self._dtype = dtype
        self._shape = tuple(template.shape)
        self._h5 = h5py.File(name, "w")
        self._h5.create_dataset("header",
                                data=dump_astropy_yaml(header))
        self._payload = self._h5.create_dataset(
            "payload", shape=payload_shape, dtype=payload_dtype)
        self._offset = 0

    def write(self, data):
        data = to_numpy(data)
        start, stop = self._offset, self._offset + len(data)
        if stop > self._shape[0]:
            raise EOFError("writing beyond end of declared stream shape")
        if self._bps is not None:
            comp_per_sample = int(np.prod(self._shape[1:])) \
                * (2 if self._dtype.kind == "c" else 1)
            comp_per_word = 32 // self._bps
            if (start * comp_per_sample) % comp_per_word:
                raise ValueError("coded writes must stay word-aligned")
            words = _encode_coded(data, self._bps,
                                  self._dtype.kind == "c")
            w0 = start * comp_per_sample // comp_per_word
            self._payload[w0:w0 + len(words)] = words
        elif self._payload.dtype == _REF_DTYPE_C4:
            packed = np.empty(data.shape, _REF_DTYPE_C4)
            packed["real"] = data.real.astype(np.float16)
            packed["imag"] = data.imag.astype(np.float16)
            self._payload[start:stop] = packed
        else:
            self._payload[start:stop] = data.astype(self._payload.dtype)
        self._offset = stop

    def tell(self):
        return self._offset

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
