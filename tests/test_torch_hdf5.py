"""The port's HDF5 stream container (``io/hdf5``) against the JAX
package's, on the CPU.

The same numpy samples go through both packages' writers and readers:
a file written by either package's writer reads back identically in the
other's reader, and the two writers write the same header text and
payload bytes, for raw, half-precision ('c4') and bit-packed (8, 4 and
2 bits; neither package has a 1-bit HDF5 coding) payloads, with invalid
ranges, in the native and in the reference package's layout.  The
frozen reference-layout fixtures read bit for bit, and the port's writer
reproduces their bytes.  Packed reads (``read_packed`` +
``packed_decode_fn``) decode bit for bit against the host read.
Readers and writers are host code, so samples must agree exactly.
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.io import hdf5 as jhdf5  # noqa: E402
from baseband_tasks_tpu.io.hdf5 import interop as jinterop  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.io import hdf5 as phdf5  # noqa: E402
from baseband_tasks_tpu_torch.io.hdf5 import interop as pinterop  # noqa: E402,E501
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

START = "2018-04-01T13:00:00.000000000"
RATE = 1_000_000
DATA = os.path.join(os.path.dirname(__file__), "data")


def samples(shape, dtype, scale=1.0, seed=17):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * scale
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape) * scale
    return x.astype(dtype)


def templates(data, spf=1024, rate=RATE, start=START, freq_mhz=400.0,
              pol=("X", "Y")):
    """``data`` as a stream of each package (the port's on the CPU),
    labelled with frequency, sideband and (for two lanes) polarization."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time, **kw):
        gen = pkg.StreamGenerator(frame, data.shape, time(start),
                                  units.Quantity(rate, units.Hz),
                                  samples_per_frame=spf, dtype=data.dtype,
                                  **kw)
        chans = data.shape[1:2] + (1,) * max(data.ndim - 2, 0)
        attrs = dict(frequency=units.Quantity(np.full(chans, freq_mhz),
                                              units.MHz), sideband=1)
        if data.ndim > 1 and data.shape[-1] == 2 and pol:
            attrs["polarization"] = list(pol)
        return pkg.SetAttribute(gen, **attrs)
    return make(pb, pu, PTime, device="cpu"), make(jb, ju, JTime)


def datasets(path):
    """(header bytes, payload bytes) of an HDF5 stream file."""
    with h5py.File(path, "r") as f:
        hdr = f["header"][()]
        payload = np.asarray(f["payload"][()])
    return hdr, payload.view(np.uint8).tobytes()


def read_both(path, **pkw):
    """The whole file through the JAX reader and the port's (``read`` on
    the CPU and ``read_host``), equal, with the same metadata."""
    with jhdf5.open(path) as jr, phdf5.open(path, device="cpu",
                                            **pkw) as pr:
        want = np.asarray(jr.read())
        got = pr.read()
        assert got.device.type == "cpu"
        assert pr.shape == jr.shape and pr.dtype == jr.dtype
        assert pr.samples_per_frame == jr.samples_per_frame
        assert pr.sample_rate.to_value(pu.Hz) == \
            jr.sample_rate.to_value(ju.Hz)
        assert (pr.start_time.jd1, pr.start_time.jd2) == \
            (jr.start_time.jd1, jr.start_time.jd2)
        assert (pr.encoding, pr.bps, pr.valid, pr.invalid_ranges) == \
            (jr.encoding, jr.bps, jr.valid, jr.invalid_ranges)
        pattrs = pr.meta["__attributes__"]
        jattrs = jr.meta["__attributes__"]
        assert sorted(pattrs) == sorted(jattrs)
        for key, value in jattrs.items():
            if key == "frequency":
                np.testing.assert_array_equal(
                    pattrs[key].to_value(pu.MHz), value.to_value(ju.MHz))
            else:
                np.testing.assert_array_equal(np.asarray(pattrs[key]),
                                              np.asarray(value))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pr.read_host(0, pr.shape[0]), want)
    return want


def write(open_fn, path, template, chunks, **kw):
    """Write ``chunks`` (arrays, or (array, valid) pairs) in order."""
    with open_fn(path, "w", template=template, **kw) as fw:
        for chunk in chunks:
            data, valid = chunk if isinstance(chunk, tuple) else (chunk,
                                                                  True)
            if valid:
                fw.write(data)
            else:
                fw.write(data, valid=False)


SHAPES = [((4096, 2), np.complex64), ((4096,), np.float32),
          ((2048, 4, 2), np.complex64)]
#: (writer keywords, shape, dtype): 'c4' is a complex coding only
NATIVE = [(kw, shape, dtype)
          for kw in ({}, {"encoding": "c4"}, {"bps": 8}, {"bps": 4},
                     {"bps": 2})
          for shape, dtype in SHAPES
          if "encoding" not in kw or np.dtype(dtype).kind == "c"]


@pytest.mark.parametrize(
    "kw, shape, dtype", NATIVE,
    ids=["-".join([str(k.get("encoding", k.get("bps", "raw"))),
                   "x".join(map(str, s)), np.dtype(d).name])
         for k, s, d in NATIVE])
def test_native_both_ways(tmp_path, kw, shape, dtype):
    """Each package's writer, each package's reader, the same bytes."""
    data = samples(shape, dtype)
    pt, jt = templates(data)
    jpath, ppath = str(tmp_path / "j.h5"), str(tmp_path / "p.h5")
    write(jhdf5.open, jpath, jt, [data], **kw)
    write(phdf5.open, ppath, pt, [torch.from_numpy(data)], **kw)
    assert datasets(jpath) == datasets(ppath)
    back = [read_both(path) for path in (jpath, ppath)]
    np.testing.assert_array_equal(back[0], back[1])
    assert back[0].shape == data.shape
    corr = np.abs(np.vdot(back[0], data)) / np.sqrt(
        np.vdot(back[0], back[0]).real * np.vdot(data, data).real)
    assert corr > {8: 0.999, 4: 0.98, 2: 0.85}.get(kw.get("bps"), 0.999)


@pytest.mark.parametrize("bps", [None, 8, 2])
def test_invalid_ranges_both_ways(tmp_path, bps):
    """A range written with ``valid=False`` reads as zeros in both
    readers, from either writer."""
    data = samples((3072, 2), np.complex64)
    pt, jt = templates(data)
    kw = {} if bps is None else {"bps": bps}
    chunks = [data[:1024], (data[1024:2048], False), data[2048:]]
    jpath, ppath = str(tmp_path / "j.h5"), str(tmp_path / "p.h5")
    write(jhdf5.open, jpath, jt, chunks, **kw)
    write(phdf5.open, ppath, pt, chunks, **kw)
    assert datasets(jpath) == datasets(ppath)
    for path in (jpath, ppath):
        back = read_both(path)
        assert np.all(back[1024:2048] == 0)
        assert np.any(back[:1024] != 0) and np.any(back[2048:] != 0)
        with phdf5.open(path, device="cpu") as pr:
            assert pr.invalid_ranges == [(1024, 2048)] and not pr.valid


def test_seek_by_time_and_odd_frames(tmp_path):
    """Seeking by time after reopening, and a 2-bit file read with a
    frame size that does not fall on byte boundaries (the reader rounds
    it up, as the JAX reader does)."""
    data = samples((4096, 2), np.complex64)
    pt, jt = templates(data)
    path = str(tmp_path / "t.h5")
    write(phdf5.open, path, pt, [data], bps=2)
    with phdf5.open(path, device="cpu", samples_per_frame=3) as pr, \
            jhdf5.open(path, samples_per_frame=3) as jr:
        assert pr.samples_per_frame == jr.samples_per_frame
        np.testing.assert_array_equal(pr.read().numpy(),
                                      np.asarray(jr.read()))
        t = pr.start_time + pu.Quantity(1000 / RATE, pu.s)
        pr.seek(t)
        jr.seek(JTime(t.jd1, t.jd2))
        assert pr.tell() == jr.tell() == 1000
        np.testing.assert_array_equal(pr.read(100).numpy(),
                                      np.asarray(jr.read(100)))
    path = str(tmp_path / "eof.h5")
    with phdf5.open(path, "w", template=pt) as fw:
        with pytest.raises(EOFError):
            fw.write(np.zeros((5000, 2), np.complex64))


def test_unpaired_attributes_like_jax():
    for hdr in ({"frequency": {"value": [1.4e9, 1.41e9]}},
                {"sideband": [1, -1]}, {}):
        got = phdf5._attrs_from_header(hdr)
        want = jhdf5._attrs_from_header(hdr)
        assert sorted(got) == sorted(want)
        if "sideband" in want:
            np.testing.assert_array_equal(got["sideband"], want["sideband"])


# -- the reference package's layout ------------------------------------------

REF_KW = [({}, 1.0), ({"encoded_dtype": "c4"}, 1.0), ({"bps": 8}, 32.0),
          ({"bps": 4}, 2.5), ({"bps": 2}, 1.0)]


@pytest.mark.parametrize("kw, level", REF_KW,
                         ids=["raw", "c4", "bps8", "bps4", "bps2"])
def test_reference_layout_both_ways(tmp_path, kw, level):
    """``style='reference'`` files from either writer: the same header
    text and payload bytes, read alike by both readers (auto-detected)."""
    data = samples((4000, 2), np.complex64, level)
    pt, jt = templates(data, spf=1000, rate=32_000,
                       start="2018-05-06T00:00:00", freq_mhz=311.25,
                       pol=("L", "R"))
    jpath, ppath = str(tmp_path / "j.h5"), str(tmp_path / "p.h5")
    write(jhdf5.open, jpath, jt, [data], style="reference", **kw)
    write(phdf5.open, ppath, pt, [data], style="reference", **kw)
    assert datasets(jpath) == datasets(ppath)
    for path in (jpath, ppath):
        back = read_both(path)
        assert back.shape == data.shape
        with phdf5.open(path, device="cpu", samples_per_frame=640) as pr:
            pr.seek(1234)
            np.testing.assert_array_equal(pr.read(100).numpy(),
                                          back[1234:1334])
            if "bps" in kw:
                with pytest.raises(ValueError, match="reference-layout"):
                    pr.read_packed(0, 64)


def astropy_style_header():
    """Header text in astropy.io.misc.yaml's tag syntax (as
    tests/test_hdf5_interop.py builds it)."""
    import base64

    def b64(raw):
        return base64.b64encode(base64.b64encode(raw)).decode()
    freq = np.array([311.25, 311.5])
    pol = np.array(["L", "R"])
    return f"""\
frequency: !astropy.units.Quantity
  unit: !astropy.units.Unit {{unit: MHz}}
  value: !numpy.ndarray
    buffer: !!binary |
      {b64(freq.tobytes())}
    dtype: float64
    order: C
    shape: !!python/tuple [2]
polarization: !numpy.ndarray
  buffer: !!binary |
    {b64(pol.tobytes())}
  dtype: {pol.dtype.str}
  order: C
  shape: !!python/tuple [2]
sample_rate: !astropy.units.Quantity
  unit: !astropy.units.Unit {{unit: kHz}}
  value: 32.0
sample_shape: !!python/tuple [2]
samples_per_frame: 1000
sideband: 1
time: !astropy.time.Time
  format: isot
  in_subfmt: '*'
  jd1: 2458000.5
  jd2: 0.25
  out_subfmt: '*'
  precision: 3
  scale: utc
dtype: complex64
encoded_dtype: complex64
"""


def test_astropy_yaml_like_jax(tmp_path):
    """The astropy-tagged header loads to the same values in both
    packages, dumps to the same text, and a hand-built file with it reads
    alike; other time scales are refused by both."""
    text = astropy_style_header()
    got, want = pinterop.load_astropy_yaml(text), \
        jinterop.load_astropy_yaml(text)
    assert sorted(got) == sorted(want)
    assert got["sample_shape"] == want["sample_shape"] == (2,)
    assert got["sample_rate"].to_value(pu.Hz) == \
        want["sample_rate"].to_value(ju.Hz)
    assert (got["time"].jd1, got["time"].jd2) == \
        (want["time"].jd1, want["time"].jd2)
    np.testing.assert_array_equal(got["frequency"].to_value(pu.MHz),
                                  want["frequency"].to_value(ju.MHz))
    assert pinterop.dump_astropy_yaml(got) == \
        jinterop.dump_astropy_yaml(want)
    assert pinterop.is_reference_header(text)
    assert not pinterop.is_reference_header("shape: [4, 2]\n")
    for mod in (pinterop, jinterop):
        with pytest.raises(ValueError, match="scale"):
            mod.load_astropy_yaml(text.replace("scale: utc", "scale: tdb"))
    rng = np.random.default_rng(3)
    payload = (rng.normal(size=(1000, 2))
               + 1j * rng.normal(size=(1000, 2))).astype(np.complex64)
    path = str(tmp_path / "astropy.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("header", data=text)
        f.create_dataset("payload", data=payload)
    np.testing.assert_array_equal(read_both(path), payload)


@pytest.mark.parametrize("text", ["Hz", "MHz", "cycle", "1 / s", "pc / cm3",
                                  "km / s", "min", ""])
def test_unit_grammar_like_jax(text):
    got, want = pinterop.parse_unit(text), jinterop.parse_unit(text)
    assert got.scale == want.scale and tuple(got.powers) == \
        tuple(want.powers)
    try:
        spelled = jinterop.unit_to_string(want)
    except ju.UnitsError:
        with pytest.raises(pu.UnitsError):
            pinterop.unit_to_string(got)
    else:
        assert pinterop.unit_to_string(got) == spelled
    with pytest.raises(pu.UnitsError):
        pinterop.parse_unit("furlong / fortnight")


@pytest.mark.parametrize("name", ["golden_ref_raw", "golden_ref_c4",
                                  "golden_ref_bps4"])
def test_golden_fixtures_bit_for_bit(name):
    """The frozen reference-layout fixtures read as the frozen
    expectations, bit for bit, with their metadata."""
    want = np.load(os.path.join(DATA, "golden_ref_hdf5_expected.npz"))[name]
    with phdf5.open(os.path.join(DATA, name + ".h5"), device="cpu") as pr:
        assert pr.shape == (64, 4, 2)
        got = pr.read(64)
        np.testing.assert_array_equal(got.numpy(), want)
        t0 = PTime("2018-05-06T12:13:14.5")
        assert abs((pr.start_time - t0).sec) < 1e-12
        assert pr.sample_rate == pu.Quantity(250, pu.kHz)
        att = pr.meta["__attributes__"]
        np.testing.assert_allclose(att["frequency"].to_value(pu.MHz).ravel(),
                                   [311.25, 311.5, 311.75, 312.0])
        assert list(np.asarray(att["polarization"])) == ["L", "R"]
        assert int(np.asarray(att["sideband"])) == 1
    read_both(os.path.join(DATA, name + ".h5"))


def test_golden_fixtures_written_again(tmp_path):
    """The port's reference-layout writer reproduces the frozen header
    text and payload bytes from the fixtures' template and data."""
    from baseband_tasks_tpu_torch.io.hdf5.interop import ReferenceHDF5Writer
    rng_data = np.load(os.path.join(DATA, "golden_ref_hdf5_expected.npz"))
    data = rng_data["golden_ref_raw"]
    sh = pb.SetAttribute(
        pb.StreamGenerator(lambda s: data[s.tell():s.tell() + 64],
                           data.shape, PTime("2018-05-06T12:13:14.5"),
                           pu.Quantity(250, pu.kHz), samples_per_frame=64,
                           dtype=np.complex64, device="cpu"),
        frequency=pu.Quantity([[311.25], [311.5], [311.75], [312.0]],
                              pu.MHz),
        sideband=np.int8(1), polarization=np.array(["L", "R"]))
    for name, kw in [("golden_ref_raw", {}),
                     ("golden_ref_c4", dict(encoded_dtype="c4")),
                     ("golden_ref_bps4", dict(bps=4))]:
        new = str(tmp_path / (name + ".h5"))
        with ReferenceHDF5Writer(new, sh, **kw) as fw:
            fw.write(torch.from_numpy(data))
        assert datasets(new) == datasets(os.path.join(DATA, name + ".h5"))


# -- packed reads ------------------------------------------------------------

@pytest.mark.parametrize("bps", [2, 4, 8])
@pytest.mark.parametrize("shape, dtype", [((8192, 4), np.complex64),
                                          ((8192,), np.float32)])
@pytest.mark.parametrize("invalid", [False, True])
def test_read_packed_bit_for_bit(tmp_path, bps, shape, dtype, invalid):
    """``read_packed`` gives the JAX carriers' bits as int32 words (and a
    bool mask where the JAX plane is 0/1), and ``packed_decode_fn``
    decodes them to the host read bit for bit, in whole and in aligned
    pieces."""
    data = samples(shape, dtype, seed=31)
    pt, _ = templates(data, spf=2048, pol=None)
    path = str(tmp_path / "p.h5")
    write(phdf5.open, path, pt,
          [data[:2048], (data[2048:4096], not invalid), data[4096:]],
          bps=bps)
    with phdf5.open(path, device="cpu") as pr, jhdf5.open(path) as jr:
        n = pr.shape[0]
        assert pr.packed_alignment == jr.packed_alignment
        assert n % pr.packed_alignment == 0
        host = pr.read_host(0, n)
        packed = pr.read_packed(0, n)
        jpacked = jr.read_packed(0, n)
        words = packed[0] if invalid else packed
        assert isinstance(packed, tuple) == invalid
        assert words.dtype == np.int32
        np.testing.assert_array_equal(
            words.view(np.uint32), np.asarray(jpacked[0]).view(np.uint32))
        if invalid:
            np.testing.assert_array_equal(packed[1], jpacked[1] > 0)
        decode = pr.packed_decode_fn()
        tensors = tuple(torch.from_numpy(p) for p in packed) if invalid \
            else torch.from_numpy(packed)
        dev = decode(tensors)
        assert dev.dtype == torch.from_numpy(host).dtype
        np.testing.assert_array_equal(dev.numpy(), host)
        step = 2048
        for off in range(0, n, step):
            part = pr.read_packed(off, step)
            part = tuple(torch.from_numpy(p) for p in part) \
                if invalid else torch.from_numpy(part)
            np.testing.assert_array_equal(decode(part).numpy(),
                                          host[off:off + step])
        if invalid:
            assert np.all(host[2048:4096] == 0)


def test_packed_refusals(tmp_path):
    """Unaligned packed reads and packed reads of raw payloads are
    refused, as in the JAX package."""
    data = samples((4096,), np.float32, seed=32)
    pt, _ = templates(data, pol=None)
    path = str(tmp_path / "b2.h5")
    write(phdf5.open, path, pt, [data], bps=2)
    with phdf5.open(path, device="cpu") as pr:
        assert pr.packed_alignment == 16
        with pytest.raises(ValueError, match="aligned"):
            pr.read_packed(8, 16)
    path = str(tmp_path / "raw.h5")
    write(phdf5.open, path, pt, [data])
    with phdf5.open(path, device="cpu") as pr:
        with pytest.raises(ValueError, match="bit-packed"):
            pr.read_packed(0, 512)


def test_compiled_packed_ingest_matches_float_path(tmp_path):
    """A packed compiled chain on an 8-bit file (the words decoded in the
    step) equals the same chain on the host-decoded samples, and the JAX
    package's compiled float path."""
    from baseband_tasks_tpu.models.compiled import CompiledPipeline as JCP
    from baseband_tasks_tpu_torch.models import CompiledPipeline as PCP
    data = samples((16384, 4), np.complex64, seed=5)
    pt, _ = templates(data, spf=4096, pol=None)
    path = str(tmp_path / "c.h5")
    write(phdf5.open, path, pt, [data], bps=8)
    with phdf5.open(path, device="cpu") as pr, jhdf5.open(path) as jr:
        ptail = pb.Square(pb.Channelize(pr, 16))
        jtail = jb.Square(jb.Channelize(jr, 16))
        cp_p = PCP(ptail, block_samples=4096, packed=True)
        cp_f = PCP(ptail, block_samples=4096)
        got = cp_p.run_blocks(cp_p.read_source_blocks(4))
        ref = cp_f.run_blocks(cp_f.read_source_blocks(4))
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        jcp = JCP(jtail, block_samples=4096)
        want = np.asarray(jcp.run_blocks(np.asarray(
            jcp.read_source_blocks(4))))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_open_through_the_registry(tmp_path):
    data = samples((1024, 2), np.complex64)
    pt, _ = templates(data)
    path = str(tmp_path / "r.h5")
    with pb.open(path, "w", format="hdf5", template=pt, bps=4) as fw:
        fw.write(data)
    assert pb.registry.detect_format(path) == "hdf5"
    with pb.open(path, device="cpu") as pr:
        assert type(pr).__name__ == "HDF5StreamReader"
        assert pr.bps == 4 and pr.read(16).shape == (16, 2)
