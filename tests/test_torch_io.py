"""The port's stored-baseband I/O (``io/``, ``registry.py``, ``native/``)
against the JAX package's, on the CPU.

The same numpy samples go through both packages' writers and readers:
files written by either package's writer read back identically in the
other's reader (and the two writers write the same bytes), VDIF at 8, 4
and 2 bits real and complex with missing and invalid frames read as
zeros, Mark 5B at 1 to 8 bits with a dropped frame, DADA at 8, 16 and 32
bits, GUPPI, multi-file sequences, ``open``/``detect_format`` over every
format (the unported ones detected and refused), and the native LUT
decoder with its numpy fallbacks.  Readers and writers are host code, so
samples must agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu import native as jnative  # noqa: E402
from baseband_tasks_tpu import registry as jregistry  # noqa: E402
from baseband_tasks_tpu.io import dada as jdada  # noqa: E402
from baseband_tasks_tpu.io import guppi as jguppi  # noqa: E402
from baseband_tasks_tpu.io import mark5b as jmark5b  # noqa: E402
from baseband_tasks_tpu.io import sequence as jsequence  # noqa: E402
from baseband_tasks_tpu.io import vdif as jvdif  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch import native as pnative  # noqa: E402
from baseband_tasks_tpu_torch import registry as pregistry  # noqa: E402
from baseband_tasks_tpu_torch.io import dada as pdada  # noqa: E402
from baseband_tasks_tpu_torch.io import guppi as pguppi  # noqa: E402
from baseband_tasks_tpu_torch.io import mark5b as pmark5b  # noqa: E402
from baseband_tasks_tpu_torch.io import sequence as psequence  # noqa: E402
from baseband_tasks_tpu_torch.io import vdif as pvdif  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

START = "2018-06-15T07:00:00.000000000"
VDIF_RATE = 1 << 20


def file_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def write_bytes(path, raw):
    with open(path, "wb") as fh:
        fh.write(raw)


def samples(shape, dtype, scale, seed=23):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * scale
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape) * scale
    return x.astype(dtype)


def templates(data, rate_hz, start=START, spf=4096, freq_mhz=None):
    """The numpy samples as a stream of each package (the port's on the
    CPU), optionally labelled with per-channel frequencies (MHz)."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time, **kw):
        gen = pkg.StreamGenerator(frame, data.shape, time(start),
                                  units.Quantity(rate_hz, units.Hz),
                                  samples_per_frame=spf, dtype=data.dtype,
                                  **kw)
        if freq_mhz is None:
            return gen
        return pkg.SetAttribute(gen, frequency=freq_mhz * units.MHz,
                                sideband=1)
    return make(pb, pu, PTime, device="cpu"), make(jb, ju, JTime)


def read_both(jreader, preader):
    """Whole-stream reads of a JAX and a port reader (the port's through
    ``read`` on the CPU and ``read_host``), checked equal, and the
    metadata compared."""
    want = np.asarray(jreader.read())
    got = preader.read()
    assert got.device.type == "cpu"
    assert preader.shape == jreader.shape
    assert preader.dtype == jreader.dtype
    assert preader.sample_rate.to_value(pu.Hz) == \
        jreader.sample_rate.to_value(ju.Hz)
    assert (preader.start_time.jd1, preader.start_time.jd2) == \
        (jreader.start_time.jd1, jreader.start_time.jd2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(preader.read_host(0, preader.shape[0]),
                                  want)
    return want


def cross_check(tmp_path, name, jopen, popen, jwrite_kw, pwrite_kw,
                data, pt, jt, jread_kw, pread_kw, same_bytes=True):
    """Write ``data`` with each package's writer; each file reads the
    same in both readers; the files' bytes agree."""
    jpath, ppath = str(tmp_path / f"j_{name}"), str(tmp_path / f"p_{name}")
    with jopen(jpath, "w", template=jt, **jwrite_kw) as fw:
        fw.write(data)
    with popen(ppath, "w", template=pt, **pwrite_kw) as fw:
        fw.write(torch.from_numpy(data))
    if same_bytes:
        assert file_bytes(jpath) == file_bytes(ppath)
    out = []
    for path in (jpath, ppath):
        with jopen(path, **jread_kw) as jr, \
                popen(path, device="cpu", **pread_kw) as pr:
            out.append(read_both(jr, pr))
    np.testing.assert_array_equal(out[0], out[1])
    return jpath, out[0]


# -- VDIF ---------------------------------------------------------------------

@pytest.mark.parametrize("bps", [8, 4, 2, 16])
@pytest.mark.parametrize("shape,dtype", [
    ((32768, 2), np.complex64), ((16384,), np.float32),
    ((8192, 4, 2), np.complex64), ((16384, 2), np.float32)])
def test_vdif_both_ways(tmp_path, bps, shape, dtype):
    scale = {8: 16, 4: 2, 2: 1, 16: 1000}[bps]
    data = samples(shape, dtype, scale)
    pt, jt = templates(data, VDIF_RATE)
    _, back = cross_check(
        tmp_path, f"{bps}.vdif", jvdif.open, pvdif.open, {"bps": bps},
        {"bps": bps}, data, pt, jt,
        {"sample_rate": ju.Quantity(VDIF_RATE, ju.Hz)},
        {"sample_rate": pu.Quantity(VDIF_RATE, pu.Hz)})
    assert back.shape == data.shape
    # the quantized samples track the input
    corr = np.abs(np.vdot(back, data)) / np.sqrt(
        np.vdot(back, back).real * np.vdot(data, data).real)
    assert corr > 0.85


def _frame_bytes(path):
    with open(path, "rb") as fh:
        w = np.frombuffer(fh.read(32), "<u4")
    return int(w[2] & 0xFFFFFF) * 8


def test_vdif_missing_and_invalid_frames(tmp_path):
    """A frame cut out of the file and a frame flagged invalid read as
    zeros in both packages; the other frames are untouched."""
    data = samples((16384, 2), np.complex64, 16)
    pt, jt = templates(data, VDIF_RATE)
    path = str(tmp_path / "full.vdif")
    with pvdif.open(path, "w", template=pt, bps=8, samples_per_frame=1024,
                    nthread=2) as fw:
        fw.write(data)
    raw = bytearray(file_bytes(path))
    fb = _frame_bytes(path)
    # file frames are (time, thread) interleaved: frame 2k + t
    bad = bytearray(raw[:3 * fb]) + raw[4 * fb:]        # (1, 1) cut out
    w0 = np.frombuffer(bytes(bad[8 * fb:8 * fb + 4]), "<u4")[0]
    bad[8 * fb:8 * fb + 4] = np.uint32(w0 | (1 << 31)).tobytes()
    cut = str(tmp_path / "cut.vdif")
    write_bytes(cut, bytes(bad))
    with jvdif.open(cut, sample_rate=ju.Quantity(VDIF_RATE, ju.Hz)) as jr, \
            pvdif.open(cut, sample_rate=pu.Quantity(VDIF_RATE, pu.Hz),
                       device="cpu") as pr:
        back = read_both(jr, pr)
    with pvdif.open(path, sample_rate=pu.Quantity(VDIF_RATE, pu.Hz),
                    device="cpu") as pr:
        full = pr.read().numpy()
    zero = np.zeros(back.shape, bool)
    zero[1024:2048, 1] = True            # the frame cut out
    # file frame 8 after the cut (9 before it): time 4, thread 1
    zero[4 * 1024:5 * 1024, 1] = True
    assert np.all(back[zero] == 0)
    np.testing.assert_array_equal(back[~zero], full[~zero])


def test_vdif_rate_from_headers_and_seek(tmp_path):
    """A file crossing a second boundary gives the rate from its frame
    numbers; seeks by time land on the same sample in both packages."""
    rate = 8192
    data = samples((3 * rate, 2), np.complex64, 16)
    pt, jt = templates(data, rate, spf=1024)
    path = str(tmp_path / "slow.vdif")
    with jvdif.open(path, "w", template=jt, bps=4) as fw:
        fw.write(data)
    with jvdif.open(path) as jr, pvdif.open(path, device="cpu") as pr:
        assert pr.sample_rate.to_value(pu.Hz) == rate
        assert jr.sample_rate.to_value(ju.Hz) == rate
        jr.seek(JTime("2018-06-15T07:00:01.5"))
        pr.seek(PTime("2018-06-15T07:00:01.5"))
        assert pr.tell() == jr.tell() == rate + rate // 2
        np.testing.assert_array_equal(pr.read(100).numpy(),
                                      np.asarray(jr.read(100)))


# -- Mark 5B ------------------------------------------------------------------

@pytest.mark.parametrize("bps", [1, 2, 4, 8])
def test_mark5b_dropped_frame(tmp_path, bps):
    """Both writers write the same frames; a frame dropped from the file
    reads as zeros in both readers."""
    nchan, rate = 4, 10_000_000
    data = samples((40000, nchan), np.float32,
                   {8: 16, 4: 2, 2: 1, 1: 1}[bps], seed=7)
    pt, jt = templates(data, rate, start="2018-06-15T07:00:00.0",
                       spf=10000)
    kw_j = {"nchan": nchan, "bps": bps, "sample_rate":
            ju.Quantity(rate, ju.Hz), "ref_time": JTime(START)}
    kw_p = {"nchan": nchan, "bps": bps, "sample_rate":
            pu.Quantity(rate, pu.Hz), "ref_time": PTime(START)}
    path, back = cross_check(tmp_path, f"{bps}.m5b", jmark5b.open,
                             pmark5b.open, {"bps": bps}, {"bps": bps}, data,
                             pt, jt, kw_j, kw_p)
    raw = file_bytes(path)
    fb = pmark5b.FRAME_BYTES
    cut = str(tmp_path / "cut.m5b")
    write_bytes(cut, raw[:fb] + raw[2 * fb:])
    with jmark5b.open(cut, **kw_j) as jr, \
            pmark5b.open(cut, device="cpu", **kw_p) as pr:
        got = read_both(jr, pr)
    spf = 80000 // (bps * nchan)
    assert np.all(got[spf:2 * spf] == 0)
    np.testing.assert_array_equal(got[:spf], back[:spf])
    np.testing.assert_array_equal(got[2 * spf:], back[2 * spf:])


def test_mark5b_crc_and_bcd_match():
    rng = np.random.default_rng(0)
    for bits in rng.integers(0, 1 << 48, 20, dtype=np.int64):
        assert pmark5b.crc16_vlba(int(bits)) == jmark5b.crc16_vlba(int(bits))
    for v in (0, 7, 123, 99999):
        enc = pmark5b._bcd_encode(v, 5)
        assert enc == jmark5b._bcd_encode(v, 5)
        assert pmark5b._bcd_decode(enc, 5) == v
    words = np.array([0x12345, 0x99999, 0], np.uint32)
    np.testing.assert_array_equal(pmark5b._bcd_decode_vec(words, 5),
                                  jmark5b._bcd_decode_vec(words, 5))


# -- DADA and GUPPI -----------------------------------------------------------

@pytest.mark.parametrize("nbit", [8, 16, 32])
@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_dada_both_ways(tmp_path, nbit, dtype):
    data = samples((4000, 2, 4), dtype, 10.0 if nbit != 32 else 1.0,
                   seed=9)
    pt, jt = templates(data, 100_000, start="2020-01-01T12:34:56.25",
                       spf=1000,
                       freq_mhz=np.broadcast_to(1400 + np.arange(4.0),
                                                (2, 4)))
    path, _ = cross_check(tmp_path, f"{nbit}.dada", jdada.open, pdada.open,
                          {"nbit": nbit}, {"nbit": nbit}, data, pt, jt, {},
                          {}, same_bytes=False)
    with jdada.open(path) as jr, pdada.open(path, device="cpu") as pr:
        assert pr.header == jr.header
        np.testing.assert_array_equal(pr.frequency.to_value(pu.MHz),
                                      jr.frequency.to_value(ju.MHz))
        np.testing.assert_array_equal(pr.sideband, jr.sideband)


@pytest.mark.parametrize("npol", [1, 2])
def test_guppi_both_ways(tmp_path, npol):
    shape = (8192, 4, npol) if npol > 1 else (8192, 4)
    data = samples(shape, np.complex64, 1.0, seed=5)
    freq = 1500 + np.arange(4.0) * 3
    pt, jt = templates(data, 3_000_000, start="2021-06-01T10:00:00.0",
                       spf=2048,
                       freq_mhz=freq[:, None] * np.ones((1, npol))
                       if npol > 1 else freq)
    kw = {"samples_per_block": 2048}
    path, back = cross_check(tmp_path, f"{npol}.raw", jguppi.open,
                             pguppi.open, kw, kw, data, pt, jt, {}, {})
    with jguppi.open(path) as jr, pguppi.open(path, device="cpu") as pr:
        assert pr.header0 == jr.header0
        np.testing.assert_array_equal(pr.frequency.to_value(pu.MHz),
                                      jr.frequency.to_value(ju.MHz))
    def quantized(x):
        return np.clip(np.round(x * 32), -128, 127)
    np.testing.assert_array_equal(
        back, quantized(data.real) + 1j * quantized(data.imag))


# -- sequences, open and detect_format ----------------------------------------

def test_sequence_both_ways(tmp_path):
    """A stream split into DADA files by each package's sequence writer
    reads back as one stream, spliced, in both packages, through a list,
    a {file_nr} template and a glob."""
    data = samples((10000, 2), np.complex64, 10.0, seed=7)
    pt, jt = templates(data, 100_000, start="2020-01-01T00:00:00.0",
                       spf=1000)
    for tag, mod, t, wrap in (("j", jsequence, jt, np.asarray),
                              ("p", psequence, pt, torch.from_numpy)):
        names = [str(tmp_path / f"{tag}_{i:04d}.dada") for i in range(3)]
        with mod.open(names, "w", template=t, samples_per_file=4096,
                      format="dada", nbit=8) as wh:
            wh.write(wrap(data[:3000]))
            wh.write(wrap(data[3000:]))
        template = str(tmp_path / f"{tag}_{{file_nr:04d}}.dada")
        glob = str(tmp_path / f"{tag}_*.dada")
        for name in (names, template, glob):
            with jregistry.open(name) as jr, \
                    pregistry.open(name, device="cpu") as pr:
                assert pr.files == jr.files == names
                assert pr.shape == jr.shape == data.shape
                back = read_both(jr, pr)
            np.testing.assert_array_equal(back, np.round(data * 1) / 1)
        with pregistry.open(names, device="cpu") as pr:
            pr.seek(4000)           # across the first file boundary
            np.testing.assert_array_equal(pr.read(200).numpy(),
                                          back[4000:4200])


def _unported_files(tmp_path):
    """A file of each format the port detects but does not open yet."""
    files = {}
    data = np.abs(samples((4096, 2), np.float32, 1.0))
    _, jt = templates(data, 1_000_000, spf=1024,
                      freq_mhz=np.array([1400.0, 1401.0]))
    files["hdf5"] = str(tmp_path / "x.h5")
    with jb.io.hdf5.open(files["hdf5"], "w", template=jt) as fw:
        fw.write(data)
    files["psrfits"] = str(tmp_path / "x.data")
    write_bytes(files["psrfits"], b"SIMPLE  =" + b" " * 71)
    return files


def test_open_and_detect_format(tmp_path):
    """detect_format names every file as the JAX package does; ``open``
    opens the ported formats as the JAX package does and refuses the
    others (ROADMAP)."""
    data = samples((8192, 2), np.complex64, 10.0)
    pt, jt = templates(data, VDIF_RATE, spf=2048)
    paths = {}
    for fmt, ext, kw in (("vdif", ".vdif", {"bps": 8}),
                         ("dada", ".dada", {"nbit": 8}),
                         ("guppi", ".raw", {"samples_per_block": 2048})):
        paths[fmt] = str(tmp_path / f"x{ext}")
        with pregistry.open(paths[fmt], "w", format=fmt, template=pt,
                            **kw) as fw:
            fw.write(data)
    real = samples((40000, 4), np.float32, 1.0)
    rt, _ = templates(real, 10_000_000, spf=10000)
    paths["mark5b"] = str(tmp_path / "x.m5b")
    with pregistry.open(paths["mark5b"], "w", format="mark5b",
                        template=rt) as fw:
        fw.write(real)
    power = np.abs(samples((4096, 2), np.float32, 1.0))
    st, _ = templates(power, 1_000_000, spf=1024,
                      freq_mhz=np.array([1400.0, 1401.0]))
    paths["sigproc"] = str(tmp_path / "x.fil")
    with pregistry.open(paths["sigproc"], "w", format="sigproc",
                        template=st) as fw:
        fw.write(power)
    unported = _unported_files(tmp_path)
    for fmt, path in {**paths, **unported}.items():
        assert pregistry.detect_format(path) == \
            jregistry.detect_format(path) == fmt
    for fmt, path in unported.items():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pb.open(path)
    kw = {"vdif": {"sample_rate": pu.Quantity(VDIF_RATE, pu.Hz)},
          "mark5b": {"nchan": 4, "ref_time": PTime(START),
                     "sample_rate": pu.Quantity(10_000_000, pu.Hz)}}
    jkw = {"vdif": {"sample_rate": ju.Quantity(VDIF_RATE, ju.Hz)},
           "mark5b": {"nchan": 4, "ref_time": JTime(START),
                      "sample_rate": ju.Quantity(10_000_000, ju.Hz)}}
    for fmt, path in paths.items():
        with jb.open(path, **jkw.get(fmt, {})) as jr, \
                pb.open(path, device="cpu", **kw.get(fmt, {})) as pr:
            assert type(pr).__name__ == type(jr).__name__
            read_both(jr, pr)
    with pytest.raises(ValueError, match="explicit format"):
        pb.open(str(tmp_path / "y.vdif"), "w", template=pt)
    with pytest.raises(ValueError, match="unknown format"):
        pb.open(paths["vdif"], format="nope")
    odd = str(tmp_path / "x.bin")
    write_bytes(odd, b"\0" * 64)
    for reg in (jregistry, pregistry):
        with pytest.raises(ValueError, match="could not detect"):
            reg.detect_format(odd)


def test_readers_default_to_the_card_when_there_is_one(tmp_path):
    data = samples((8192, 2), np.complex64, 10.0)
    pt, _ = templates(data, VDIF_RATE, spf=2048)
    path = str(tmp_path / "d.vdif")
    with pvdif.open(path, "w", template=pt) as fw:
        fw.write(data)
    with pb.open(path, sample_rate=pu.Quantity(VDIF_RATE, pu.Hz)) as pr:
        want = "cuda" if torch.cuda.is_available() else "cpu"
        assert pr.device.type == want
        assert pr.read(16).device.type == want


# -- the native decoder -------------------------------------------------------

@pytest.mark.parametrize("fallback", [False, True])
def test_native_matches_jax(monkeypatch, fallback):
    """unpack_{2,4,8}bit and pack_2bit equal the JAX package's, with the
    C library and with the numpy fallbacks."""
    if fallback:
        monkeypatch.setattr(pnative, "_lib", None)
        monkeypatch.setattr(pnative, "_tried", True)
    else:
        assert pnative.available()
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, 4099, dtype=np.uint8)
    levels = np.array([-3.3359, -1.0, 1.0, 3.3359], np.float32)
    for got, want in (
            (pnative.unpack_2bit(raw, levels),
             jnative.unpack_2bit(raw, levels)),
            (pnative.unpack_4bit(raw), jnative.unpack_4bit(raw)),
            (pnative.unpack_4bit(raw, 8.0), jnative.unpack_4bit(raw, 8.0)),
            (pnative.unpack_8bit(raw), jnative.unpack_8bit(raw)),
            (pnative.unpack_8bit(raw, 128.0),
             jnative.unpack_8bit(raw, 128.0))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    values = rng.standard_normal(4099).astype(np.float32) * 2
    thresholds = np.array([-2.0, 0.0, 2.0], np.float32)
    np.testing.assert_array_equal(pnative.pack_2bit(values, thresholds),
                                  jnative.pack_2bit(values, thresholds))
    # a round trip through the 2-bit codes
    codes = pnative.pack_2bit(values, thresholds)
    back = pnative.unpack_2bit(codes, levels)[:values.size]
    assert np.all(np.sign(back) == np.where(values >= 0, 1, -1))


def test_native_builds_outside_the_package():
    """The library is built into the git-ignored build/native/, never
    beside the source."""
    assert pnative.available()
    path = pnative._library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    src_dir = pnative._SRC.parent
    assert not list(src_dir.glob("*.so"))
