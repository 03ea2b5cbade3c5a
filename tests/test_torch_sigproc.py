"""The port's SIGPROC filterbank reader and writer (``io/sigproc.py``)
against the JAX package.

Both packages get the same seeded filterbank stream (real noise ->
Channelize -> Square, 16 monotonic channels, the JAX package's
``tests/test_sigproc.py`` geometry) through ``StreamGenerator``.  The
port's writer writes the same bytes as the JAX writer (32-, 8- and
16-bit, with keyword overrides; the files compared byte for byte), its
reader reads every file the same as the JAX reader (header, shape, start
time, rate, frequencies, samples bit for bit, also read back on the
host), ``open`` detects and opens SIGPROC files, a seek by time lands on
the same sample, the writer validates before creating its file, and a
file feeds the DM search as in the JAX package's survey loop (the search
maps within 1e-5 of the peak).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu import models as jmodels  # noqa: E402
from baseband_tasks_tpu.io import sigproc as jsig  # noqa: E402
from baseband_tasks_tpu.registry import (  # noqa: E402
    detect_format as jdetect)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch import models as pmodels  # noqa: E402
from baseband_tasks_tpu_torch.io import sigproc as psig  # noqa: E402
from baseband_tasks_tpu_torch.registry import (  # noqa: E402
    detect_format as pdetect)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

START = "2021-03-04T05:06:07.000000000"
N, NCHAN = 1 << 10, 16
NFFT = 2 * (NCHAN - 1)


def power_data(seed=3):
    """The filterbank both packages write: |rfft|^2 of seeded noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, NFFT))
    return (np.abs(np.fft.rfft(x, axis=1)) ** 2).astype(np.float32)


def template(pkg, units, time, data):
    """A detected stream labelled as the JAX test's real channelizer
    labels it (400 MHz + k x 10 kHz, sideband +1)."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    gen = pkg.StreamGenerator(frame, data.shape, time(START),
                              10 * units.kHz, samples_per_frame=256,
                              dtype=np.float32, **kw)
    return pkg.SetAttribute(
        gen, frequency=(400 + 0.01 * np.arange(NCHAN)) * units.MHz,
        sideband=1)


def write_both(tmp_path, name, data, **kw):
    paths = []
    for mod, pkg, units, time in ((psig, pb, pu, PTime),
                                  (jsig, jb, ju, JTime)):
        path = str(tmp_path / f"{mod.__name__.split('_')[-1]}_{name}")
        with mod.open(path, "w", template=template(pkg, units, time, data),
                      **kw) as fw:
            fw.write(torch.from_numpy(data) if mod is psig else data)
        paths.append(path)
    return paths


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("nbits, kw", [
    (32, {"source_name": "FAKE"}),
    (8, {"scale": 1.0, "offset": 3.0, "telescope_id": 6}),
    (16, {"scale": 100.0, "machine_id": 10, "src_raj": 123456.7})])
def test_writer_bytes_and_reader_match_jax(tmp_path, nbits, kw):
    data = power_data()
    ppath, jpath = write_both(tmp_path, f"x{nbits}.fil", data, nbits=nbits,
                              **kw)
    same_bytes(ppath, jpath)
    with psig.open(ppath, device="cpu") as pr, jsig.open(jpath) as jr:
        assert pr.header == jr.header
        assert pr.shape == jr.shape and pr.dtype == jr.dtype
        assert pr.sample_rate.to_value(pu.Hz) == \
            jr.sample_rate.to_value(ju.Hz)
        assert (pr.start_time.jd1, pr.start_time.jd2) == \
            (jr.start_time.jd1, jr.start_time.jd2)
        np.testing.assert_array_equal(pr.frequency.to_value(pu.MHz),
                                      jr.frequency.to_value(ju.MHz))
        assert pr.sideband == jr.sideband
        got = pr.read()
        assert got.device.type == "cpu" and got.dtype == torch.float32
        want = np.asarray(jr.read())
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pr.read_host(0, pr.shape[0]), want)
    if nbits == 32:
        np.testing.assert_array_equal(want, data)


def test_registry_open_and_seek(tmp_path):
    data = power_data(4)
    ppath, _ = write_both(tmp_path, "auto.fil", data)
    assert pdetect(ppath) == jdetect(ppath) == "sigproc"
    with pb.open(ppath, device="cpu") as rh, jb.open(ppath) as jh:
        assert type(rh).__name__ == type(jh).__name__
        rh.seek(PTime(START) + 100 / rh.sample_rate)
        jh.seek(JTime(START) + 100 / jh.sample_rate)
        assert rh.tell() == jh.tell() == 100
        np.testing.assert_array_equal(rh.read(5).numpy(),
                                      np.asarray(jh.read(5)))
    with pb.open(str(tmp_path / "w.fil"), "w", format="sigproc",
                 template=template(pb, pu, PTime, data)) as fw:
        fw.write(data)
    same_bytes(str(tmp_path / "w.fil"), ppath)


def test_writer_validates_before_creating_file(tmp_path):
    data = power_data()
    for mod, pkg, units, time in ((psig, pb, pu, PTime),
                                  (jsig, jb, ju, JTime)):
        tmpl = template(pkg, units, time, data)
        bad = str(tmp_path / f"bad_{pkg.__name__}.fil")
        with pytest.raises(ValueError, match="unknown sigproc"):
            mod.open(bad, "w", template=tmpl, bogus_key=3)
        with pytest.raises(ValueError, match="1-127"):
            mod.open(bad, "w", template=tmpl, source_name="J" + "x" * 130)
        with pytest.raises(ValueError, match="nbits"):
            mod.open(bad, "w", template=tmpl, nbits=2)
        assert not os.path.exists(bad)
        cplx = pkg.SetAttribute(pkg.NoiseGenerator(
            shape=(256, 4), start_time=time(START),
            sample_rate=1 * units.kHz, samples_per_frame=256, seed=1,
            **({"device": "cpu"} if pkg is pb else {})),
            frequency=(100 + np.arange(4)) * units.MHz, sideband=1)
        with pytest.raises(ValueError, match="detected"):
            mod.open(bad, "w", template=cplx)


def test_feeds_dm_search(tmp_path):
    """The survey loop: a filterbank file -> DMTrialSearch, in both
    packages on the same file."""
    data = power_data(5)
    ppath, _ = write_both(tmp_path, "survey.fil", data)
    with psig.open(ppath, device="cpu") as rh, jsig.open(ppath) as jh:
        ps = pmodels.DMTrialSearch(
            pu.Quantity(rh.frequency.to_value(pu.MHz), pu.MHz),
            rh.sample_rate, [0.0, 5.0], N, device="cpu")
        js = jmodels.DMTrialSearch(
            ju.Quantity(np.asarray(jh.frequency.to_value(ju.MHz)), ju.MHz),
            jh.sample_rate, [0.0, 5.0], N)
        got = ps.search(rh.read(N))
        want = np.asarray(js.search(np.asarray(jh.read(N))))
    assert tuple(got.shape) == (N, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
