"""The port's PSRFITS I/O (``io/psrfits``) against the JAX package's, on
the CPU.

The same numpy profiles and filterbank samples go through both
packages' writers and readers: the two writers write the same bytes, and
a file from either reads back identically in both readers, in fold mode
(16-bit profiles with per-row scales, weights, subint centring of the
start time, the required cards) and in search mode (1, 2, 4 and 8 bits,
one and two polarizations, seeking by time), plus the FITS layer's header
and file round trips.  The PUPPI files of ``tests/test_golden_data.py``
are not in the repository, so round trips stand in for them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.io import psrfits as jpsrfits  # noqa: E402
from baseband_tasks_tpu.io.psrfits import fitsio as jfitsio  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.io import psrfits as ppsrfits  # noqa: E402
from baseband_tasks_tpu_torch.io.psrfits import fitsio as pfitsio  # noqa: E402,E501
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

START = "2019-03-01T10:30:00.000000000"


def file_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def templates(data, rate_hz, spf, freq_mhz, pol=None):
    """``data`` as a stream of each package (the port's on the CPU) with
    per-channel frequencies (MHz, shaped to broadcast)."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time, **kw):
        gen = pkg.StreamGenerator(frame, data.shape, time(START),
                                  units.Quantity(rate_hz, units.Hz),
                                  samples_per_frame=spf, dtype=data.dtype,
                                  **kw)
        attrs = dict(frequency=units.Quantity(freq_mhz, units.MHz),
                     sideband=1)
        if pol is not None:
            attrs["polarization"] = list(pol)
        return pkg.SetAttribute(gen, **attrs)
    return make(pb, pu, PTime, device="cpu"), make(jb, ju, JTime)


def read_both(path, reader_type, **kw):
    """The whole file through both packages' ``open`` (mode detected),
    equal, with the same metadata; the port's ``read`` on the CPU and
    ``read_host``."""
    with jpsrfits.open(path, **kw) as jr, \
            ppsrfits.open(path, device="cpu", **kw) as pr:
        assert type(pr).__name__ == type(jr).__name__ == reader_type
        want = np.asarray(jr.read())
        got = pr.read()
        assert got.device.type == "cpu"
        assert pr.shape == jr.shape and pr.dtype == jr.dtype
        assert pr.samples_per_frame == jr.samples_per_frame
        assert pr.sample_rate.to_value(pu.Hz) == \
            jr.sample_rate.to_value(ju.Hz)
        assert (pr.start_time.jd1, pr.start_time.jd2) == \
            (jr.start_time.jd1, jr.start_time.jd2)
        np.testing.assert_array_equal(pr.frequency.to_value(pu.MHz),
                                      jr.frequency.to_value(ju.MHz))
        np.testing.assert_array_equal(np.asarray(pr.sideband),
                                      np.asarray(jr.sideband))
        if reader_type == "PSRFITSReader":
            assert (pr.source, pr.telescope) == (jr.source, jr.telescope)
            assert (pr.polarization is None) == (jr.polarization is None)
            if jr.polarization is not None:
                assert list(pr.polarization) == list(jr.polarization)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pr.read_host(0, pr.shape[0]), want)
    return want


def cross_write(tmp_path, data, pt, jt, **kw):
    """Both writers on the same data (the port's given a tensor): the
    same bytes.  Returns the JAX file's path."""
    jpath, ppath = str(tmp_path / "j.fits"), str(tmp_path / "p.fits")
    with jpsrfits.open(jpath, "w", template=jt, **kw) as fw:
        fw.write(data)
    with ppsrfits.open(ppath, "w", template=pt, **kw) as fw:
        fw.write(torch.from_numpy(data))
    assert file_bytes(jpath) == file_bytes(ppath)
    return jpath, ppath


def test_header_and_file_round_trips(tmp_path):
    """The FITS layer: a header's bytes and a file's HDUs as the JAX
    package's."""
    headers = []
    for mod in (pfitsio, jfitsio):
        h = mod.Header()
        h.set("SIMPLE", True)
        h.set("BITPIX", 8)
        h.set("NAXIS", 0)
        h.set("OBSFREQ", 1400.123456, "MHz")
        h.set("SRC_NAME", "B1937+21")
        headers.append(h.to_bytes())
    assert headers[0] == headers[1] and len(headers[0]) % 2880 == 0
    h2 = pfitsio.Header.from_bytes(headers[0])
    assert h2["SIMPLE"] is True
    assert h2["OBSFREQ"] == pytest.approx(1400.123456)
    assert h2["SRC_NAME"].strip() == "B1937+21"
    paths = []
    for mod, name in ((pfitsio, "p.fits"), (jfitsio, "j.fits")):
        h = mod.Header()
        h.set("TESTKEY", 42)
        paths.append(str(tmp_path / name))
        mod.write_fits(paths[-1], [mod.HDU(h, None)])
    assert file_bytes(paths[0]) == file_bytes(paths[1])
    hdus = pfitsio.read_fits(paths[1])
    assert hdus[0].header["TESTKEY"] == 42 and hdus[0].header["SIMPLE"]


def folded(nt, nbin, nchan, npol):
    """A Gaussian pulse per channel and polarization, rising by row."""
    phase = np.arange(nbin) / nbin
    prof = np.exp(-0.5 * ((phase - 0.3) / 0.05) ** 2)
    data = (prof[None, :, None, None]
            * (1 + 0.1 * np.arange(nchan))[None, None, :, None]
            * (1 + np.arange(npol))[None, None, None, :]
            + np.arange(nt)[:, None, None, None])
    return data.astype(np.float32)


@pytest.mark.parametrize("nt, nbin, nchan, npol", [
    (8, 64, 4, 2), (3, 32, 1, 1), (4, 16, 8, 4)])
def test_fold_mode_both_ways(tmp_path, nt, nbin, nchan, npol):
    data = folded(nt, nbin, nchan, npol)
    freq = (1400.0 + 1.5625 * np.arange(nchan)).reshape(nchan, 1)
    pol = {1: None, 2: ["AA", "BB"], 4: None}[npol]
    pt, jt = templates(data, 0.1, 1, freq, pol)
    jpath, ppath = cross_write(tmp_path, data, pt, jt, source="FAKEPSR",
                               telescope="FAKE", dm=12.5)
    for path in (jpath, ppath):
        back = read_both(path, "PSRFITSReader")
        np.testing.assert_allclose(back, data,
                                   atol=2e-4 * np.ptp(data) + 1e-5)
        with ppsrfits.open(path, device="cpu") as pr:
            # OFFS_SUB centring gives back the start time
            assert abs((pr.start_time - PTime(START)).sec) < 1e-6
            assert (pr.source, pr.telescope) == ("FAKEPSR", "FAKE")
            if pol:
                assert list(pr.polarization) == pol


def test_fold_weights_and_required_cards(tmp_path):
    """A file whose DAT_WTS zero one channel: both readers weight it
    alike (and alike unweighted); the written file carries the PSRFITS
    definition's required cards, as the JAX test audits them."""
    data = np.stack([np.full((16, 4, 2), float(i + 1), np.float32)
                     for i in range(3)])
    freq = (1400 + np.arange(4)[:, None] * 1.5)
    pt, jt = templates(data, 0.5, 1, freq)
    jpath, _ = cross_write(tmp_path, data, pt, jt, source="J0000+0000",
                           telescope="GBT", dm=13.3)
    hdus = pfitsio.read_fits(jpath)
    primary, subint = hdus[0].header, hdus[1].header
    for key in ("HDRVER", "FITSTYPE", "OBS_MODE", "TELESCOP", "OBSFREQ",
                "OBSBW", "OBSNCHAN", "STT_IMJD", "STT_SMJD", "STT_OFFS"):
        assert key in primary
    for key in ("EPOCHS", "INT_TYPE", "INT_UNIT", "SCALE", "POL_TYPE",
                "NPOL", "TBIN", "NBIN", "NBIN_PRD", "PHS_OFFS", "NBITS",
                "ZERO_OFF", "SIGNINT", "NSUBOFFS", "NCHAN", "CHAN_BW", "DM",
                "RM", "NCHNOFFS", "NSBLK", "NSTOT"):
        assert key in subint
    assert subint["DM"] == 13.3 and subint["NSTOT"] == 3
    rows = hdus[1].data.copy()
    rows["DAT_WTS"][:, 2] = 0.0
    weighted = str(tmp_path / "w.fits")
    pfitsio.write_fits(weighted, [hdus[0], pfitsio.HDU(hdus[1].header,
                                                       rows)])
    for flag in (True, False):
        back = read_both(weighted, "PSRFITSReader", weighted=flag)
        np.testing.assert_allclose(back[:, :, 2], 0.0 if flag else
                                   data[:, :, 2], rtol=1e-3)
        np.testing.assert_allclose(back[:, :, :2], data[:, :, :2],
                                   rtol=1e-3)


def intensity(n, nchan, npol):
    i = np.arange(n, dtype=np.float32)[:, None, None]
    base = 10.0 + np.sin(2 * np.pi * i / 700.0)
    x = np.broadcast_to(base, (n, nchan, npol)) \
        + 0.1 * np.arange(nchan)[None, :, None]
    x = x.astype(np.float32)
    return x[..., 0].copy() if npol == 1 else x


@pytest.mark.parametrize("nbits, tol", [(8, 1 / 200), (4, 1 / 14),
                                        (2, 1 / 2.8), (1, 1.1)])
@pytest.mark.parametrize("npol", [1, 2])
def test_search_mode_both_ways(tmp_path, nbits, tol, npol):
    n, nchan = 8192, 8
    data = intensity(n, nchan, npol)
    freq = (1400.0 + np.arange(nchan)).reshape((nchan,) + (1,) * (npol > 1))
    pt, jt = templates(data, 1000.0, 4096, freq)
    jpath, ppath = cross_write(tmp_path, data, pt, jt, obs_mode="search",
                               nsblk=2048, nbits=nbits, source="SRC")
    for path in (jpath, ppath):
        back = read_both(path, "SearchReader")
        assert back.shape == data.shape
        np.testing.assert_allclose(back, data,
                                   atol=np.ptp(data) * tol + 1e-3)
        with ppsrfits.open(path, device="cpu") as pr:
            assert abs((pr.start_time - PTime(START)).sec) < 1e-6
            pr.seek(PTime(START) + 2 * pu.s)
            assert pr.tell() == 2000
            np.testing.assert_array_equal(pr.read(16).numpy(),
                                          back[2000:2016])
        assert ppsrfits.get_readers(path, device="cpu")[0].shape == \
            data.shape


def test_writers_and_registry(tmp_path):
    """``get_writer`` dispatches on the observation mode, ``open`` detects
    the format and the mode, and the writers refuse what the JAX writers
    refuse."""
    data = intensity(4096, 4, 1)
    pt, _ = templates(data, 100.0, 2048, 800.0 + np.arange(4))
    path = str(tmp_path / "s.fits")
    w = ppsrfits.get_writer(path, pt, obs_mode="search", nsblk=1024)
    assert type(w).__name__ == "SearchWriter"
    with w:
        w.write(data)
    assert pb.registry.detect_format(path) == "psrfits"
    with pb.open(path, device="cpu") as pr:
        assert type(pr).__name__ == "SearchReader"
        assert pr.shape == (4096, 4)
    with pytest.raises(ValueError, match="nbits"):
        ppsrfits.SearchWriter(path, pt, nbits=3)
    with pytest.raises(ValueError, match="whole bytes"):
        ppsrfits.SearchWriter(path, pt, nsblk=1, nbits=1)
    assert ppsrfits._timesys_scale({"TIMESYS": "TAI"}) == "tai"
    with pytest.warns(UserWarning, match="TIMESYS"):
        assert ppsrfits._timesys_scale({"TIMESYS": "TDB"}) == "utc"
