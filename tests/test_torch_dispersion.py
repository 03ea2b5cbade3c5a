"""The port's coherent (de)dispersion against the JAX package.

Both packages get the same numpy baseband through ``StreamGenerator``
and run the same chains at small size (windows of 2^12 samples over 8
and 16 lanes): ``Dedisperse(engine='pallas') -> Dechannelize`` (the
spectral filter's kernels: plain versions here, Pallas interpret mode
on the JAX side), ``Dedisperse(engine='xla')`` under
``fft_maker.set('pallas')`` (the four-step FFT engine) and on the
default engine.  Geometry (pads, windows, frame sizes, start times,
engines) and the host chirps must be identical; signal outputs agree to
float32 FFT roundoff and are held to 1e-5 of their largest element
(PLANE_TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.fourier import fft_maker as jmaker  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.fourier import fft_maker as pmaker  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PLANE_TOL = 1e-5

# name -> (sample_shape, channel rate MHz, centre MHz, DM, pad_margin,
# n samples): 8 channels, and 8 channels x 2 pols (16 lanes)
CONFIGS = {"8ch": ((8,), 1.0, 300.0, 0.05, 32, 20000),
           "8x2": ((8, 2), 0.25, 400.0, 0.5, 32, 16384)}
ENGINES = ["xla", "pallas", "xla_under_pallas"]


def assert_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_TOL * peak)


def sources(name, n=None, dtype=np.complex64):
    """The config's numpy baseband as a labelled source of each package."""
    shape, rate, f0, _, _, n_default = CONFIGS[name]
    n = n_default if n is None else n
    rng = np.random.default_rng(sum(map(ord, name)))
    data = rng.standard_normal((n,) + shape)
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.standard_normal((n,) + shape)
    data = data.astype(dtype)
    freq = f0 + (np.arange(shape[0]) - shape[0] / 2) * rate
    freq = freq.reshape((-1,) + (1,) * (len(shape) - 1))

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time):
        gen = pkg.StreamGenerator(frame, data.shape, time.from_mjd(58000.0),
                                  rate * units.MHz, samples_per_frame=2048,
                                  dtype=data.dtype)
        return pkg.SetAttribute(gen, frequency=freq * units.MHz, sideband=1)
    return make(pb, pu, PTime), make(jb, ju, JTime)


def dedispersers(name, engine, src=None, **kw):
    """(port, jax) Dedisperse of the config on ``engine``;
    'xla_under_pallas' is the 'xla' engine built under the 'pallas' FFT
    engine with a power-of-two window."""
    _, _, _, dm, margin, _ = CONFIGS[name]
    ps, js = sources(name) if src is None else src
    kw = dict(pad_margin=margin, **kw)
    if engine == "pallas":
        kw.setdefault("samples_per_frame", 2048)
    if engine == "xla_under_pallas":
        default = pb.Dedisperse(ps, dm, engine="xla", pad_margin=margin)
        pads = default.pad_start + default.pad_end
        with pmaker.set("pallas"), jmaker.set("pallas"):
            return (pb.Dedisperse(ps, dm, engine="xla",
                                  samples_per_frame=4096 - pads, **kw),
                    jb.Dedisperse(js, dm, engine="xla",
                                  samples_per_frame=4096 - pads, **kw))
    return (pb.Dedisperse(ps, dm, engine=engine, **kw),
            jb.Dedisperse(js, dm, engine=engine, **kw))


def same_geometry(p, j):
    assert p.engine == j.engine
    assert (p.pad_start, p.pad_end, p._padded_samples_per_frame,
            p.samples_per_frame, p.shape) == \
        (j.pad_start, j.pad_end, j._padded_samples_per_frame,
         j.samples_per_frame, j.shape)
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)
    assert p.reference_frequency.to_value(pu.MHz) == \
        j.reference_frequency.to_value(ju.MHz)
    assert p.dm.to_value(pu.DM) == j.dm.to_value(ju.DM)
    assert p.dedispersion_measure.to_value(pu.DM) == \
        j.dedispersion_measure.to_value(ju.DM)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", CONFIGS)
def test_geometry(name, engine):
    p, j = dedispersers(name, engine)
    same_geometry(p, j)
    if engine == "pallas":
        n2 = pb.ops.split_n(p._padded_samples_per_frame)[1]
        assert p._padded_samples_per_frame == 4096
        assert p.pad_start % n2 == 0 and p.pad_end % n2 == 0


@pytest.mark.parametrize("name", CONFIGS)
def test_chirps_identical(name):
    p, j = dedispersers(name, "pallas")
    j._chirp()
    for a, b in zip(p._storage_chirp(), j._storage_chirp()):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p, j = dedispersers(name, "xla")
    want = j._chirp()
    np.testing.assert_array_equal(p._chirp(), j._chirp_host)
    assert np.asarray(want).dtype == p._chirp().dtype == np.complex64


@pytest.mark.parametrize("name", CONFIGS)
def test_pallas_dedisperse_dechannelize(name, monkeypatch):
    p, j = dedispersers(name, "pallas")
    pc, jc = pb.Dechannelize(p), jb.Dechannelize(j)
    assert pc.shape == jc.shape and pc.sample_shape == jc.sample_shape
    assert pc.samples_per_frame == jc.samples_per_frame
    np.testing.assert_array_equal(pc.frequency.to_value(pu.MHz),
                                  jc.frequency.to_value(ju.MHz))
    got = pc.read()   # the last frame re-reads a full window at an offset
    assert_close(got, jc.read())
    _, _, _, dm, margin, _ = CONFIGS[name]
    # the same task on the plain whole-window filter (torch.fft)
    from baseband_tasks_tpu_torch import dispersion as pdisp
    from baseband_tasks_tpu_torch.ops import spectral_filter as psf
    monkeypatch.setattr(pdisp, "spectral_filter_pow2",
                        psf.spectral_filter_pow2_ref)
    plain = pb.Dechannelize(pb.Dedisperse(
        p.ih, dm, engine="pallas", samples_per_frame=2048,
        pad_margin=margin)).read()
    assert_close(got, plain.numpy())


@pytest.mark.parametrize("name", CONFIGS)
def test_xla_under_pallas_fft(name):
    p, j = dedispersers(name, "xla_under_pallas")
    assert p._padded_samples_per_frame == 4096
    with pmaker.set("pallas"), jmaker.set("pallas"):
        lanes = int(np.prod(p.sample_shape))
        assert pmaker((4096, lanes), np.complex64)._use_pallas
        assert_close(p.read(), j.read())


@pytest.mark.parametrize("name", CONFIGS)
def test_xla_default_engine(name):
    p, j = dedispersers(name, "xla")
    p.seek(500), j.seek(500)
    assert_close(p.read(3000), j.read(3000))


def test_short_stream_downgrades_to_xla():
    src = sources("8ch", n=3000)
    p, j = dedispersers("8ch", "pallas", src=src)
    same_geometry(p, j)
    assert p.engine == "xla" and p._padded_samples_per_frame == 3000
    assert_close(p.read(), j.read())


def test_engine_choice_and_refusals():
    ps, _ = sources("8ch")
    assert pb.Dedisperse(ps, 0.05).engine == "xla"      # a CPU stream
    cuda = pb.SetAttribute(pb.EmptyStreamGenerator(
        (20000, 8), PTime.from_mjd(58000.0), 1 * pu.MHz, device="cuda"),
        frequency=300 * pu.MHz, sideband=1)
    assert pb.Dedisperse(cuda, 0.05).engine == "pallas"
    narrow = pb.SetAttribute(pb.EmptyStreamGenerator(
        (20000, 4), PTime.from_mjd(58000.0), 1 * pu.MHz, device="cuda"),
        frequency=300 * pu.MHz, sideband=1)
    assert pb.Dedisperse(narrow, 0.05).engine == "xla"
    real, _ = sources("8ch", dtype=np.float32)
    with pytest.raises(ValueError, match="complex"):
        pb.Disperse(real, 0.05, engine="pallas")
    with pytest.raises(ValueError, match="unknown engine"):
        pb.Disperse(ps, 0.05, engine="cufft")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_disperse_dedisperse_roundtrip(engine):
    ps, _ = sources("8ch")
    raw = ps.read().numpy()
    ps.seek(0)
    disp = pb.Disperse(ps, 0.05, engine=engine)
    back = pb.Dedisperse(disp, 0.05, engine=engine)
    out = back.read().numpy()
    q0 = disp.pad_start + back.pad_start
    want = raw[q0:q0 + len(out)]
    err = np.mean(np.abs(out - want) ** 2) / np.mean(np.abs(want) ** 2)
    assert err < 2e-4
