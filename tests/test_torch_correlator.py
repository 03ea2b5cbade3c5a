"""The port's FX correlator and tied-array beamformer against the JAX
package.

Both packages get the same numpy station data through
``StreamGenerator``: one complex 'sky' series (and independent receiver
noise for the beamformer), recorded by stations whose labels or data
carry known delays.  Each chain of the JAX package's
``test_correlator.py`` and ``test_beamform.py`` is built in both
packages: ``CrossMultiply``, ``fx_correlate`` with the 'sinc' and the
'phase' delay methods, with and without fringe stopping, and
``tied_array_beam`` coherent and incoherent, eagerly and compiled (one
source block per station, the integration absorbed).  Visibilities and
beams agree to float32 roundoff and are held to 1e-4 of their largest
element (VIS_TOL); the closed-form physics of the JAX package's tests
(coherence, phase slopes, fringe rotation, array gain) is checked on the
port's outputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
import baseband_tasks_tpu.models as jmodels  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
import baseband_tasks_tpu_torch.models as pmodels  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

VIS_TOL = 1e-4
START = "2018-01-01T00:00:00.000000000"
N = 1 << 14
N_CHAN = 32
PORT, JAX = (pb, pmodels, pu, PTime), (jb, jmodels, ju, JTime)

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def host(x):
    """A tensor, a JAX array or an ``Integrated`` as numpy."""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(got, want, tol=VIS_TOL):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak)


def series(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def station(side, data, delay=0.0, freq=None):
    """``data`` recorded by a station whose clock labels it ``delay``
    samples late (1 MHz), optionally labelled with ``freq`` MHz."""
    pkg, _, units, time = side

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    s = pkg.StreamGenerator(frame, data.shape, time(START), 1 * units.MHz,
                            samples_per_frame=4096, dtype=data.dtype)
    kw = dict(start_time=time(START) + delay / (1 * units.MHz))
    if freq is not None:
        kw.update(frequency=freq * units.MHz, sideband=1)
    return pkg.SetAttribute(s, **kw)


def both(build):
    return build(PORT), build(JAX)


def coherence(v):
    return np.abs(v[:, 1]) / np.sqrt(np.abs(v[:, 0] * v[:, 2]))


def test_cross_multiply():
    data = np.empty((64, 2), np.complex64)
    data[:, 0], data[:, 1] = 2.0, 1.0 - 1j

    def build(s):
        def frame(sh):
            return data[sh.tell():sh.tell() + sh.samples_per_frame]
        src = s[0].StreamGenerator(frame, (64, 2), s[3](START),
                                   1 * s[2].MHz, samples_per_frame=32,
                                   dtype=np.complex64)
        return s[1].CrossMultiply(src)
    p, j = both(build)
    assert p.baselines == j.baselines == ((0, 0), (0, 1), (1, 1))
    assert p.shape == j.shape == (64, 3)
    v = p.read(4).numpy()
    np.testing.assert_array_equal(v, np.asarray(j.read(4)))
    np.testing.assert_allclose(v[:, 1], (2 + 0j) * (1 + 1j))
    real = pb.StreamGenerator(lambda sh: np.zeros((32, 2), np.float32),
                              (64, 2), PTime(START), 1 * pu.MHz,
                              samples_per_frame=32, dtype=np.float32)
    with pytest.raises(ValueError, match="complex"):
        pmodels.CrossMultiply(real)
    with pytest.raises(ValueError, match="outside"):
        pmodels.CrossMultiply(p.ih, baselines=[(0, 2)])


# name -> (station delays in samples, compensated delays (samples or
# None), lo MHz, method, n_avg, read)
CASES = {
    "zero_delay": ((0.0, 0.0), None, None, "sinc", 64, 4),
    "residual_delay": ((0.0, 3.0), None, None, "sinc", 64, 6),
    "compensated_sinc": ((0.0, 2.25), (None, 2.25), None, "sinc", 64, 4),
    "compensated_phase": ((0.0, 3.25), (None, 3.25), None, "phase", 64, 4),
    "fringe_sinc": ((0.0, 2.5), (None, 2.5), 0.33, "sinc", 64, 2),
    "fringe_phase": ((0.0, 2.5), (None, 2.5), 0.33, "phase", 64, 2),
    "labels": ((0.0, 0.0), None, 1400.0, "sinc", 32, 2),
}


def correlator(side, case, data=None):
    delays, comp, lo, method, n_avg, _ = CASES[case]
    _, models, units, _ = side
    data = series(4) if data is None else data
    streams = [station(side, data, d, freq=lo) for d in delays]
    kw = dict(method=method)
    if comp is not None:
        kw["delays"] = [None if c is None else c / (1 * units.MHz)
                        for c in comp]
    if lo is not None and comp is not None:
        kw["lo"] = lo * units.MHz
    return models.fx_correlate(streams, N_CHAN, n_avg, **kw)


@pytest.mark.parametrize("case", CASES)
def test_fx_correlate(case):
    p, j = both(lambda s: correlator(s, case))
    assert (p.shape, p.dtype, p.sample_rate.to_value(pu.Hz)) == \
        (j.shape, j.dtype, j.sample_rate.to_value(ju.Hz))
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)
    n = CASES[case][-1]
    v = p.read(n).numpy()
    assert_close(v, j.read(n))
    assert v.shape == (n, 3, N_CHAN)
    coh = coherence(v)
    if case == "zero_delay":
        np.testing.assert_allclose(coh, 1.0, rtol=1e-5)
        np.testing.assert_allclose(np.angle(v[:, 1]), 0.0, atol=1e-5)
    elif case == "residual_delay":
        # E[X1 conj(X2)] = S exp(2 pi i f tau) (1 - tau/n)
        expected = np.exp(2j * np.pi * np.fft.fftfreq(N_CHAN) * 3)
        assert abs(coh.mean() - (1 - 3 / N_CHAN)) < 0.03
        resid = np.angle(np.mean(v[:, 1] * np.conj(expected), axis=0))
        assert np.abs(resid).max() < 0.1
    elif case.startswith("compensated"):
        assert coh.mean() > 0.99
        assert np.abs(np.angle(v[:, 1])).max() < 0.05
    elif case == "labels":
        np.testing.assert_array_equal(p.frequency.to_value(pu.MHz),
                                      j.frequency.to_value(ju.MHz))
        np.testing.assert_allclose(
            np.ravel(p.frequency.to_value(pu.MHz)),
            1400.0 + np.fft.fftfreq(N_CHAN), rtol=1e-9)


@pytest.mark.parametrize("method", ["sinc", "phase"])
def test_fringe_stopping(method):
    """With lo set the compensation rotates by exp(+2πi lo tau)."""
    with_lo = correlator(PORT, f"fringe_{method}").read(2).numpy()[:, 1]
    data = series(4)
    streams = [station(PORT, data, d, freq=0.33) for d in (0.0, 2.5)]
    without = pmodels.fx_correlate(
        streams, N_CHAN, 64, delays=[None, 2.5 / (1 * pu.MHz)],
        method=method).read(2).numpy()[:, 1]
    np.testing.assert_allclose(with_lo / without,
                               np.exp(-2j * np.pi * 0.33 * 2.5), rtol=2e-3)


def test_uncorrelated_stations():
    p, j = both(lambda s: s[1].fx_correlate(
        [station(s, series(1)), station(s, series(2))], N_CHAN, 128))
    v = p.read(2).numpy()
    assert_close(v, j.read(2))
    assert coherence(v).mean() < 0.3


def test_unaveraged_sums():
    p, j = both(lambda s: s[1].fx_correlate(
        [station(s, series(5)), station(s, series(5), 3.0)], N_CHAN, 16,
        average=False))
    got, want = p.read(3), np.asarray(j.read(3))
    assert_close(got.data, want["data"])
    np.testing.assert_array_equal(got.count.numpy(), want["count"])


@pytest.mark.parametrize("method, block", [("sinc", None),
                                           ("phase", N_CHAN * 64)])
def test_compiled_correlator(method, block):
    """The whole FX chain compiled (delay alignment, channelize, stack,
    cross-multiply, absorbed Integrate), against the JAX package's
    compiled scan and the eager visibilities of both."""
    case = "compensated_" + method
    kw = {} if block is None else dict(block_samples=block)
    pt, jt = both(lambda s: correlator(s, case))
    pc, jc = PCompiled(pt, **kw), JCompiled(jt, **kw)
    assert (pc.block_samples, pc.delay, pc.warmup, pc.source_offsets) == \
        (jc.block_samples, jc.delay, jc.warmup, jc.source_offsets)
    if method == "sinc":
        assert pc.source_offsets[1] > 0
    n_blocks = 6
    data, counts = pc.run_reduced(pc.read_source_blocks(n_blocks))
    jdata, jcounts = jc.run_reduced(jc.read_source_blocks(n_blocks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert_close(data, jdata)
    n = int((counts.numpy() == 64).sum())
    assert n >= 3
    eager = pt.read(n).numpy()
    assert_close(data[:n], eager)
    assert_close(data[:n], jt.read(n))


# -- the phase method on tones ----------------------------------------------

NU = 5.3 / 32       # a tone inside channel 5


def tone(delay):
    r = np.arange(1 << 14, dtype=np.float64)
    return np.exp(2j * np.pi * NU * (r - delay)).astype(np.complex64)


@pytest.mark.parametrize("tau", [2.25, -3.5, 7.0])
def test_phase_method_tone(tau):
    """'sinc' flattens the tone's phase; 'phase' leaves the intra-channel
    term 2π (ν - 5/32) frac(τ)."""
    for method in ("sinc", "phase"):
        p, j = both(lambda s: s[1].fx_correlate(
            [station(s, tone(0.0)), station(s, tone(tau))], 32, 64,
            delays=[None, tau / (1 * s[2].MHz)], method=method))
        v = p.read(3).numpy()
        assert_close(v, j.read(3))
        ph = np.angle(v[:, 1, 5])
        frac = tau - round(tau)
        want = 0.0 if method == "sinc" else 2 * np.pi * (NU - 5 / 32) * frac
        np.testing.assert_allclose(ph, want, atol=1e-3)
        assert coherence(v[..., 5:6]).min() > 0.999


# -- the tied-array beam ----------------------------------------------------

def noisy(side, sky_seed, own_seed, amp=1.0):
    return station(side, amp * series(sky_seed) + series(own_seed))


def test_coherent_sum_identity():
    """Identical stations, uniform weights: the beam is one station's
    spectra; per-channel weights of 1/2 the same."""
    p, j = both(lambda s: s[1].tied_array_beam(
        [station(s, series(4)), station(s, series(4))], 16))
    one = pmodels.tied_array_beam([station(PORT, series(4))], 16)
    a = p.read(64).numpy()
    assert a.shape == (64, 16)
    assert_close(a, j.read(64))
    np.testing.assert_allclose(a, one.read(64).numpy(), rtol=1e-5,
                               atol=1e-5)
    w = pmodels.tied_array_beam(
        [station(PORT, series(4)), station(PORT, series(4))], 16,
        weights=np.full((2, 16), 0.5, np.complex64))
    np.testing.assert_allclose(w.read(32).numpy(), a[:32], rtol=1e-6)


def test_coherent_gain():
    """Four stations with independent noise: the coherent beam's power
    over a noise-only beam's is 1 + n_st (signal-to-noise 1 a dish)."""
    def beam(s, amp):
        return s[1].tied_array_beam(
            [noisy(s, 1, 10 + k, amp) for k in range(4)], 16)
    p, j = both(lambda s: beam(s, 1.0))
    pw = np.abs(p.read(512).numpy()) ** 2
    assert_close(pw, np.abs(np.asarray(j.read(512))) ** 2)
    p0 = np.abs(beam(PORT, 0.0).read(512).numpy()) ** 2
    assert 0.8 * 5 < pw.mean() / p0.mean() < 1.2 * 5


def test_incoherent_mode():
    p, j = both(lambda s: s[1].tied_array_beam(
        [noisy(s, 1, 20 + k) for k in range(3)], 16, mode="incoherent"))
    assert p.dtype.kind == j.dtype.kind == "f"
    got = p.read(256).numpy()
    assert_close(got, j.read(256))
    assert abs(got.mean() / (2 * 2 * 16) - 1) < 0.15


def test_delay_alignment_recovers_coherence():
    """A 5.25-sample delay, compensated by the 'phase' method, keeps the
    beam's power; mis-compensated by 2.5 samples it decoheres."""
    def beam(s, comp):
        return s[1].tied_array_beam(
            [station(s, series(4)), station(s, series(4), 5.25)], 16,
            delays=[0 * s[2].s, comp / (1 * s[2].MHz)], method="phase")
    p, j = both(lambda s: beam(s, 5.25))
    pg = np.abs(p.read(128).numpy()) ** 2
    assert_close(pg, np.abs(np.asarray(j.read(128))) ** 2)
    pbad = np.abs(beam(PORT, 2.75).read(128).numpy()) ** 2
    single = np.abs(pmodels.tied_array_beam(
        [station(PORT, series(4))], 16).read(128).numpy()) ** 2
    assert pg.mean() > 0.95 * single.mean()
    assert pbad.mean() < 0.75 * single.mean()


def test_beam_refusals():
    two = [station(PORT, series(4)), station(PORT, series(4))]
    with pytest.raises(ValueError, match="stations"):
        pmodels.tied_array_beam(two, 16, weights=np.ones(3))
    with pytest.raises(ValueError, match="stations"):
        pmodels.tied_array_beam(two, 16, weights=0.25)
    with pytest.raises(ValueError, match="real"):
        pmodels.tied_array_beam(two, 16, weights=np.ones(2, np.complex64),
                                mode="incoherent")
    with pytest.raises(ValueError, match="sinc.*phase"):
        pmodels.fx_correlate(two, 16, 4, method="fft")


def test_beam_matches_visibilities():
    """The two-station beam's power is the (0,0)+(1,1)+2 Re(0,1)
    visibility combination over 4."""
    stations = [noisy(PORT, 1, 30), noisy(PORT, 1, 31)]
    bp = (np.abs(pmodels.tied_array_beam(stations, 16).read(256).numpy())
          ** 2).mean(0)
    v = pmodels.fx_correlate(stations, 16, 256).read(1).numpy()[0]
    combo = (v[0].real + v[2].real + 2 * v[1].real) / 4.0
    np.testing.assert_allclose(bp, combo, rtol=0.05, atol=0.1)


def test_compiled_beamformer():
    """Four stations, 'phase' delays, compiled: against the JAX package's
    compiled scan and past the warmup against the port's eager beam."""
    def build(s):
        delays = [None] + [(11.25 + 7 * k) / (1 * s[2].MHz)
                           for k in range(1, 4)]
        return s[1].tied_array_beam(
            [station(s, series(3 + k)) for k in range(4)], 16,
            delays=delays, method="phase", samples_per_frame=2048)
    pt, jt = both(build)
    pc = PCompiled(pt, block_samples=2048)
    jc = JCompiled(jt, block_samples=2048)
    assert (pc.delay, pc.warmup, pc.source_offsets) == \
        (jc.delay, jc.warmup, jc.source_offsets)
    got = pc.run_blocks(pc.read_source_blocks(4))
    assert_close(got, jc.run_blocks(jc.read_source_blocks(4)))
    d, w = int(pc.delay), pc.warmup
    eager = pt.read(got.shape[0] - d).numpy()
    np.testing.assert_allclose(got.numpy()[w:], eager[w - d:], rtol=1e-3,
                               atol=2e-3)
