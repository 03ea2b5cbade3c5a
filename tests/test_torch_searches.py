"""The port's search models beyond the reference against the JAX
package: the DM-trial search (``models/dmsearch.py``), RM synthesis
(``models/rmsearch.py``) and the secondary spectrum
(``models/scintillation.py``).

Both packages get the same seeded numpy inputs (the cases of the JAX
package's ``tests/test_dmsearch.py``, ``tests/test_faraday.py``
``TestRMSynthesis`` and ``tests/test_scintillation.py``).  Transforms
agree to float32 roundoff, held to 1e-5 of the largest element of the
JAX result (SIGNAL_TOL; the FFTs and channel sums round at ~1e-6 of
it); the phase and transfer tables are identical; candidate lists
(times, trials, widths, hit counts) and the detect widths are exact,
the S/N to 1e-4 relative; the axes of the secondary spectrum equal.
The sharded forms run on a 4-shard mesh of CPU devices against
``search``/``fdf`` (the same bound: the products' blocking differs with
the column count) and against the JAX package's sharded forms on four of
its virtual CPU devices; ``from_jax_state`` takes the JAX tables.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu import models as jmodels  # noqa: E402
from baseband_tasks_tpu.faraday import C_M_PER_S  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch import models as pmodels  # noqa: E402
from baseband_tasks_tpu_torch import parallel  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

from test_dmsearch import dispersed_pulse  # noqa: E402
from test_scintillation import two_ray_dynamic  # noqa: E402

SIGNAL_TOL = 1e-5
FREQ = np.linspace(1400.0, 1500.0, 64)
RATE = 1000.0
TRIALS = np.linspace(0.0, 100.0, 41)
N = 4096


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(got, want, tol=SIGNAL_TOL):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def dm_searches(trials=TRIALS, n=N):
    return (pmodels.DMTrialSearch(pu.Quantity(FREQ, pu.MHz),
                                  pu.Quantity(RATE, pu.Hz), trials, n,
                                  device="cpu"),
            jmodels.DMTrialSearch(ju.Quantity(FREQ, ju.MHz),
                                  ju.Quantity(RATE, ju.Hz), trials, n))


def cpu_mesh(n, name):
    return parallel.Mesh(["cpu"] * n, (name,))


def jax_mesh(n, name):
    return JMesh(np.array(jax.devices("cpu")[:n]), (name,))


def noisy_pulses(seed=5):
    rng = np.random.default_rng(seed)
    power = (dispersed_pulse(60.0, FREQ, RATE, N, t0=700.0, width=4.0)
             * 0.8 + dispersed_pulse(20.0, FREQ, RATE, N, t0=2000.0,
                                     width=2.0) * 0.4)
    return power + rng.standard_normal(power.shape).astype(np.float32) * 0.3


# -- DMTrialSearch -------------------------------------------------------

@pytest.mark.parametrize("dm, t0, width", [(60.0, 500.0, 2.0),
                                           (0.0, 1000.0, 2.0),
                                           (37.5, 300.0, 1.0)])
def test_search_matches_jax(dm, t0, width):
    p, j = dm_searches()
    assert p.max_delay_samples == j.max_delay_samples
    np.testing.assert_array_equal(p._phase_r.numpy(), np.asarray(j._phase_r))
    np.testing.assert_array_equal(p._phase_i.numpy(), np.asarray(j._phase_i))
    power = dispersed_pulse(dm, FREQ, RATE, N, t0=t0, width=width)
    got = p.search(power)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert_close(got, j.search(power))
    valid = host(got)[:N - p.max_delay_samples]
    t, k = np.unravel_index(np.argmax(valid), valid.shape)
    assert abs(TRIALS[k] - dm) <= 2.6 and abs(t - t0) <= 2


def test_detect_and_candidates_match_jax():
    """jnp.std divides by n: the port's detect uses correction=0."""
    p, j = dm_searches()
    power = noisy_pulses()
    snr, bw = p.detect(power)
    jsnr, jbw = j.detect(power)
    np.testing.assert_allclose(snr, jsnr, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(bw, jbw)
    got = p.candidates(power, threshold=8.0)
    want = j.candidates(power, threshold=8.0)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["snr"] == pytest.approx(b["snr"], rel=1e-4)
        assert {k: a[k] for k in a if k != "snr"} == \
            {k: b[k] for k in b if k != "snr"}
    noise = np.random.default_rng(6).standard_normal((N, 64)).astype(
        np.float32)
    assert p.candidates(noise, threshold=12.0) == \
        j.candidates(noise, threshold=12.0) == []


def test_search_stream_matches_jax():
    n_total = 12288
    full = dispersed_pulse(60.0, FREQ, RATE, n_total, t0=6000.0)

    def make(pkg, units, time):
        def frame(sh):
            o = sh.tell()
            return full[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
        kw = {"device": "cpu"} if pkg is pb else {}
        return pkg.StreamGenerator(frame, (n_total, 64),
                                   time("2020-01-01T00:00:00.0"),
                                   units.Quantity(RATE, units.Hz),
                                   samples_per_frame=2048,
                                   dtype=np.float32, **kw)
    p, j = dm_searches()
    got = p.search_stream(make(pb, pu, PTime))
    want = j.search_stream(make(jb, ju, JTime))
    assert_close(got, want)
    t, k = np.unravel_index(np.argmax(host(got)), tuple(got.shape))
    assert abs(TRIALS[k] - 60.0) <= 2.6 and abs(t - 6000) <= 2


@pytest.mark.parametrize("n_dm", [40, 41])
def test_search_sharded(n_dm):
    """Four CPU shards against search (a trial count that does not divide
    them is padded in the port; the JAX package needs it to divide) and
    against the JAX package's sharded search."""
    trials = np.linspace(0.0, 100.0, n_dm)
    p, j = dm_searches(trials)
    power = dispersed_pulse(60.0, FREQ, RATE, N, t0=500.0)
    got = p.search_sharded(power, cpu_mesh(4, "dm"))
    assert tuple(got.shape) == (N, n_dm)
    assert_close(got, p.search(power))
    if n_dm % 4 == 0:
        assert_close(got, j.search_sharded(power, jax_mesh(4, "dm")))
    else:
        with pytest.raises(ValueError, match="divide"):
            j.search_sharded(power, jax_mesh(4, "dm"))
    with pytest.raises(ValueError, match="no axis"):
        p.search_sharded(power, cpu_mesh(4, "z"))


def test_from_jax_state():
    p, j = dm_searches()
    s = pmodels.DMTrialSearch.from_jax_state(
        pu.Quantity(FREQ, pu.MHz), pu.Quantity(RATE, pu.Hz), TRIALS, N,
        np.asarray(j._phase_r), np.asarray(j._phase_i), device="cpu")
    power = dispersed_pulse(60.0, FREQ, RATE, N, t0=500.0)
    np.testing.assert_array_equal(host(s.search(power)),
                                  host(p.search(power)))
    with pytest.raises(ValueError, match="shape"):
        pmodels.DMTrialSearch.from_jax_state(
            pu.Quantity(FREQ, pu.MHz), pu.Quantity(RATE, pu.Hz), TRIALS,
            N, np.asarray(j._phase_r)[:-1], np.asarray(j._phase_i))


def test_dm_validation():
    for mod, units in ((pmodels, pu), (jmodels, ju)):
        with pytest.raises(ValueError, match="maximum trial delay"):
            mod.DMTrialSearch(units.Quantity(FREQ, units.MHz),
                              units.Quantity(RATE, units.Hz), [2000.0], 512)
    p, _ = dm_searches()
    with pytest.raises(ValueError, match="block shape"):
        p.search(np.zeros((N, 63), np.float32))


# -- RMSynthesis -----------------------------------------------------------

RM_CHAN = 32
RM_FREQ = 100.0 + (np.arange(RM_CHAN) - RM_CHAN / 2) * (50.0 / RM_CHAN)


def rm_pair(phis, **kw):
    jkw = dict(kw)
    return (pmodels.RMSynthesis(pu.Quantity(RM_FREQ, pu.MHz), phis,
                                device="cpu", **kw),
            jmodels.RMSynthesis(ju.Quantity(RM_FREQ, ju.MHz), phis, **jkw))


def winding(phi0, shape=()):
    lam2 = (C_M_PER_S / (RM_FREQ * 1e6)) ** 2
    p = np.exp(2j * phi0 * lam2) * np.ones(shape + (1,))
    rng = np.random.default_rng(3)
    p = p + 0.05 * (rng.standard_normal(p.shape)
                    + 1j * rng.standard_normal(p.shape))
    return p.real.astype(np.float32), p.imag.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"weights": np.r_[np.zeros(4),
                                                      np.ones(RM_CHAN - 4)]},
                                {"reference_lambda2": 0.0}])
@pytest.mark.parametrize("shape", [(), (3, 5)])
def test_fdf_matches_jax(kw, shape):
    phis = np.linspace(-20, 20, 161)
    p, j = rm_pair(phis, **kw)
    assert p.lam2_0 == j.lam2_0
    np.testing.assert_array_equal(p._tr.numpy(), np.asarray(j._tr))
    np.testing.assert_array_equal(p._ti.numpy(), np.asarray(j._ti))
    q, u_ = winding(4.0, shape)
    got = p.fdf(q, u_)
    assert got.dtype == torch.complex64 and tuple(got.shape) == \
        shape + (161,)
    assert_close(got, j.fdf(q, u_))
    peak = phis[np.argmax(np.abs(host(got)).reshape(-1, 161)[0])]
    assert abs(peak - 4.0) <= phis[1] - phis[0]


def test_rmsf_candidates_stokes_match_jax():
    phis = np.linspace(-10, 10, 81)
    p, j = rm_pair(phis)
    for a, b in zip(p.rmsf(), j.rmsf()):
        np.testing.assert_array_equal(a, b)
    q, u_ = winding(2.0, (2,))
    got, want = p.candidates(q, u_, 3.0), j.candidates(q, u_, 3.0)
    assert [c[0] for c in got] == [c[0] for c in want]
    np.testing.assert_allclose([c[1:] for c in got], [c[1:] for c in want],
                               rtol=1e-5)
    power = np.random.default_rng(1).standard_normal((7, RM_CHAN, 4)
                                                     ).astype(np.float32)
    for a, b in zip(pmodels.RMSynthesis.stokes_qu(power),
                    jmodels.RMSynthesis.stokes_qu(power)):
        np.testing.assert_array_equal(host(a), host(b))


@pytest.mark.parametrize("n_phi", [160, 161])
def test_fdf_sharded(n_phi):
    """Four CPU shards (a grid that does not divide them padded, as in
    the JAX package) against fdf and the JAX package's fdf_sharded."""
    phis = np.linspace(-20, 20, n_phi)
    p, j = rm_pair(phis)
    q, u_ = winding(4.0, (6,))
    got = p.fdf_sharded(q, u_, cpu_mesh(4, "phi"))
    assert_close(got, p.fdf(q, u_))
    assert_close(got, j.fdf_sharded(q, u_, jax_mesh(4, "phi")))


def test_rm_from_jax_state():
    phis = np.linspace(-20, 20, 161)
    p, j = rm_pair(phis, weights=np.linspace(0.5, 1.5, RM_CHAN))
    s = pmodels.RMSynthesis.from_jax_state(
        pu.Quantity(RM_FREQ, pu.MHz), phis, np.asarray(j._tr),
        np.asarray(j._ti), j.lam2_0,
        weights=np.linspace(0.5, 1.5, RM_CHAN), device="cpu")
    q, u_ = winding(-3.0)
    np.testing.assert_array_equal(host(s.fdf(q, u_)), host(p.fdf(q, u_)))


def test_end_to_end_voltage_recovery():
    """Voltages rotated at RM, detected, synthesized: the peak at RM in
    the port as in the JAX package (tests/test_faraday.py)."""
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((4096, RM_CHAN, 2))
         + 1j * rng.standard_normal((4096, RM_CHAN, 2))).astype(
             np.complex64)
    z[..., 1] = 0

    def make(pkg, units, time):
        def frame(sh):
            o = sh.tell()
            return z[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
        kw = {"device": "cpu"} if pkg is pb else {}
        gen = pkg.StreamGenerator(frame, z.shape, time("2022-02-02"),
                                  1.5625 * units.MHz,
                                  samples_per_frame=1024, dtype=z.dtype,
                                  **kw)
        src = pkg.SetAttribute(gen, frequency=RM_FREQ[:, None] * units.MHz,
                               sideband=1, polarization=np.array(["X", "Y"]))
        det = pkg.Power(pkg.FaradayRotate(src, 3.0))
        return host(det.read()).mean(0)
    phis = np.linspace(-15, 15, 301)
    p, j = rm_pair(phis)
    qp, up = pmodels.RMSynthesis.stokes_qu(make(pb, pu, PTime))
    qj, uj = jmodels.RMSynthesis.stokes_qu(make(jb, ju, JTime))
    got, want = p.fdf(qp, up), j.fdf(np.asarray(qj), np.asarray(uj))
    assert_close(got, want, 1e-4)
    peak = phis[int(np.argmax(np.abs(host(got))))]
    assert abs(peak - 3.0) <= 2 * (phis[1] - phis[0])


# -- secondary spectrum ----------------------------------------------------

@pytest.mark.parametrize("detrend", [True, False])
@pytest.mark.parametrize("shape", [(64, 128), (2, 32, 48)])
def test_secondary_matches_jax(detrend, shape):
    d = two_ray_dynamic(*shape[-2:])
    if len(shape) == 3:
        d = np.stack([d, d[::-1]])
    kw = dict(t_step=pu.Quantity(10.0, pu.s), nu_step=pu.Quantity(
        1.0, pu.MHz))
    S, ft, fnu = pmodels.secondary_spectrum(d, detrend=detrend,
                                            device="cpu", **kw)
    jS, jft, jfnu = jmodels.secondary_spectrum(
        d, detrend=detrend, t_step=ju.Quantity(10.0, ju.s),
        nu_step=ju.Quantity(1.0, ju.MHz))
    assert S.dtype == torch.float32
    assert_close(S, jS)
    np.testing.assert_array_equal(ft.to_value(pu.Hz), jft.to_value(ju.Hz))
    np.testing.assert_array_equal(fnu.to_value(pu.s), jfnu.to_value(ju.s))
    S0, ft0, _ = pmodels.secondary_spectrum(torch.from_numpy(d))
    assert S0.device.type == "cpu"
    np.testing.assert_array_equal(ft0, np.fft.fftshift(np.fft.fftfreq(
        shape[-2])))


def test_secondary_stream_analyzer():
    d = two_ray_dynamic(n_t=64)

    def make(pkg, units, time):
        kw = {"device": "cpu"} if pkg is pb else {}
        gen = pkg.StreamGenerator(
            lambda sh: d[sh.tell():sh.tell() + 16], shape=(64, 128),
            start_time=time("2020-01-01"),
            sample_rate=units.Quantity(0.1, units.Hz),
            samples_per_frame=16, dtype=np.float32, **kw)
        return pkg.SetAttribute(
            gen, frequency=(1400 + 0.25 * np.arange(128)) * units.MHz,
            sideband=1)
    S, ft, fnu = pmodels.SecondarySpectrum(make(pb, pu, PTime), 64).analyze()
    jS, jft, jfnu = jmodels.SecondarySpectrum(make(jb, ju, JTime),
                                              64).analyze()
    assert_close(S, jS)
    np.testing.assert_array_equal(ft.to_value(pu.Hz), jft.to_value(ju.Hz))
    np.testing.assert_array_equal(fnu.to_value(pu.s), jfnu.to_value(ju.s))
    i, k = np.unravel_index(int(S.argmax()), tuple(S.shape))
    assert abs(fnu[k].to_value(pu.s) - 12 / 32e6) < 1e-12


def test_secondary_validation():
    for mod, units, time, kw in ((pmodels, pu, PTime, {"device": "cpu"}),
                                 (jmodels, ju, JTime, {})):
        with pytest.raises(ValueError, match="time, freq"):
            mod.secondary_spectrum(np.ones(8, np.float32), **kw)
        pkg = pb if mod is pmodels else jb
        sh = pkg.NoiseGenerator(shape=(64, 4, 2), start_time=time(
            "2020-01-01"), sample_rate=1 * units.Hz, samples_per_frame=8,
            seed=1, dtype=np.float32, **kw)
        with pytest.raises(ValueError, match="sample shape"):
            mod.SecondarySpectrum(sh, 16)


# -- where numpy input goes ----------------------------------------------

class _Stop(Exception):
    """Raised by a spy once it has seen where the data would go."""


@pytest.mark.parametrize("call", [
    lambda: pb.rfi.spectral_kurtosis(np.ones(64, np.float32), 64),
    lambda: pmodels.RMSynthesis.stokes_qu(np.ones((3, 4), np.float32)),
    lambda: pmodels.secondary_spectrum(np.ones((8, 8), np.float32)),
    lambda: pmodels.RMSynthesis(pu.Quantity(RM_FREQ, pu.MHz),
                                np.linspace(-5, 5, 11)),
    lambda: pmodels.DMTrialSearch(pu.Quantity(FREQ, pu.MHz),
                                  pu.Quantity(RATE, pu.Hz), TRIALS, N),
], ids=["spectral_kurtosis", "stokes_qu", "secondary_spectrum",
        "RMSynthesis", "DMTrialSearch"])
def test_numpy_input_goes_to_the_card(monkeypatch, call):
    """Numpy given to an entry point with no device goes to the card
    when there is one (a spy stops the call at the conversion)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(data, dtype=None, device=None):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(torch, "as_tensor", spy)
    with pytest.raises(_Stop):
        call()
    assert seen == [torch.device("cuda")]
