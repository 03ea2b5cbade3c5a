"""The port's spectral-kurtosis RFI tasks (``rfi.py``) against the JAX
package.

Both packages get the same seeded numpy data.  The estimator agrees to
float32 roundoff (rtol 1e-5, atol 1e-6 on values near 1) for complex and
real power, several block sizes and an all-zero block; the flags of
``ExciseSpectralKurtosis`` are identical cell for cell (zero fill by
multiply, NaN fill by select, the partial tail block judged with its own
M, an inf sample giving NaN under zero fill in both packages), and the
kept samples bit for bit.  The compiled chain of the JAX package's
``tests/test_rfi.py`` (Channelize -> Excise -> Square) cuts its blocks on
the decision grid and equals its eager stream flag for flag, and the JAX
package's compiled chain (rtol 1e-5, atol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu import rfi as jrfi  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch import rfi as prfi  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
START = "2020-01-01T00:00:00.0"
PORT, JAX = (pb, pu, PTime), (jb, ju, JTime)


def noise(shape, seed, complex_data=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_data:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if complex_data else np.float32)


def contaminated(n=1 << 13, n_chan=8, seed=3):
    """Noise with 25%-duty bursts in channel 3 (SK > 1 there)."""
    z = noise((n, n_chan), seed)
    z[:, 3] += 12.0 * (((np.arange(n) // 32) % 4) == 0)
    return z


def stream(side, data, spf=4096):
    pkg, units, time = side

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    return pkg.StreamGenerator(frame, data.shape, time(START),
                               1 * units.MHz, samples_per_frame=spf,
                               dtype=data.dtype, **kw)


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def both(build):
    return build(PORT), build(JAX)


@pytest.mark.parametrize("n, d, complex_data", [
    (64, 1.0, True), (128, 1.0, True), (256, 1.0, True),
    (128, 0.5, False), (48, 0.5, False)])
def test_estimator_matches_jax(n, d, complex_data):
    x = noise((n * 32, 4), 1, complex_data)
    power = (np.abs(x) ** 2).astype(np.float32)
    got = prfi.spectral_kurtosis(torch.from_numpy(power), n, d).numpy()
    want = np.asarray(jrfi.spectral_kurtosis(power, n, d))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert prfi.sk_sigma(n, d) == jrfi.sk_sigma(n, d)
    # the axis argument, and numpy input
    np.testing.assert_allclose(
        prfi.spectral_kurtosis(power.T.copy(), n, d, axis=1).numpy(),
        np.asarray(jrfi.spectral_kurtosis(power.T, n, d, axis=1)),
        rtol=RTOL, atol=ATOL)


def test_estimator_edges():
    zeros = np.zeros(64, np.float32)
    assert prfi.spectral_kurtosis(zeros, 64).item() == \
        np.asarray(jrfi.spectral_kurtosis(zeros, 64)).item() == 1.0
    for mod in (prfi, jrfi):
        with pytest.raises(ValueError, match="multiple"):
            mod.spectral_kurtosis(np.ones(100, np.float32), 64)
        with pytest.raises(ValueError, match="at least 2"):
            mod.spectral_kurtosis(np.ones(64, np.float32), 1)


@pytest.mark.parametrize("complex_data", [True, False])
def test_sk_stream_matches_jax(complex_data):
    data = noise((1 << 14, 8), 5, complex_data)
    p, j = both(lambda s: s[0].SpectralKurtosis(stream(s, data), 256))
    assert (p.shape, p.dtype, p.sample_rate.to_value(pu.Hz), p.sigma) == \
        (j.shape, j.dtype, j.sample_rate.to_value(ju.Hz), j.sigma)
    np.testing.assert_allclose(host(p.read()), host(j.read()), rtol=RTOL,
                               atol=ATOL)


def flags(out, n):
    blocks = out[:len(out) // n * n]
    blocks = blocks.reshape((-1, n) + blocks.shape[1:])
    return np.all((blocks == 0) | np.isnan(blocks), axis=1)


@pytest.mark.parametrize("fill", [0.0, np.nan])
@pytest.mark.parametrize("complex_data", [True, False])
def test_excise_matches_jax(fill, complex_data):
    data = contaminated()
    if not complex_data:
        data = data.real.copy()
    p, j = both(lambda s: s[0].ExciseSpectralKurtosis(
        stream(s, data), 256, threshold=3.0, fill=fill))
    assert (p.samples_per_frame, p._task_granularity) == \
        (j.samples_per_frame, j._task_granularity)
    got, want = host(p.read()), host(j.read())
    np.testing.assert_array_equal(flags(got, 256), flags(want, 256))
    assert flags(got, 256)[:, 3].mean() > 0.9
    np.testing.assert_array_equal(got, want)


def test_partial_tail_block():
    """3 full blocks + a 232-sample tail judged with its own M; a
    1-sample tail passes through."""
    for n in (1000, 769):
        data = noise((n, 4), 9)
        data[800:] += 30.0 * (np.arange(n - 800)[:, None] == 3)
        p, j = both(lambda s: s[0].ExciseSpectralKurtosis(
            stream(s, data), 256, samples_per_frame=512))
        got, want = host(p.read()), host(j.read())
        np.testing.assert_array_equal(got, want)


def test_inf_under_zero_fill_is_nan():
    """Zero fill multiplies, so a flagged inf becomes NaN in both
    packages (a select would hide it)."""
    data = noise((512, 2), 11)
    data[10, 0] = np.inf
    p, j = both(lambda s: s[0].ExciseSpectralKurtosis(stream(s, data),
                                                      256))
    got, want = host(p.read()), host(j.read())
    assert np.isnan(got[10, 0]) and np.isnan(want[10, 0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_compiled_chain_matches_eager_and_jax():
    """The JAX package's test_compiled_chain_matches_eager: 48-spectra
    decision blocks force 64*48-sample source blocks."""
    data = noise((1 << 14,), 21)
    data[4000:4400] += 8.0

    def chain(s):
        return s[0].Square(s[0].ExciseSpectralKurtosis(
            s[0].Channelize(stream(s, data), 64), 48))
    pc, jc = PCompiled(chain(PORT)), JCompiled(chain(JAX))
    assert pc.block_samples == jc.block_samples
    assert pc.block_samples % (64 * 48) == 0
    n = (1 << 14) // pc.block_samples
    blocks = pc.read_source_blocks(n)
    got = pc.run_blocks(blocks).numpy()
    eager = host(chain(PORT).read(len(got)))
    np.testing.assert_array_equal(flags(got, 48), flags(eager, 48))
    assert np.any(eager == 0)
    np.testing.assert_allclose(got, eager, rtol=1e-4, atol=1e-4)
    want = np.asarray(jc.run_blocks(np.asarray(jc.read_source_blocks(n))))
    np.testing.assert_array_equal(flags(got, 48), flags(want, 48))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_validation_matches_jax():
    data = noise((1 << 12, 8), 3)
    for side in (PORT, JAX):
        with pytest.raises(ValueError, match="multiple"):
            side[0].ExciseSpectralKurtosis(stream(side, data), 256,
                                           samples_per_frame=1000)
        with pytest.raises(ValueError, match="at least 2"):
            side[0].ExciseSpectralKurtosis(stream(side, data), 1)
        with pytest.raises(ValueError, match="at least 2"):
            side[0].SpectralKurtosis(stream(side, data), 1)
