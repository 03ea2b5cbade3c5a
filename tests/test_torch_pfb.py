"""The port's polyphase filter bank, its kernels' plain versions and the
spectral filter's lane mixes and streaming form, against the JAX package.

Both packages get the same numpy inputs: arrays for the ops (the JAX
Pallas kernels in interpret mode, at 'highest' matmul precision), and
baseband through ``StreamGenerator`` for the tasks.  Host arrays (the
prototype filter, the Wiener gains, the DFT and lane matrices, the taps)
and metadata must be identical; signal outputs agree to float32
roundoff and are held to 1e-5 of their largest element (PLANE_TOL).
Small shapes: n = 64 channels x 2 pols (L = 128 lanes) with 8 taps, and
n = 32 with 4 taps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.ops import dft_matmul as jdm  # noqa: E402
from baseband_tasks_tpu.ops import pfb_pallas as jpfb  # noqa: E402
from baseband_tasks_tpu.ops import spectral_filter as jsf  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as pdd  # noqa: E402
from baseband_tasks_tpu_torch.ops import dft_matmul as pdm  # noqa: E402
from baseband_tasks_tpu_torch.ops import pfb as ppfb  # noqa: E402
from baseband_tasks_tpu_torch.ops import spectral_filter as psf  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PLANE_TOL = 1e-5

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


@pytest.fixture(autouse=True)
def _highest():
    with jdm.set_matmul_precision("highest"):
        yield


def assert_close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_TOL * peak)


def planes(rng, shape, count=2):
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# -- host arrays ---------------------------------------------------------

@pytest.mark.parametrize("args,kw", [((4, 2048), {}), ((8, 256), {}),
                                     ((12, 64, 0.95), {}),
                                     ((8, 64), {"sinc_scale": 0.9})])
def test_sinc_hamming_bit_for_bit(args, kw):
    got, want = pb.sinc_hamming(*args, **kw), jb.sinc_hamming(*args, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,reps", [(64, 2), (16, 1), (8, 3)])
def test_matrices_identical(n, reps):
    for direction in ("forward", "backward"):
        for a, b in zip(pdm._expanded_mats(n, reps, direction),
                        jdm._expanded_mats(n, reps, direction)):
            np.testing.assert_array_equal(a, b)
    for inverse in (True, False):
        for a, b in zip(psf.lane_dft_mats(n, inverse=inverse),
                        jsf.lane_dft_mats(n, inverse=inverse)):
            np.testing.assert_array_equal(a, b)
    mats = psf.lane_dft_mats(n)
    for a, b in zip(psf.expand_lane_mats(mats, reps),
                    jsf.expand_lane_mats(mats, reps)):
        np.testing.assert_array_equal(a, b)


def test_geometry_gates_identical():
    for m in (13, 48, 52, 416, 448, 1000, 32256, 32257):
        for L in (64, 96, 128, 512):
            for n_tap in range(1, 12):
                assert ppfb.forward_geometry_ok(m, L, n_tap) == \
                    jpfb.forward_geometry_ok(m, L, n_tap)
        for hb in (8, 16):
            assert ppfb.choose_block_rows(m, hb) == \
                jpfb.choose_block_rows(m, hb)
    with pytest.raises(ValueError, match="row-block"):
        z = np.zeros((13, 128), np.float32)
        ppfb.pfb_forward_stream(z[:7], z[:7], z, z, z[:8], n_tap=8)


def test_matmul_precision_maps_to_torch():
    before = torch.get_float32_matmul_precision()
    assert pdm.matmul_precision() in ("highest", "high", "default")
    with pdm.set_matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "high"
        assert pdm.matmul_precision() == "high"
        with pdm.set_matmul_precision("default"):
            assert torch.get_float32_matmul_precision() == "medium"
        assert pdm.matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(KeyError):
        pdm.set_matmul_precision("medium")


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("axis", [0, 1])
def test_dft_matmul_planes(direction, axis):
    rng = np.random.default_rng(1)
    xr, xi = planes(rng, (16, 16, 3))
    got = pdm.dft_matmul_planes(*t(xr, xi), axis=axis, direction=direction,
                                n=16)
    want = jdm.dft_matmul_planes(xr, xi, axis=axis, direction=direction,
                                 n=16)
    for a, b in zip(got, want):
        assert_close(a, b)


# -- the kernels' plain versions against the JAX functions ---------------

N, REPS, L = 64, 2, 128


def pfb_inputs(n_tap, m=48, seed=2):
    rng = np.random.default_rng(seed)
    taps = np.repeat(rng.standard_normal((n_tap, N)).astype(np.float32),
                     REPS, axis=1)
    return rng, taps, jdm._expanded_mats(N, REPS, "forward")


@pytest.mark.parametrize("dft", [False, True])
def test_pfb_forward_two_steps_with_scale(dft):
    """Two streaming steps; the carry keeps its own iteration's scale."""
    n_tap, m = 8, 48
    rng, taps, (fr, fi) = pfb_inputs(n_tap)
    mats = (fr, fi) if dft else (None, None)
    k = n_tap - 1
    carry = [np.zeros((k, L), np.float32)] * 2
    for s in (np.float32(1.25), np.float32(0.75)):
        xr, xi = planes(rng, (m, L))
        got = ppfb.pfb_forward_stream(*carry, xr, xi, taps, *mats,
                                      n_tap=n_tap, scale=float(s))
        want = jpfb.pfb_forward_stream(*carry, xr, xi, taps, *mats,
                                       n_tap=n_tap, scale=s, block_rows=8)
        for a, b in zip(got, want):
            assert_close(a, b)
        carry = [xr[-k:] * s, xi[-k:] * s]


@pytest.mark.parametrize("n_tap", [2, 9])
def test_pfb_forward_tap_counts(n_tap):
    rng, taps, (fr, fi) = pfb_inputs(n_tap, seed=3)
    carry = planes(rng, (n_tap - 1, L))
    xr, xi = planes(rng, (48, L))
    got = ppfb.pfb_forward_stream(*t(*carry, xr, xi, taps, fr, fi),
                                  n_tap=n_tap)
    want = jpfb.pfb_forward_stream(*carry, xr, xi, taps, fr, fi, n_tap=n_tap)
    for a, b in zip(got, want):
        assert_close(a, b)


def filter_inputs(n, L, pads, seed):
    rng = np.random.default_rng(seed)
    n1, n2 = pdd.split_n(n)
    ph = rng.uniform(0, 2 * np.pi, (n2, n1, L))
    gain = [f(ph).astype(np.float32) for f in (np.cos, np.sin)]
    mix = [(m / np.sqrt(L)).astype(np.float32)
           for m in planes(rng, (L, L))]
    return rng, gain, mix


@pytest.mark.parametrize("pre,post", [(True, False), (False, True),
                                      (True, True)])
def test_spectral_filter_stream_lane_mixes(pre, post):
    n, L8, p0, p1 = 1024, 16, 64, 128
    rng, gain, mix = filter_inputs(n, L8, (p0, p1), 4)
    cr, ci = planes(rng, (p0 + p1, L8))
    xr, xi = planes(rng, (n - p0 - p1, L8))
    kw = dict(pad_start=p0, pad_end=p1, pre=mix if pre else None,
              post=psf.lane_dft_mats(L8) if post else None)
    got = psf.spectral_filter_stream(*t(cr, ci, xr, xi, *gain), scale=0.5,
                                     **kw)
    want = jsf.spectral_filter_stream(cr, ci, xr, xi, *gain,
                                      scale=np.float32(0.5), **kw)
    for a, b in zip(got, want):
        assert_close(a, b)
    # the streaming form is the full window with the block scaled
    full = psf.spectral_filter_pow2(
        *t(np.concatenate([cr, 0.5 * xr]), np.concatenate([ci, 0.5 * xi]),
           *gain), **kw)
    for a, b in zip(got, full):
        assert_close(a, b)


def test_spectral_filter_pow2_lane_mixes():
    n, L8, p0, p1 = 512, 8, 32, 64
    rng, gain, mix = filter_inputs(n, L8, (p0, p1), 5)
    xr, xi = planes(rng, (n, L8))
    kw = dict(pad_start=p0, pad_end=p1, pre=mix, post=mix[::-1])
    got = psf.spectral_filter_pow2(*t(xr, xi, *gain), **kw)
    want = jsf.spectral_filter_pow2(xr, xi, *gain, **kw)
    for a, b in zip(got, want):
        assert_close(a, b)
    plain = psf.spectral_filter_pow2(*t(xr, xi, *gain), kernels=False, **kw)
    for a, b in zip(got, plain):
        assert_close(a, b)


def test_stream_refusals():
    z = torch.zeros((512, 8))
    g = torch.zeros((32, 16, 8))
    with pytest.raises(ValueError, match="carry must hold"):
        psf.spectral_filter_stream(z[:32], z[:32], z[:448], z[:448], g, g,
                                   pad_start=32, pad_end=32)
    with pytest.raises(ValueError, match="multiple of N2"):
        psf.spectral_filter_stream(z[:48], z[:48], z[:464], z[:464], g, g,
                                   pad_start=16, pad_end=32)


# -- the tasks -----------------------------------------------------------

def sources(n, shape, rate_mhz, seed, freq=None):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((n,) + shape)
            + 1j * rng.standard_normal((n,) + shape)).astype(np.complex64)

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time):
        gen = pkg.StreamGenerator(frame, data.shape, time.from_mjd(58000.0),
                                  rate_mhz * units.MHz,
                                  samples_per_frame=4096, dtype=data.dtype)
        if freq is None:
            return gen
        return pkg.SetAttribute(gen, frequency=freq * units.MHz, sideband=1)
    return make(pb, pu, PTime), make(jb, ju, JTime)


def chains(engine, n_src=1 << 16, n=32, n_tap=4):
    """(port, jax) PolyphaseFilterBank -> InversePolyphaseFilterBank."""
    ps, js = sources(n_src, (2,), 1.0, 6, freq=np.array([400.0]))
    h = jb.sinc_hamming(n_tap, n)
    out = []
    for pkg, src in ((pb, ps), (jb, js)):
        pfb = pkg.PolyphaseFilterBank(src, h, samples_per_frame=448)
        out.append(pkg.InversePolyphaseFilterBank(
            pfb, h, sn=1e3, pad_start=16, pad_end=16, samples_per_frame=224,
            dtype=src.dtype, engine=engine))
    return out


def same_meta(p, j):
    assert (p.shape, p.samples_per_frame, p.dtype) == \
        (j.shape, j.samples_per_frame, j.dtype)
    assert p.sample_rate.to_value(pu.Hz) == j.sample_rate.to_value(ju.Hz)
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)
    np.testing.assert_array_equal(p.frequency.to_value(pu.MHz),
                                  j.frequency.to_value(ju.MHz))
    np.testing.assert_array_equal(p.sideband, j.sideband)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_metadata(engine):
    p, j = chains(engine)
    assert p.engine == j.engine == engine
    assert (p.pad_start, p.pad_end, p._padded_samples_per_frame) == \
        (j.pad_start, j.pad_end, j._padded_samples_per_frame)
    same_meta(p, j)
    same_meta(p.ih, j.ih)            # the Dechannelize
    same_meta(p.ih.ih, j.ih.ih)      # the PolyphaseFilterBank
    fp, fj = p.ih.ih.ih, j.ih.ih.ih  # its FIR
    assert (fp.pad_start, fp.pad_end, fp.samples_per_frame) == \
        (fj.pad_start, fj.pad_end, fj.samples_per_frame)
    np.testing.assert_array_equal(p.ih.ih.response, j.ih.ih.response)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_gains_identical(engine):
    p, j = chains(engine)
    m = p._rows
    np.testing.assert_array_equal(p._gain_np(m), j._gain_np(m))
    if engine == "pallas":
        for a, b in zip(p._storage_gain(), j._storage_gain()):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_forward_caches_identical():
    from baseband_tasks_tpu.models.compiled import _FusedPFBForward as JF
    from baseband_tasks_tpu_torch.models.compiled import (
        _FusedPFBForward as PF)
    p, j = chains("pallas", n=64, n_tap=8)
    pf, jf = PF(p.ih.ih.ih, p.ih.ih), JF(j.ih.ih.ih, j.ih.ih)
    assert (pf.n, pf.reps, pf.L) == (jf.n, jf.reps, jf.L) == (64, 2, 128)
    np.testing.assert_array_equal(pf.taps_lanes, jf.taps_lanes)
    for a, b in zip(pf.mats, jf.mats):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_eager_roundtrip(engine):
    """PFB -> inverse read eagerly (the last frame re-reads a full window
    at an offset) equals the JAX package's."""
    p, j = chains(engine)
    assert_close(p.read(), np.asarray(j.read()))


def test_forward_pfb_eager():
    ps, js = sources(1 << 15, (2,), 1.0, 7)
    h = jb.sinc_hamming(8, 64)
    p = pb.PolyphaseFilterBank(ps, h, samples_per_frame=64)
    j = jb.PolyphaseFilterBank(js, h, samples_per_frame=64)
    assert (p.shape, p.samples_per_frame) == (j.shape, j.samples_per_frame)
    p.seek(10), j.seek(10)
    assert_close(p.read(200), np.asarray(j.read(200)))


def test_short_stream_pallas_fallback():
    """A stream too short for the planned window clamps the frame off
    the pow2 grid: both packages switch to 'pallas-fallback' and run the
    'xla' form."""
    p, j = chains("pallas", n_src=12000)
    assert p.engine == j.engine == "pallas-fallback"
    assert p._padded_samples_per_frame == j._padded_samples_per_frame
    assert_close(p.read(), np.asarray(j.read()))


def test_auto_engine_and_refusals():
    ps, _ = sources(1 << 14, (2,), 1.0, 8)
    spectra = pb.Channelize(ps, 32)
    h = pb.sinc_hamming(4, 32)
    assert pb.InversePolyphaseFilterBank(spectra, h).engine == "xla"
    card = pb.Channelize(pb.EmptyStreamGenerator(
        (1 << 14, 2), PTime.from_mjd(58000.0), 1 * pu.MHz, device="cuda"), 32)
    assert pb.InversePolyphaseFilterBank(card, h).engine == "pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        pb.InversePolyphaseFilterBank(spectra, h, engine="cufft")
    with pytest.raises(ValueError, match="even"):
        pb.PolyphaseFilterBank(ps, pb.sinc_hamming(4, 33))


def test_dechannelize_task_planes():
    ps, js = sources(1 << 12, (2,), 1.0, 9)
    pc, jc = pb.Channelize(ps, 16), jb.Channelize(js, 16)
    x = np.asarray(js.read(1024))
    for node_p, node_j, data in (
            (pc, jc, x),
            (pb.Dechannelize(pc), jb.Dechannelize(jc),
             np.asarray(jc.task(x)))):
        got = node_p.task_planes(tuple(t(data.real.copy(),
                                         data.imag.copy())))
        want = node_j.task_planes((data.real, data.imag))
        for a, b in zip(got, want):
            assert_close(a, b)
