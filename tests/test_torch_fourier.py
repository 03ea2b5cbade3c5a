"""The port's fourier engines, four-step FFT and spectral filter against
the JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(torch.fft, composed in the four-step layout); the JAX side runs its
Pallas kernels in interpret mode.  Inputs are made from numpy seeds and
fed to both.

Tolerances: the two sides run different float32 FFT algorithms, so
signal planes agree to float32 FFT roundoff, ~1e-6 of the largest
element: they are held to 1e-5 of it (PLANE_TOL).  Lengths, shapes,
dtypes, frequency axes and the numpy helper matrices must be identical.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu import fourier as jf  # noqa: E402
from baseband_tasks_tpu.ops import dft_matmul as jdm  # noqa: E402
from baseband_tasks_tpu.ops import fft_pallas as jfp  # noqa: E402
from baseband_tasks_tpu.ops import spectral_filter as jsf  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

from baseband_tasks_tpu_torch import fourier as pf  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import fft as ff  # noqa: E402
from baseband_tasks_tpu_torch.ops import spectral_filter as sf  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PLANE_TOL = 1e-5
ENGINES = ["numpy", "xla", "pallas"]


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_TOL * peak)


def as_numpy(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- engine layer ------------------------------------------------------------

@pytest.mark.parametrize("ns", [range(1, 300), range(300, 20000, 37),
                                [7919, 8193, 65537, 100001, 262145,
                                 2 ** 20 + 1, 3 ** 11, 10 ** 6 + 3]])
@pytest.mark.parametrize("engine", ["base", "pallas"])
def test_next_fast_len(engine, ns):
    if engine == "base":
        ours, theirs = pf.next_fast_len, jf.next_fast_len
    else:
        ours = pf.PallasFFTMaker.next_fast_len
        theirs = jf.PallasFFTMaker.next_fast_len
    assert [ours(n) for n in ns] == [theirs(n) for n in ns]


def test_registry_and_fft_maker_state():
    assert set(pf.FFT_MAKER_CLASSES) == set(jf.FFT_MAKER_CLASSES) \
        == set(ENGINES)
    assert type(pf.fft_maker.get()).__name__ == "XLAFFTMaker"
    with pf.fft_maker.set("pallas", use_kernels=False) as maker:
        assert pf.fft_maker.get() is maker and not maker.use_kernels
        with pf.fft_maker.set("numpy"):
            assert type(pf.fft_maker.get()).__name__ == "NumpyFFTMaker"
        assert pf.fft_maker.get() is maker
    assert type(pf.fft_maker.get()).__name__ == "XLAFFTMaker"
    with pytest.raises(TypeError):
        pf.fft_maker.set(pf.NumpyFFTMaker(), use_kernels=False)


@pytest.mark.parametrize("shape,dtype,axis,rate", [
    ((32, 2), np.complex64, 0, 32.0), ((32,), np.float32, 0, 32.0),
    ((4, 64, 3), np.float64, 1, None), ((6, 48), np.complex128, -1, 2.5),
    ((8, 1000), np.complex64, 1, 1e6)])
@pytest.mark.parametrize("engine", ENGINES)
def test_fft_metadata(engine, shape, dtype, axis, rate):
    kw = dict(axis=axis)
    ours = pf.FFT_MAKER_CLASSES[engine]()(
        shape, dtype, sample_rate=None if rate is None else rate * pu.Hz,
        **kw)
    theirs = jf.FFT_MAKER_CLASSES[engine]()(
        shape, dtype, sample_rate=None if rate is None else rate * ju.Hz,
        **kw)
    for attr in ("direction", "axis", "ortho", "time_shape", "time_dtype",
                 "frequency_shape", "frequency_dtype", "real_input"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    fo, ft = ours.frequency, theirs.frequency
    if rate is not None:
        fo, ft = fo.to_value(pu.Hz), ft.to_value(ju.Hz)
    np.testing.assert_array_equal(fo, ft)
    assert ours.inverse().direction == theirs.inverse().direction
    if engine == "pallas":
        assert ours._use_pallas == theirs._use_pallas


@pytest.mark.parametrize("shape", [(512, 8), (1024, 7), (768, 16),
                                   (256, 64), (2048, 4, 2), (8, 4096)])
def test_use_pallas_predicate(shape):
    for dtype in (np.complex64, np.complex128, np.float32):
        for axis in (0, -1):
            ours = pf.PallasFFTMaker()(shape, dtype, axis=axis)
            theirs = jf.PallasFFTMaker()(shape, dtype, axis=axis)
            assert ours._use_pallas == theirs._use_pallas


# (engine, shape, dtype): the pallas engine's (1024, 16) complex64 case
# runs the four-step passes, its real case is the 'xla' engine's
TRANSFORMS = [(e, (96, 3), np.complex64) for e in ("numpy", "xla")] + \
    [(e, (128, 6), np.float32) for e in ENGINES] + \
    [("pallas", (1024, 16), np.complex64)]


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("engine,shape,dtype", TRANSFORMS)
def test_transform_matches_jax(engine, shape, dtype, direction, ortho):
    rng = np.random.default_rng(3)
    ours = pf.FFT_MAKER_CLASSES[engine]()(shape, dtype, ortho=ortho)
    theirs = jf.FFT_MAKER_CLASSES[engine]()(shape, dtype, ortho=ortho)
    if direction == "backward":
        ours, theirs = ours.inverse(), theirs.inverse()
        x = cplx(ours.frequency_shape, 4).astype(ours.frequency_dtype)
        if ours.real_input:   # a Hermitian spectrum: rfft of real data
            x = np.fft.rfft(rng.standard_normal(shape), axis=0).astype(
                ours.frequency_dtype)
    elif np.dtype(dtype).kind == "c":
        x = cplx(shape, 5)
    else:
        x = rng.standard_normal(shape).astype(dtype)
    got = ours(torch.from_numpy(x))
    assert torch.is_tensor(got)
    if engine == "pallas":
        assert ours._use_pallas == (np.dtype(dtype).kind == "c")
    assert_close(as_numpy(got), np.asarray(theirs(x)))


def test_numpy_engine_keeps_input_kind():
    fft = pf.NumpyFFTMaker()((64, 2), np.complex64)
    x = cplx((64, 2), 6)
    assert isinstance(fft(x), np.ndarray)
    assert torch.is_tensor(fft(torch.from_numpy(x)))


# -- four-step FFT and spectral filter ------------------------------------

@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,L", [(512, 8), (4096, 16)])
def test_fft_pow2_planes_matches_pallas(n, L, inverse, ortho):
    x = cplx((n, L), 7)
    xr, xi = x.real.copy(), x.imag.copy()
    got = ff.fft_pow2_planes(torch.from_numpy(xr), torch.from_numpy(xi),
                             inverse=inverse, ortho=ortho)
    want = jfp.fft_pow2_planes(xr, xi, inverse=inverse, ortho=ortho)
    assert_close(as_numpy(got[0]) + 1j * as_numpy(got[1]),
                 np.asarray(want[0]) + 1j * np.asarray(want[1]))
    plain = ff.fft_pow2_planes(torch.from_numpy(xr), torch.from_numpy(xi),
                               inverse=inverse, ortho=ortho, kernels=False)
    assert_close(as_numpy(got[0]), as_numpy(plain[0]))


def test_fft_pow2_planes_rejects_non_pow2():
    x = torch.zeros((768, 8))
    with pytest.raises(ValueError, match="power of two"):
        ff.fft_pow2_planes(x, x)


def gain_case(n, L, seed):
    x = cplx((n, L), seed)
    gain = cplx((n, L), seed + 1)
    n1, n2 = dd.split_n(n)
    gs = dd.permute_to_storage_order(gain, n1, n2)
    return (x.real.copy(), x.imag.copy(),
            np.ascontiguousarray(gs.real), np.ascontiguousarray(gs.imag))


# (n, L, pad_start, pad_end): pads in multiples of N2 (32, 64, 64)
FILTERS = [(512, 8, 32, 32), (2048, 16, 64, 192), (4096, 8, 0, 64)]


@pytest.mark.parametrize("n,L,p0,p1", FILTERS)
def test_spectral_filter_matches_pallas(n, L, p0, p1):
    args = gain_case(n, L, 8)
    kw = dict(pad_start=p0, pad_end=p1)
    got = sf.spectral_filter_pow2(*map(torch.from_numpy, args), **kw)
    want = jsf.spectral_filter_pow2(*args, **kw)
    assert got[0].shape == (n - p0 - p1, L)
    assert_close(as_numpy(got[0]) + 1j * as_numpy(got[1]),
                 np.asarray(want[0]) + 1j * np.asarray(want[1]))
    plain = sf.spectral_filter_pow2_ref(*map(torch.from_numpy, args), **kw)
    assert_close(as_numpy(got[1]), as_numpy(plain[1]))


@pytest.mark.parametrize("n,L,p0,p1", FILTERS)
def test_k3_trim_matches_untrimmed(n, L, p0, p1):
    """The trim keeps exactly rows [p0, n - p1) of the inverse."""
    n1, n2 = dd.split_n(n)
    z = [torch.from_numpy(a) for a in gain_case(n, L, 9)[2:]]
    full = ff.k3_trim(*z)
    trim = ff.k3_trim(*z, pad_start=p0, pad_end=p1)
    for a, b in zip(trim, full):
        assert torch.equal(a, b[p0:n - p1])


def test_spectral_filter_geometry():
    for args in [(1024, 32, 32), (1024, 16, 32), (1000, 0, 0), (4096, 0, 64),
                 (4096, 64, 65), (1 << 18, 512, 512), (1 << 18, 346, 347)]:
        assert sf.geometry_ok(*args) == jsf.geometry_ok(*args)
    x = torch.zeros((1024, 8))
    g = torch.zeros((32, 32, 8))
    for kw, match in [(dict(pad_start=16, pad_end=0), "multiple of N2"),
                      (dict(pad_start=512, pad_end=512), "no valid rows")]:
        with pytest.raises(ValueError, match=match):
            sf.spectral_filter_pow2(x, x, g, g, **kw)
    with pytest.raises(ValueError, match="gain storage shape"):
        sf.spectral_filter_pow2(x, x, g[:16], g[:16], pad_start=0,
                                pad_end=0)


@pytest.mark.parametrize("n,reps,inverse", [(8, 1, True), (16, 2, False),
                                            (128, 1, True), (4, 4, True)])
def test_lane_mats_bit_for_bit(n, reps, inverse):
    ours = sf.expand_lane_mats(sf.lane_dft_mats(n, inverse=inverse), reps)
    theirs = jsf.expand_lane_mats(jsf.lane_dft_mats(n, inverse=inverse),
                                  reps)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["pre", "post", "stream"])
def test_lane_mix_and_stream_not_ported(which):
    """The lane mixes and the streaming form, once NotImplementedError,
    match the JAX package's full-window filter (the stream form fed the
    same window split into carry and block)."""
    args = gain_case(512, 8, 10)
    kw = dict(pad_start=32, pad_end=32)
    mix = {} if which == "stream" else {which: sf.lane_dft_mats(8)}
    with jdm.set_matmul_precision("highest"):
        want = jsf.spectral_filter_pow2(*args, **kw, **mix)
    x = [torch.from_numpy(a) for a in args]
    if which == "stream":
        got = sf.spectral_filter_stream(x[0][:64], x[1][:64], x[0][64:],
                                        x[1][64:], x[2], x[3], **kw)
    else:
        got = sf.spectral_filter_pow2(*x, **kw, **mix)
    assert got[0].shape == (448, 8)
    assert_close(as_numpy(got[0]) + 1j * as_numpy(got[1]),
                 np.asarray(want[0]) + 1j * np.asarray(want[1]))


def test_import_loads_no_jax():
    code = ("import sys, baseband_tasks_tpu_torch, "
            "baseband_tasks_tpu_torch.ops.fft, "
            "baseband_tasks_tpu_torch.ops.spectral_filter; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'baseband_tasks_tpu.'))] + "
            "(['baseband_tasks_tpu'] if 'baseband_tasks_tpu' in sys.modules "
            "else []); print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
