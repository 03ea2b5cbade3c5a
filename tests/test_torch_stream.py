"""The port's stream-task core against the JAX package.

Both packages get the same numpy data through ``StreamGenerator``
(the port's ``Noise`` draws from torch generators, which cannot give the
JAX package's threefry stream, so it is tested on its own: random access,
seeds and moments).  Stream metadata, sample pointers and times must be
identical; signal outputs agree to float32 FFT roundoff and are held to
1e-5 of their largest element (PLANE_TOL), exact where no FFT is
involved.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PLANE_TOL = 1e-5
START = "2018-01-01T00:00:00.000000000"


def assert_close(got, want, exact=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        peak = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_TOL * peak)


def same_time(a, b):
    return (np.array_equal(a.jd1, b.jd1) and np.array_equal(a.jd2, b.jd2)
            and a.scale == b.scale)


def assert_same_meta(p, j):
    assert p.shape == j.shape
    assert p.dtype == j.dtype
    assert p.samples_per_frame == j.samples_per_frame
    assert p.sample_rate.to_value(pu.Hz) == j.sample_rate.to_value(ju.Hz)
    assert same_time(p.start_time, j.start_time)
    assert same_time(p.stop_time, j.stop_time)
    assert p.tell() == j.tell() and same_time(p.time, j.time)
    for name in ("frequency", "sideband", "polarization"):
        pv = p.meta["__attributes__"].get(name)
        jv = j.meta["__attributes__"].get(name)
        assert (pv is None) == (jv is None), name
        if name == "frequency" and pv is not None:
            pv, jv = pv.to_value(pu.MHz), jv.to_value(ju.MHz)
        if pv is not None:
            np.testing.assert_array_equal(pv, jv)


def pair(data, rate_hz, spf, **attrs):
    """The same numpy ``data`` as a StreamGenerator of each package."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time):
        kw = dict(attrs)
        if "frequency" in kw:
            kw["frequency"] = kw["frequency"] * units.MHz
        return pkg.StreamGenerator(frame, data.shape, time(START),
                                   rate_hz * units.Hz, samples_per_frame=spf,
                                   dtype=data.dtype, **kw)
    return make(pb, pu, PTime), make(jb, ju, JTime)


def cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def read_both(p, j, count=None):
    return p.read(count), np.asarray(j.read(count))


# -- sources, pointers, times -------------------------------------------

@pytest.mark.parametrize("offset,whence", [
    (100, 0), (-50, 2), (17, 1), ("1ms", 0), ("time", 0), (0, "end")])
def test_seek_tell_time(offset, whence):
    data = cplx((4000, 2), 0)
    p, j = pair(data, 1e6, 512, frequency=np.array([300.0, 310.0]),
                sideband=np.array([1, -1]), polarization=np.array(["X", "Y"]))
    assert_same_meta(p, j)
    p.seek(30), j.seek(30)
    if offset == "1ms":
        args_p, args_j = (1 * pu.ms, whence), (1 * ju.ms, whence)
    elif offset == "time":
        args_p = (PTime(START) + pb.utils.TimeDelta.from_sec(1.5e-3),)
        args_j = (JTime(START) + jb.utils.TimeDelta.from_sec(1.5e-3),)
    else:
        args_p = args_j = (offset, whence)
    assert p.seek(*args_p) == j.seek(*args_j)
    assert p.tell() == j.tell() and same_time(p.time, j.time)
    assert p.tell(pu.ms).to_value(pu.ms) == j.tell(ju.ms).to_value(ju.ms)
    n = min(300, p.shape[0] - p.tell())
    got, want = read_both(p, j, n)
    assert got.device == p.device == torch.device("cpu")
    assert_close(got, want, exact=True)
    assert p.tell() == j.tell()


@pytest.mark.parametrize("spf,reads", [(512, [100, 700, 1]), (1000, [2500]),
                                       (64, [0, 64, 65, 3])])
def test_reads_across_frames(spf, reads):
    data = cplx((3000, 3), 1)
    p, j = pair(data, 2e5, spf)
    for count in reads:
        got, want = read_both(p, j, count)
        assert_close(got, want, exact=True)
    with pytest.raises(EOFError):
        p.read(p.shape[0])


def test_read_errors_and_array():
    data = cplx((100,), 2)
    p, _ = pair(data, 1e3, 40)
    np.testing.assert_array_equal(np.asarray(p), data)
    p.seek(-1)
    with pytest.raises(OSError):
        p.read(1)
    p.close()
    with pytest.raises(ValueError, match="closed"):
        p.read(1)


# -- tasks ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,n", [(np.complex64, 16), (np.complex64, 64),
                                     (np.float32, 32)])
def test_channelize_square(dtype, n):
    rng = np.random.default_rng(3)
    data = cplx((8192, 2), 4) if dtype == np.complex64 else \
        rng.standard_normal((8192, 2)).astype(np.float32)
    p, j = pair(data, 1e6, 2048, frequency=np.array([300.0, 330.0]),
                sideband=np.array([1, -1]),
                polarization=np.array(["X", "Y"]))
    pc, jc = pb.Channelize(p, n), jb.Channelize(j, n)
    assert_same_meta(pc, jc)
    ps, js = pb.Square(pc), jb.Square(jc)
    assert_same_meta(ps, js)
    for (a, b), exact in (((pc, jc), False), ((ps, js), False)):
        a.seek(3), b.seek(3)
        got, want = read_both(a, b, 40)
        assert_close(got, want, exact)


@pytest.mark.parametrize("n,dtype", [(None, None), (16, np.float32)])
def test_dechannelize(n, dtype):
    nchan = 16 if n is None else n // 2 + 1
    data = cplx((512, nchan, 2), 5)
    if dtype is not None:   # real output: Hermitian-consistent spectra
        rng = np.random.default_rng(6)
        data = np.fft.rfft(rng.standard_normal((512, n, 2)), axis=1
                           ).astype(np.complex64)
    freq = np.broadcast_to(300 + 0.1 * np.arange(nchan)[:, None],
                           (nchan, 2))
    p, j = pair(data, 1e4, 128, frequency=freq, sideband=1)
    kw = {} if n is None else dict(n=n, dtype=dtype)
    pd, jd = pb.Dechannelize(p, **kw), jb.Dechannelize(j, **kw)
    assert_same_meta(pd, jd)
    pd.seek(100), jd.seek(100)
    got, want = read_both(pd, jd, 3000)
    assert_close(got, want)


def test_channelize_roundtrip():
    data = cplx((4096, 2), 7)
    p, _ = pair(data, 1e6, 1024)
    ch = pb.Channelize(p, 32)
    back = ch.inverse(ch)
    assert back.shape == p.shape
    np.testing.assert_allclose(back.read().numpy(), data, atol=1e-5)


@pytest.mark.parametrize("item", [slice(100, 900), slice(-500, None),
                                  slice(None, 7), "times"])
def test_get_slice(item):
    data = cplx((2000, 4), 8)
    p, j = pair(data, 1e5, 256, frequency=np.array([1., 2., 3., 4.]) * 100,
                sideband=1)
    if item == "times":
        ip = slice(PTime(START) + pb.utils.TimeDelta.from_sec(1e-3), None)
        ij = slice(JTime(START) + jb.utils.TimeDelta.from_sec(1e-3), None)
    else:
        ip = ij = item
    ps, js = p[ip], j[ij]
    assert type(ps).__name__ == "GetSlice"
    assert_same_meta(ps, js)
    got, want = read_both(ps, js)
    assert_close(got, want, exact=True)


@pytest.mark.parametrize("shape,pols", [((1000, 2), ["X", "Y"]),
                                        ((1000, 3, 2), ["L", "R"]),
                                        ((1000, 2, 5), [["X"], ["Y"]])])
def test_power(shape, pols):
    data = cplx(shape, 9)
    p, j = pair(data, 1e5, 300, polarization=np.array(pols))
    pp, jp = pb.Power(p), jb.Power(j)
    assert_same_meta(pp, jp)
    got, want = read_both(pp, jp, 700)
    assert_close(got, want)


@pytest.mark.parametrize("make", [
    lambda pkg, s: pkg.Reshape(s, (2, 3)),
    lambda pkg, s: pkg.Transpose(s, (2, 1)),
    lambda pkg, s: pkg.ReshapeAndTranspose(s, (3, 2), (-1, 1)),
    lambda pkg, s: pkg.GetItem(s, (1, slice(0, 2))),
    lambda pkg, s: s[:, 0],
    lambda pkg, s: s[10:50, 1]])
def test_shaping(make):
    data = cplx((200, 2, 3), 10)
    freq = 300 + np.arange(6).reshape(2, 3)
    p, j = pair(data, 1e5, 64, frequency=freq, sideband=np.array([[1], [-1]]),
                polarization=np.array([["X"], ["Y"]]))
    ps, js = make(pb, p), make(jb, j)
    assert_same_meta(ps, js)
    got, want = read_both(ps, js)
    assert_close(got, want, exact=True)


def test_task_and_set_attribute():
    data = cplx((1000, 2), 11)
    p, j = pair(data, 1e5, 250)
    pt = pb.Task(p, lambda d: d * 2)
    jt = jb.Task(j, lambda d: d * 2)
    pa = pb.SetAttribute(pt, frequency=np.array([100., 200.]) * pu.MHz,
                         sideband=1, sample_rate=2e5 * pu.Hz)
    ja = jb.SetAttribute(jt, frequency=np.array([100., 200.]) * ju.MHz,
                         sideband=1, sample_rate=2e5 * ju.Hz)
    assert_same_meta(pa, ja)
    got, want = read_both(pa, ja)
    assert_close(got, want, exact=True)


def test_empty_generator_device():
    sh = pb.EmptyStreamGenerator((100, 3), PTime(START), 1 * pu.kHz,
                                 samples_per_frame=30, dtype=np.float32,
                                 device="cpu")
    out = pb.Task(sh, lambda d: d + 1).read()
    assert out.dtype == torch.float32 and out.shape == (100, 3)
    assert bool((out == 1).all())
    assert pb.Square(sh).device == torch.device("cpu")


def test_sources_default_to_the_card(monkeypatch):
    """A source built without ``device`` is on the card when there is one
    (construction allocates nothing, so this runs without a card), and
    the tasks built on it follow; ``device="cpu"`` keeps it on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ng = pb.NoiseGenerator(shape=(1000, 2), start_time=PTime(START),
                           sample_rate=1 * pu.kHz, samples_per_frame=100,
                           seed=4)
    assert ng.device == torch.device("cuda")
    assert pb.Square(ng).device == torch.device("cuda")
    gen = pb.StreamGenerator(lambda sh: np.zeros((100, 2)), (1000, 2),
                             PTime(START), 1 * pu.kHz, samples_per_frame=100)
    assert gen.device == torch.device("cuda")
    cpu = pb.EmptyStreamGenerator((100, 3), PTime(START), 1 * pu.kHz,
                                  device="cpu")
    assert cpu.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pb.EmptyStreamGenerator((100, 3), PTime(START),
                                   1 * pu.kHz).device == torch.device("cpu")


# -- the port's own noise ------------------------------------------------

def noise(seed=4, dtype=np.complex64, shape=(4096, 4), spf=512):
    return pb.NoiseGenerator(shape=shape, start_time=PTime(START),
                             sample_rate=1 * pu.MHz, samples_per_frame=spf,
                             dtype=dtype, seed=seed)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32, np.complex128])
def test_noise_random_access(dtype):
    ng = noise(dtype=dtype)
    whole = ng.read()
    assert whole.dtype == pb.utils.dtypes.torch_dtype(dtype)
    for start, count in [(3000, 700), (0, 1), (511, 2), (1000, 1500)]:
        ng.seek(start)
        assert torch.equal(ng.read(count), whole[start:start + count])
    again = noise(dtype=dtype)
    again.seek(2048)
    assert torch.equal(again.read(512), whole[2048:2560])
    assert not torch.equal(noise(seed=5, dtype=dtype).read(), whole)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_noise_moments(dtype):
    x = noise(seed=9, dtype=dtype, shape=(1 << 16, 4), spf=4096).read()
    parts = (x.real, x.imag) if x.is_complex() else (x,)
    for part in parts:
        # 2^18 unit-variance samples: mean ~ 2e-3, var ~ 3e-3 (1 sigma)
        assert abs(float(part.mean())) < 0.01
        assert abs(float(part.var()) - 1.0) < 0.015
    if x.is_complex():
        assert abs(float((x.real * x.imag).mean())) < 0.01
    # neighbouring frames are not copies of each other
    assert not torch.equal(x[:4096], x[4096:8192])
