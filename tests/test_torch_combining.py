"""The port's joins, real-to-complex conversion and multi-input compiled
graphs against the JAX package.

Both packages get the same numpy data through ``StreamGenerator``.
``Concatenate``, ``Stack`` and ``CombineStreams`` (alignment, shapes,
meta attributes and data) agree bit for bit, as do the alignment
offsets; ``Real2Complex`` and the compiled multi-input graphs of the JAX
package's ``TestMultiInput`` (a join of two channelized streams, a sum
of two streams, a join under an absorbed Integrate, branches with
different streaming delays) agree to float32 roundoff, held to 1e-5 of
the largest element (SIGNAL_TOL), with the bookkeeping (block, delay,
warmup, per-source read offsets) identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402
from baseband_tasks_tpu.utils.time import TimeDelta as JDelta  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402
from baseband_tasks_tpu_torch.utils.time import (  # noqa: E402
    TimeDelta as PDelta)

SIGNAL_TOL = 1e-5
START = "2018-01-01T00:00:00.000000000"
PORT, JAX = (pb, pu, PTime), (jb, ju, JTime)

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def host(x):
    """A tensor or a JAX array as numpy."""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(got, want, tol=SIGNAL_TOL):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak)


def stream(side, data, spf=100, start=0.0, rate=None):
    """``data`` as a stream of one package, ``start`` seconds after START
    (a TimeDelta of samples: (n, rate_hz))."""
    pkg, units, time = side
    rate = 1 * units.kHz if rate is None else rate * units.Hz
    t0 = time(START)
    if isinstance(start, tuple):
        delta = (PDelta if pkg is pb else JDelta).from_samples(*start)
        t0 = t0 + delta
    elif start:
        t0 = t0 + start * units.s
    n = data.shape[0]

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, n - o)]
    return pkg.StreamGenerator(frame, data.shape, t0, rate,
                               samples_per_frame=spf, dtype=data.dtype)


def const(value, shape=(400, 2)):
    return np.full(shape, value, np.float32)


def noise(shape, seed, complex_data=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_data:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if complex_data else np.float32)


def both(build):
    """``build(side)`` on each package: (port, jax)."""
    return build(PORT), build(JAX)


def same_stream(p, j, n=None):
    assert (p.shape, p.dtype, p.samples_per_frame) == \
        (j.shape, j.dtype, j.samples_per_frame)
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)
    assert p._offsets == j._offsets
    got, want = p.read(n), j.read(n)
    np.testing.assert_array_equal(host(got), host(want))
    return host(got)


def test_concatenate():
    p, j = both(lambda s: s[0].Concatenate(
        [stream(s, const(1.0)), stream(s, const(2.0))]))
    data = same_stream(p, j, 10)
    assert p.shape == (400, 4)
    np.testing.assert_array_equal(data[:, :2], 1.0)
    np.testing.assert_array_equal(data[:, 2:], 2.0)


def test_concatenate_attributes():
    def build(s):
        pkg, units, _ = s
        a = pkg.SetAttribute(stream(s, const(1.0)),
                             frequency=[400., 400.] * units.MHz, sideband=1)
        b = pkg.SetAttribute(stream(s, const(2.0)),
                             frequency=[401., 401.] * units.MHz, sideband=1)
        return pkg.Concatenate([a, b])
    p, j = both(build)
    np.testing.assert_array_equal(p.frequency.to_value(pu.MHz),
                                  j.frequency.to_value(ju.MHz))
    np.testing.assert_array_equal(p.frequency.to_value(pu.MHz),
                                  [400, 400, 401, 401])
    np.testing.assert_array_equal(p.sideband, j.sideband)


def test_misaligned_starts():
    p, j = both(lambda s: s[0].Concatenate(
        [stream(s, const(1.0)), stream(s, const(2.0), start=0.1)]))
    assert p.shape == (300, 4)
    same_stream(p, j)
    assert abs((p.start_time - PTime(START)).sec - 0.1) < 1e-12


def test_refusals():
    for s in (PORT, JAX):
        pkg = s[0]
        with pytest.raises(ValueError, match="aligned|overlap"):
            pkg.Concatenate([stream(s, const(1.0)),
                             stream(s, const(2.0), start=0.0003301)])
        with pytest.raises(ValueError, match="time axis"):
            pkg.Concatenate([stream(s, const(1.0)),
                             stream(s, const(2.0))], axis=0)
        with pytest.raises(ValueError, match="time axis"):
            pkg.Stack([stream(s, const(1.0)), stream(s, const(2.0))],
                      axis=0)
        with pytest.raises(ValueError, match="two streams"):
            pkg.Stack([stream(s, const(1.0))])
        with pytest.raises(ValueError, match="sample rates"):
            pkg.Stack([stream(s, const(1.0)),
                       stream(s, const(2.0), rate=2000.0)])


@pytest.mark.parametrize("axis", [1, 2])
def test_stack(axis):
    p, j = both(lambda s: s[0].Stack(
        [stream(s, noise((400, 3), 1)), stream(s, noise((400, 3), 2))],
        axis=axis))
    data = same_stream(p, j)
    assert data.shape == ((400, 2, 3) if axis == 1 else (400, 3, 2))
    np.testing.assert_array_equal(np.take(data, 1, axis=axis),
                                  noise((400, 3), 2))


def test_combine_streams():
    p, j = both(lambda s: s[0].CombineStreams(
        [stream(s, const(3.0)), stream(s, const(2.0))],
        lambda ds: ds[0] - ds[1]))
    np.testing.assert_array_equal(same_stream(p, j, 10), 1.0)


def test_aligned_at_petasample_offset():
    """Alignment in exact rational arithmetic: a ~48-day offset at 1 GHz
    aligns, half a sample off does not."""
    n_off = 4_194_304_100_000_000

    def build(s):
        a = s[0].StreamGenerator(
            lambda sh: np.ones((min(sh.samples_per_frame,
                                    sh.shape[0] - sh.tell()), 2),
                               np.float32),
            (n_off + 400, 2), s[2](START), 1e9 * s[1].Hz,
            samples_per_frame=100, dtype=np.float32)
        b = stream(s, const(2.0), rate=1e9, start=(n_off, 1e9))
        return s[0].Stack([a, b])
    p, j = both(build)
    assert p.shape[0] == 400
    out = same_stream(p, j, 10)
    np.testing.assert_array_equal(out[:, 1], 2.0)
    for s in (PORT, JAX):
        a = stream(s, const(1.0, (4000, 2)), rate=1e9)
        b = stream(s, const(2.0), rate=1e9, start=(1000.5, 1e9))
        with pytest.raises(ValueError, match="not aligned"):
            s[0].Stack([a, b])


# -- Real2Complex -----------------------------------------------------------

def test_real2complex_tone():
    nu = 0.15
    x = np.cos(2 * np.pi * nu * np.arange(4096.0)).astype(np.float32)
    p, j = both(lambda s: s[0].Real2Complex(
        stream(s, x, spf=4096, rate=1e6)))
    assert (p.shape, p.dtype, p.sample_rate.to_value(pu.kHz)) == \
        ((2048,), np.complex64, 500)
    got = p.read().numpy()
    assert_close(got, j.read())
    i = np.arange(2048)[100:-100]
    np.testing.assert_allclose(got[100:-100],
                               np.exp(2j * np.pi * (2 * nu - 0.5) * i),
                               atol=2e-2)


def test_real2complex_noise_and_labels():
    x = noise((16384, 2), 2, complex_data=False)

    def build(s):
        pkg, units, _ = s
        src = pkg.SetAttribute(stream(s, x, spf=4096, rate=1e6),
                               frequency=400 * units.MHz, sideband=1)
        return pkg.Real2Complex(src)
    p, j = both(build)
    assert p.frequency.to_value(pu.MHz) == j.frequency.to_value(ju.MHz) \
        == pytest.approx(400.25)
    got = p.read().numpy()
    assert_close(got, j.read())
    assert np.mean(np.abs(got) ** 2) == pytest.approx(2.0, rel=0.05)
    with pytest.raises(ValueError, match="real"):
        pb.Real2Complex(stream(PORT, noise((128,), 3)))


# -- multi-input compiled graphs --------------------------------------------

def compiled_pair(build, **kw):
    """(port, jax) CompiledPipeline of ``build(side)``, bookkeeping
    checked identical, and the eager tails."""
    pt, jt = both(build)
    pc, jc = PCompiled(pt, **kw), JCompiled(jt, **kw)
    assert len(pc.sources) == len(jc.sources)
    assert (pc.block_samples, pc.tail_block, pc.delay, pc.warmup,
            pc.source_offsets) == (jc.block_samples, jc.tail_block,
                                   jc.delay, jc.warmup, jc.source_offsets)
    return pc, jc, pt, jt


def blocks_of(pc, jc, n):
    pb_, jb_ = pc.read_source_blocks(n), jc.read_source_blocks(n)
    for a, b in zip(pb_, jb_):
        np.testing.assert_array_equal(host(a), host(b))
    return pb_, jb_


def test_stack_two_streams():
    def build(s):
        return s[0].Square(s[0].Stack([
            s[0].Channelize(stream(s, noise((16384,), 31), 2048), 64),
            s[0].Channelize(stream(s, noise((16384,), 37), 2048), 64)]))
    pc, jc, pt, _ = compiled_pair(build)
    assert len(pc.sources) == 2
    pblocks, jblocks = blocks_of(pc, jc, 4)
    got = pc.run_blocks(pblocks)
    assert_close(got, jc.run_blocks(jblocks))
    pt.seek(0)
    assert_close(got, pt.read(got.shape[0]))


@pytest.mark.parametrize("scale", [None, 0.5])
def test_combine_streams_sum(scale):
    """A sum of two streams, complex step and planes step (the scale
    rides into the join)."""
    def build(s):
        return s[0].Square(s[0].CombineStreams(
            [stream(s, noise((16384,), 41), 2048),
             stream(s, noise((16384,), 43), 2048)], lambda d: d[0] + d[1]))
    pc, jc, pt, _ = compiled_pair(build, block_samples=4096)
    pblocks, jblocks = blocks_of(pc, jc, 4)
    assert_close(pc.run_blocks(pblocks), jc.run_blocks(jblocks))
    step, jstep = pc.planes_step(), jc.planes_step()
    carry, jcarry = pc.init_carry(planes=True), jc.init_carry(planes=True)
    for k in range(2):
        carry, (y, none) = step(carry, (pblocks[0][k], pblocks[1][k]),
                                scale)
        jx = [np.asarray(b[k]) for b in jblocks]
        jcarry, (jy, _) = jstep(jcarry, tuple((x.real, x.imag)
                                              for x in jx), scale)
        assert none is None
        assert_close(y, jy)


def test_combine_then_reduce():
    """A join under an absorbed Integrate."""
    def build(s):
        comb = s[0].CombineStreams(
            [stream(s, noise((16384,), 47), 2048),
             stream(s, noise((16384,), 53), 2048)], lambda d: d[0] + d[1])
        return s[0].Integrate(s[0].Square(s[0].Channelize(comb, 32)), 4)
    pc, jc, pt, _ = compiled_pair(build)
    n_blocks = 16384 // pc.block_samples
    pblocks, jblocks = blocks_of(pc, jc, n_blocks)
    data, counts = pc.run_reduced(pblocks)
    jdata, jcounts = jc.run_reduced(jblocks)
    assert_close(data, jdata)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    pt.seek(0)
    assert_close(data, pt.read(data.shape[0]))


def test_mismatched_delays_absorbed():
    """Branches with different streaming delays (one padded, one not)
    join by reading the less delayed branch's source later; the compiled
    output matches the JAX package's and, past the warmup, the eager
    chain (60 dB)."""
    x1, x2 = noise((65536,), 59), noise((65536,), 61)

    def build(s):
        pkg, units, _ = s
        src1 = pkg.SetAttribute(stream(s, x1, 8192, rate=1e6),
                                frequency=600 * units.MHz, sideband=1)
        ded = pkg.Dedisperse(src1, 1.0, samples_per_frame=8192,
                             engine="xla")
        return pkg.Square(pkg.CombineStreams(
            [ded, pkg.SetAttribute(stream(s, x2, 8192, rate=1e6))],
            lambda d: d[0] + d[1]))
    pc, jc, pt, _ = compiled_pair(build)
    ded = pt.ih.ihs[0]
    assert pc.source_offsets == [ded.pad_end, 0]
    w, d = pc.warmup, int(pc.delay)
    assert w == 2 * d
    pblocks, jblocks = blocks_of(pc, jc, 3)
    out = pc.run_blocks(pblocks).numpy()
    assert_close(out, jc.run_blocks(jblocks))
    pt.seek(0)
    eager = pt.read(4096).numpy()
    n = min(out.shape[0] - w, 4096 - (w - d))
    got, ref = out[w:w + n], eager[w - d:w - d + n]
    snr_db = 10 * np.log10(float(np.sum(ref ** 2))
                           / max(float(np.sum((got - ref) ** 2)), 1e-30))
    assert snr_db >= 60.0, snr_db


def test_join_compile_view():
    """``stream.compile()`` of a join reads like the eager join."""
    def build(s):
        return s[0].Stack([
            s[0].Channelize(stream(s, noise((8192,), 71), 1024), 16),
            s[0].Channelize(stream(s, noise((8192,), 73), 1024), 16)])
    pt, _ = both(build)
    view = pt.compile()
    assert view.shape == pt.shape
    got = view.read()
    pt.seek(0)
    assert_close(got, pt.read())
