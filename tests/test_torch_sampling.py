"""The port's resampling, delays and incoherent dispersion against the
JAX package.

Both packages get the same numpy data through ``StreamGenerator``: pure
complex tones (phases computed on the host in float64), noise and sample
counters.  ``ShiftAndResample`` runs on both ``Convolve`` engines ('pallas'
on the spectral-filter kernels' plain versions here, Pallas in interpret
mode on the JAX side), eagerly and compiled, with and without the LO
rotation; ``Resample``, ``TimeDelay``, ``ShiftSamples``, ``seek_float``,
``DisperseSamples`` and ``DedisperseSamples`` as in the JAX package's
tests.  Bit for bit: the sinc responses and LO factors (host float64),
``ShiftSamples`` and the incoherent shifts, ``seek_float``; resampled
signals within 1e-5 of their peak (SIGNAL_TOL).

The JAX package's compiled planes step drops ``ShiftAndResample``'s LO
rotation (it is applied in ``task`` only); the port folds it into the
response, so its planes step equals the JAX package's complex step
(``test_planes_step_keeps_lo``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.sampling import seek_float as jseek  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.sampling import seek_float as pseek  # noqa
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

SIGNAL_TOL = 1e-5
START = "2018-01-01T00:00:00.000000000"
PKGS = ((pb, pu, PTime), (jb, ju, JTime))

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def assert_close(got, want, tol=SIGNAL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak)


def pair(data, rate_khz=1.0, spf=1024, freq=None):
    """``data`` (numpy, time first) as a source of each package, labelled
    with ``freq`` MHz (sideband +1) if given: (port, jax)."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    out = []
    for pkg, units, time in PKGS:
        s = pkg.StreamGenerator(frame, data.shape, time(START),
                                rate_khz * units.kHz, samples_per_frame=spf,
                                dtype=data.dtype)
        if freq is not None:
            s = pkg.SetAttribute(s, frequency=freq * units.MHz, sideband=1)
        out.append(s)
    return out


def host(x):
    """A tensor or a JAX array as numpy."""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def tone(nu, shape=(4096, 2)):
    i = np.arange(shape[0], dtype=np.float64)
    x = np.exp(2j * np.pi * nu * i).astype(np.complex64)
    return np.ascontiguousarray(np.broadcast_to(
        x.reshape((-1,) + (1,) * (len(shape) - 1)), shape))


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def counter(shape=(1000, 2)):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(shape[0], dtype=np.float32).reshape(
            (-1,) + (1,) * (len(shape) - 1)), shape))


def same_node(p, j):
    assert (p.shape, p.pad_start, p.pad_end, p.samples_per_frame,
            p.dtype) == (j.shape, j.pad_start, j.pad_end,
                         j.samples_per_frame, j.dtype)
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)


def labels(st, n):
    """Label (input samples since START) of the next n output samples."""
    return (st.time - PTime(START)).sec * 1e3 + np.arange(n)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("shift", [3.0, 3.75, -2.25, [1.5, -0.5]])
def test_shift_and_resample(shift, engine):
    """Uniform shifts (a pure relabelling) and per-channel shifts, on
    both engines: geometry, response and output against the JAX
    package, and the tone's phase at each output label."""
    nu = 0.123
    ps, js = pair(tone(nu, (4096, 8)) if engine == "pallas"
                  else tone(nu))
    if engine == "pallas" and np.ndim(shift):
        shift = np.linspace(shift[0], shift[1], 8)
    kw = dict(samples_per_frame=1024, engine=engine, pad=16)
    p = pb.ShiftAndResample(ps, shift, **kw)
    j = jb.ShiftAndResample(js, shift, **kw)
    same_node(p, j)
    assert p.engine == engine
    np.testing.assert_array_equal(p.response, j.response)
    assert p._grid_offset == j._grid_offset
    p.seek(100)
    j.seek(100)
    lab = labels(p, 200)
    got = p.read(200).numpy()
    assert_close(got, j.read(200))
    lanes = 8 if engine == "pallas" else 2
    expected = np.exp(2j * np.pi * nu * (lab[:, None]
                                         - np.broadcast_to(shift, lanes)))
    atol = 2e-6 if np.ndim(shift) == 0 else 2e-2
    np.testing.assert_allclose(got, expected, atol=atol)


def test_shift_by_quantity_and_labels():
    ps, js = pair(tone(0.05))
    p = pb.ShiftAndResample(ps, 2.5 * pu.ms, samples_per_frame=1024)
    j = jb.ShiftAndResample(js, 2.5 * ju.ms, samples_per_frame=1024)
    same_node(p, j)
    assert abs((p.start_time - ps.start_time).sec
               - (p.pad_start + 2.5) / 1000.0) < 1e-9
    p.seek(50)
    j.seek(50)
    assert_close(p.read(50).numpy(), j.read(50))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_lo_rotation(engine):
    """The LO rotation (folded into the port's response): the factor bit
    for bit, the output against the JAX package's ``task``."""
    nu, shift = 0.1, np.linspace(3.1, 3.9, 8)
    ps, js = pair(tone(nu, (4096, 8)), freq=400.0)
    kw = dict(lo=None, samples_per_frame=1024, engine=engine, pad=16)
    p = pb.ShiftAndResample(ps, shift, **dict(kw, lo=400 * pu.MHz))
    j = jb.ShiftAndResample(js, shift, **dict(kw, lo=400 * ju.MHz))
    same_node(p, j)
    np.testing.assert_array_equal(p._lo_factor, j._lo_factor)
    p.seek(100)
    j.seek(100)
    lab = labels(p, 50)
    got = p.read(50).numpy()
    assert_close(got, j.read(50))
    extra = np.exp(-2j * np.pi * 400e6 * shift / 1000.0)
    np.testing.assert_allclose(
        got, np.exp(2j * np.pi * nu * (lab[:, None] - shift)) * extra,
        atol=2e-2)


def lo_nodes(engine="pallas"):
    """The setup of the JAX package's planes-step fault: 2^14 samples x 8
    lanes, per-lane shifts 0.1..0.6, lo 400 MHz, pad 16, frames of 1024."""
    ps, js = pair(noise((1 << 14, 8), 31), freq=400.0)
    kw = dict(pad=16, samples_per_frame=1024, engine=engine)
    return (pb.ShiftAndResample(ps, np.linspace(0.1, 0.6, 8),
                                lo=400 * pu.MHz, **kw),
            jb.ShiftAndResample(js, np.linspace(0.1, 0.6, 8),
                                lo=400 * ju.MHz, **kw))


def test_planes_step_keeps_lo():
    """The port's compiled planes step (``task_stream``: the LO rotation
    in the storage-order response) equals the JAX package's complex
    ``cached_step`` block for block; the JAX package's own planes step
    drops the rotation, by far more than roundoff."""
    p, j = lo_nodes()
    pc, jc = PCompiled(p), JCompiled(j)
    assert (pc.block_samples, pc.delay) == (jc.block_samples, jc.delay)
    pblocks, jblocks = pc.read_source_blocks(3), jc.read_source_blocks(3)
    step, carry = pc.planes_step(), pc.init_carry(planes=True)
    jstep, caches = jc.cached_step()
    jcarry = jc.init_carry()
    jpstep, jpcarry = jc.planes_step(), jc.init_carry(planes=True)
    for x, jx in zip(pblocks, jblocks):
        carry, (yr, yi) = step(carry, x)
        jcarry, want = jstep(jcarry, jx, caches)
        assert_close((yr + 1j * yi).numpy(), want)
        jx = np.asarray(jx)
        jpcarry, (jr, ji) = jpstep(jpcarry, (jx.real, jx.imag))
        gap = np.abs(np.asarray(jr) + 1j * np.asarray(ji)
                     - np.asarray(want)).max()
        assert gap > 0.1 * np.abs(np.asarray(want)).max()
    # the complex step and run_blocks agree with the planes step
    assert_close(pc.run_blocks(pblocks).numpy(), jc.run_blocks(jblocks))


def test_lo_none_planes_match():
    """Without an LO the two packages' planes steps agree."""
    ps, js = pair(noise((1 << 13, 8), 32))
    kw = dict(pad=16, samples_per_frame=1024, engine="pallas")
    pc = PCompiled(pb.ShiftAndResample(ps, np.linspace(0.1, 0.6, 8), **kw))
    jc = JCompiled(jb.ShiftAndResample(js, np.linspace(0.1, 0.6, 8), **kw))
    step, carry = pc.planes_step(), pc.init_carry(planes=True)
    jstep, jcarry = jc.planes_step(), jc.init_carry(planes=True)
    for x, jx in zip(pc.read_source_blocks(2), jc.read_source_blocks(2)):
        carry, (yr, yi) = step(carry, x, 0.5)
        jx = np.asarray(jx)
        jcarry, (jr, ji) = jstep(jcarry, (jx.real, jx.imag), 0.5)
        assert_close((yr + 1j * yi).numpy(),
                     np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("offset", ["time", 100.5])
def test_resample(offset):
    nu = 0.0625
    ps, js = pair(tone(nu))
    tp = PTime(START) + 100.3 / (1 * pu.kHz) if offset == "time" \
        else offset
    tj = JTime(START) + 100.3 / (1 * ju.kHz) if offset == "time" \
        else offset
    p = pb.Resample(ps, tp, samples_per_frame=1024)
    j = jb.Resample(js, tj, samples_per_frame=1024)
    same_node(p, j)
    assert p.tell() == j.tell()
    got = p.read(4).numpy()
    assert_close(got, j.read(4))
    at = 100.3 if offset == "time" else 100.5
    np.testing.assert_allclose(
        got[:, 0], np.exp(2j * np.pi * nu * (at + np.arange(4))), atol=2e-3)


def test_time_delay():
    nu = 0.11
    ps, js = pair(tone(nu), freq=400.0)
    p = pb.TimeDelay(ps, 2.5 * pu.ms, lo=[400., 400.] * pu.MHz)
    j = jb.TimeDelay(js, 2.5 * ju.ms, lo=[400., 400.] * ju.MHz)
    same_node(p, j)
    np.testing.assert_array_equal(p._phase_factor, j._phase_factor)
    np.testing.assert_array_equal(p.read(10).numpy(), np.asarray(j.read(10)))
    # a bare float delay counts samples; lo=None rotates nothing
    ps, js = pair(tone(nu))
    p = pb.TimeDelay(ps, 16, lo=None)
    j = jb.TimeDelay(js, 16, lo=None)
    same_node(p, j)
    np.testing.assert_array_equal(p.read(10).numpy(), tone(nu)[:10])
    t = pb.TimeDelay(ps, 1.0, lo=None, frequency=[500., 500.] * pu.MHz,
                     sideband=-1)
    assert np.all(t.frequency.to_value(pu.MHz) == 500.)
    assert np.all(t.sideband == -1)
    pr, _ = pair(counter((100, 2)))
    with pytest.raises(ValueError, match="complex"):
        pb.TimeDelay(pr, 1 * pu.ms, lo=None)


@pytest.mark.parametrize("shift", [[3, -2], [1.0, 3.25], [3.49, -1.9],
                                   [-5.0, 5.25], 4, [[0], [1], [2]],
                                   [2, 5]])
def test_shift_samples(shift):
    """Gathers (and a uniform slice) bit for bit against the JAX package,
    on (1000, 2) and, for the column shift, (1000, 3, 2) counters."""
    shape = (1000, 3, 2) if np.ndim(shift) == 2 or shift == [2, 5] \
        else (1000, 2)
    ps, js = pair(counter(shape), spf=250)
    p = pb.ShiftSamples(ps, shift, samples_per_frame=200)
    j = jb.ShiftSamples(js, shift, samples_per_frame=200)
    same_node(p, j)
    got = p.read().numpy()
    np.testing.assert_array_equal(got, np.asarray(j.read()))
    full = np.broadcast_to(np.round(np.asarray(shift)).astype(int),
                           shape[1:])
    q = np.arange(len(got)) + p.pad_start
    np.testing.assert_array_equal(
        got, (q.reshape((-1,) + (1,) * len(shape[1:])) - full).astype(
            np.float32))
    if p._uniform is None:
        assert p._index_tensor().dtype == torch.int64


def test_shift_samples_quantity_and_refusals():
    ps, js = pair(counter(), spf=250)
    a = pb.ShiftSamples(ps, np.array([3.49, -1.9]) / (1 * pu.kHz))
    b = jb.ShiftSamples(js, np.array([3.49, -1.9]) / (1 * ju.kHz))
    np.testing.assert_array_equal(a.read(20).numpy(), np.asarray(b.read(20)))
    for pkg, src in ((pb, ps), (jb, js)):
        with pytest.raises(ValueError, match="broadcast"):
            pkg.ShiftSamples(src, np.array([1, 2, 3]))


@pytest.mark.parametrize("offset", [
    0.0, 10.5, 10.0, "ms", "time", [1.75, 10.5], "grid"])
def test_seek_float(offset):
    ps, js = pair(np.zeros((2048, 3, 2), np.complex64), spf=256)
    args = []
    for units, time in ((pu, PTime), (ju, JTime)):
        if offset == "ms":
            args.append(0.015 * units.s)
        elif offset == "time":
            args.append(time(START) + 0.013 * units.s)
        elif offset == "grid":
            args.append(np.linspace(1, 10, 6).reshape(3, 2) * units.ms)
        else:
            args.append(offset)
    np.testing.assert_array_equal(pseek(ps, args[0]), jseek(js, args[1]))
    ps.seek(5)
    js.seek(5)
    assert pseek(ps, 1.5, whence=1) == jseek(js, 1.5, whence=1) == 6.5
    assert pseek(ps, -0.5, whence=2) == 2048 - 0.5
    with pytest.raises(ValueError, match="whence"):
        pseek(ps, 0.0, whence=3)
    with pytest.raises(pu.UnitsError):
        pseek(ps, 1.0 * pu.m)


@pytest.mark.parametrize("d", [0.25, -7.6])
def test_round_trip(d):
    """+d then -d recovers the stream to the interpolation accuracy, in
    both packages alike."""
    out = []
    for (pkg, units, time), src in zip(PKGS, pair(noise((4096, 2), 17))):
        back = pkg.ShiftAndResample(pkg.ShiftAndResample(
            src, d, samples_per_frame=1024), -d, samples_per_frame=1024)
        back.seek(time(START) + 1.0 * units.s)
        out.append(host(back.read(512)))
    assert_close(*out)
    np.testing.assert_allclose(out[0], noise((4096, 2), 17)[1000:1512],
                               atol=1e-2)


def test_time_delay_then_resample_is_shift_and_resample():
    nu, lo = 0.0789, 400
    out = []
    for (pkg, units, time), s1, s2 in zip(PKGS, pair(tone(nu), freq=lo),
                                          pair(tone(nu), freq=lo)):
        anchor = time(START) + 1.0 * units.s
        delay = 3.75 / (1 * units.kHz)
        a = pkg.Resample(pkg.TimeDelay(s1, delay, lo=lo * units.MHz),
                         anchor, samples_per_frame=1024)
        b = pkg.ShiftAndResample(s2, delay, offset=anchor,
                                 lo=lo * units.MHz, samples_per_frame=1024)
        a.seek(anchor)
        b.seek(anchor)
        out.append([host(a.read(256)), host(b.read(256))])
    assert_close(out[0][0], out[1][0])
    assert_close(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[0][1], atol=2e-3)


# -- incoherent dispersion ------------------------------------------------

def multichannel(seed=3):
    return pair(noise((8192, 4), seed), rate_khz=100.0,
                freq=np.array([310.0, 320.0, 330.0, 340.0]))


def test_disperse_samples():
    """The per-channel whole-sample shifts, the reference frequency and
    the output bit for bit; the round trip recovers the input."""
    ps, js = multichannel()
    p = pb.DisperseSamples(ps, 0.5)
    j = jb.DisperseSamples(js, 0.5)
    same_node(p, j)
    assert p.reference_frequency.to_value(pu.MHz) == \
        j.reference_frequency.to_value(ju.MHz)
    np.testing.assert_array_equal(p._rel_index_host,
                                  np.asarray(j._rel_index))
    np.testing.assert_array_equal(p.read(1000).numpy(),
                                  np.asarray(j.read(1000)))
    rt = pb.DedisperseSamples(pb.DisperseSamples(ps, 0.5), 0.5)
    jrt = jb.DedisperseSamples(jb.DisperseSamples(js, 0.5), 0.5)
    same_node(rt, jrt)
    q0 = rt.pad_start + rt.ih.pad_start
    np.testing.assert_array_equal(rt.read(1000).numpy(),
                                  noise((8192, 4), 3)[q0:q0 + 1000])
    assert rt.dm.to_value(pu.DM) == 0.5
    assert rt.dedispersion_measure.to_value(pu.DM) == -0.5


def test_incoherent_mid_channel_for_real():
    freqs = np.array([300., 301., 302., 303.])
    ps, js = pair(np.zeros((4096, 4), np.float32), rate_khz=1000.0,
                  freq=freqs)
    p = pb.DisperseSamples(ps, pb.DispersionMeasure(1.0))
    j = jb.DisperseSamples(js, jb.DispersionMeasure(1.0))
    same_node(p, j)
    ref = p.reference_frequency.to_value(pu.MHz)
    assert ref == j.reference_frequency.to_value(ju.MHz)
    assert ref == pytest.approx((freqs + 0.5).mean())
    assert p.dm.to_value(pu.DM) == 1.0
    assert pb.DedisperseSamples(ps, 1.0).dm.to_value(pu.DM) == 1.0


def test_dedisperse_samples_compiles():
    """Square -> DedisperseSamples through the compiled step against the
    JAX package's compiled scan (|x|^2 to float32 roundoff)."""
    ps, js = multichannel(5)
    pcp = PCompiled(pb.DedisperseSamples(pb.Square(ps), 0.5,
                                         samples_per_frame=1024))
    jcp = JCompiled(jb.DedisperseSamples(jb.Square(js), 0.5,
                                         samples_per_frame=1024))
    assert (pcp.block_samples, pcp.delay, pcp.warmup) == \
        (jcp.block_samples, jcp.delay, jcp.warmup)
    got = pcp.run_blocks(pcp.read_source_blocks(4)).numpy()
    assert_close(got, jcp.run_blocks(jcp.read_source_blocks(4)))
