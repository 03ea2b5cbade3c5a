"""The port's convolution tasks against the JAX package.

Both packages get the same numpy baseband through ``StreamGenerator`` and
run ``ConvolveSamples`` (a depthwise conv1d against
``lax.conv_general_dilated``) and ``Convolve`` on both engines: 'xla'
(overlap-save on the FFT engine) and 'pallas' (the spectral-filter
kernels: their plain versions here, Pallas in interpret mode on the JAX
side), eagerly and through the compiled steps (windows of 2^11 samples,
8 lanes).  Geometry (pads, frames, shapes, start times, engines) must be
identical and the responses bit for bit; convolved signals agree to
float32 roundoff and are held to 1e-5 of their largest element
(SIGNAL_TOL).  The response transform is computed on the host in float64
in the port (float32 on the JAX side), so it is held to 1e-6 of its peak.
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

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

SIGNAL_TOL = 1e-5
RESPONSE_TOL = 1e-6

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")

# name -> (response, offset, real data): the JAX package's test cases
RESPONSES = {
    "real": (np.array([0.25, 0.5, 0.25], np.float32), 0, True),
    "complex": (np.array([0.5, 0.5j, -0.25], np.complex64), 0, False),
    "per_channel": (np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
                             np.float32), 0, True),
    "offset": (np.eye(7, dtype=np.float32)[3], 3, True),
}


def assert_close(got, want, tol=SIGNAL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak)


def sources(n, shape, seed, complex_data=True, spf=500, rate=1 * pu.kHz):
    """The same numpy noise as a source of each package; returns (port,
    jax, data)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n,) + shape)
    if complex_data:
        data = data + 1j * rng.standard_normal((n,) + shape)
    data = data.astype(np.complex64 if complex_data else np.float32)

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time):
        return pkg.StreamGenerator(frame, data.shape,
                                   time("2018-01-01T00:00:00.000000000"),
                                   rate.value * units.kHz,
                                   samples_per_frame=spf, dtype=data.dtype)
    return make(pb, pu, PTime), make(jb, ju, JTime), data


def same_geometry(p, j):
    assert (p.shape, p.pad_start, p.pad_end, p.samples_per_frame,
            p._padded_samples_per_frame, p.engine, p.dtype) == \
        (j.shape, j.pad_start, j.pad_end, j.samples_per_frame,
         j._padded_samples_per_frame, j.engine, j.dtype)
    assert (p.start_time.jd1, p.start_time.jd2) == \
        (j.start_time.jd1, j.start_time.jd2)


@pytest.mark.parametrize("case", RESPONSES)
@pytest.mark.parametrize("cls", ["Convolve", "ConvolveSamples"])
def test_matches_jax(cls, case):
    """Each response of the JAX package's tests, on both packages: the
    whole output, and against numpy's valid-mode convolution."""
    response, offset, real = RESPONSES[case]
    ps, js, raw = sources(2000, (2,), 21, complex_data=not real)
    p = getattr(pb, cls)(ps, response, offset=offset, samples_per_frame=512)
    j = getattr(jb, cls)(js, response, offset=offset, samples_per_frame=512)
    same_geometry(p, j)
    np.testing.assert_array_equal(p.response, j.response)
    got = p.read()
    assert got.dtype == (torch.float32 if real else torch.complex64)
    assert_close(got.numpy(), j.read())
    r = np.broadcast_to(response.reshape(response.shape[0], -1),
                        (response.shape[0], 2))
    want = np.stack([np.convolve(raw[:, i], r[:, i], mode="valid")
                     for i in range(2)], axis=1)
    start = p.pad_start - (response.shape[0] - 1 - offset)
    assert_close(got.numpy(), want[start:start + len(got)])


@pytest.mark.parametrize("cls", ["Convolve", "ConvolveSamples"])
def test_start_time_shift(cls):
    ps, js, _ = sources(2000, (2,), 22)
    p = getattr(pb, cls)(ps, np.ones(5, np.float32) / 5,
                         samples_per_frame=512)
    j = getattr(jb, cls)(js, np.ones(5, np.float32) / 5,
                         samples_per_frame=512)
    same_geometry(p, j)
    assert abs((p.start_time - ps.start_time).sec - 4e-3) < 1e-12


def test_fft_matches_direct():
    """Convolve (overlap-save) against ConvolveSamples (direct), across
    the packages both ways, on a 33-tap response."""
    ps, js, _ = sources(2000, (2,), 23)
    response = np.random.default_rng(3).standard_normal(33).astype(
        np.float32)
    a = pb.Convolve(ps, response, samples_per_frame=500).read().numpy()
    b = pb.ConvolveSamples(ps, response, samples_per_frame=500).read()
    assert_close(a, np.asarray(jb.ConvolveSamples(
        js, response, samples_per_frame=500).read()))
    assert_close(b.numpy(), np.asarray(jb.Convolve(
        js, response, samples_per_frame=500).read()))


def pallas_pair(samples_per_frame=1024, n=4096, lanes=8, seed=11):
    r = np.zeros(33, np.complex64)
    r[0], r[7], r[32] = 0.5, 1.0, -0.25
    ps, js, _ = sources(n, (lanes,), seed, spf=2048)
    return (pb.Convolve(ps, r, samples_per_frame=samples_per_frame,
                        engine="pallas"),
            jb.Convolve(js, r, samples_per_frame=samples_per_frame,
                        engine="pallas"))


def test_pallas_engine_matches_jax():
    """engine='pallas': the geometry (a 2^11 window with the 32-sample pad
    rounded to the N2 = 64 grid), the storage-order response and the
    output against the JAX package in interpret mode."""
    p, j = pallas_pair()
    same_geometry(p, j)
    assert p.engine == "pallas"
    assert (p._padded_samples_per_frame, p.pad_start + p.pad_end) == \
        (2048, 64)
    for a, b in zip(p._storage_response(), j._storage_response()):
        assert_close(a.numpy(), b, RESPONSE_TOL)
    assert_close(p.read(3000).numpy(), j.read(3000))


def test_pallas_matches_xla():
    """The 'pallas' engine against the port's 'xla' engine on the same
    geometry (as the JAX package's test imposes it)."""
    p, _ = pallas_pair()
    x = pb.Convolve(p.ih, p.response, samples_per_frame=p.samples_per_frame,
                    engine="xla")
    x._pad_start = p._pad_start
    x._padded_samples_per_frame = p._padded_samples_per_frame
    x._start_time = p._start_time
    assert_close(x.read(2048).numpy(), p.read(2048).numpy())


@pytest.mark.parametrize("scales", [[None] * 3, [0.5, 2.0, None]])
def test_pallas_compiled_matches_jax(scales):
    """The compiled 'pallas' Convolve: the port's planes step (its
    ``task_stream``: k1_stream, k2, k3_trim) against the JAX package's
    planes step, and the complex steps against each other."""
    p, j = pallas_pair(n=6144)
    pc, jc = PCompiled(p), JCompiled(j)
    assert (pc.block_samples, pc.delay, pc.warmup) == \
        (jc.block_samples, jc.delay, jc.warmup) == (1984, 64, 64)
    pblocks, jblocks = pc.read_source_blocks(3), jc.read_source_blocks(3)
    np.testing.assert_array_equal(pblocks.numpy(), np.asarray(jblocks))
    step, jstep = pc.planes_step(), jc.planes_step()
    carry, jcarry = pc.init_carry(planes=True), jc.init_carry(planes=True)
    for x, jx, s in zip(pblocks, jblocks, scales):
        carry, (yr, yi) = step(carry, x, s)
        jx = np.asarray(jx)
        jcarry, (jr, ji) = jstep(jcarry, (jx.real, jx.imag), s)
        assert_close((yr + 1j * yi).numpy(),
                     np.asarray(jr) + 1j * np.asarray(ji))
    assert_close(pc.run_blocks(pblocks).numpy(), jc.run_blocks(jblocks))


def test_engines_and_refusals():
    ps, js, _ = sources(4096, (8,), 2)
    # 'auto' is the kernels only on a CUDA device
    assert pb.Convolve(ps, np.ones(9, np.complex64), engine="auto"
                       ).engine == "xla"
    with pytest.raises(ValueError, match="engine"):
        pb.Convolve(ps, np.ones(9, np.complex64), engine="mx")
    pr, jr, _ = sources(4096, (), 2, complex_data=False)
    for pkg, src in ((pb, pr), (jb, jr)):
        with pytest.raises(ValueError, match="complex"):
            pkg.Convolve(src, np.ones(9, np.float32), engine="pallas")
        with pytest.raises(ValueError, match="imaginary"):
            pkg.ConvolveSamples(src, np.ones(3, np.complex64))
        with pytest.raises(ValueError, match="dimension"):
            pkg.Convolve(src, np.float32(1.0))


def test_scalar_sample_stream():
    """A scalar-sample stream (one lane) on both engines and both
    classes."""
    ps, js, _ = sources(4096, (), 5, spf=1024)
    r = np.array([0.25, 0.5, 0.25, -0.1], np.complex64)
    for cls, kw in (("Convolve", dict(engine="pallas")),
                    ("Convolve", {}), ("ConvolveSamples", {})):
        p = getattr(pb, cls)(ps, r, samples_per_frame=1000, **kw)
        j = getattr(jb, cls)(js, r, samples_per_frame=1000, **kw)
        same_geometry(p, j)
        assert_close(p.read(2500).numpy(), j.read(2500))
