"""Packed ingest in the port against the JAX package, on the CPU: the
payload decoders (``ops/unpack.py``), the readers' ``read_packed`` and
``packed_decode_fn``, ``CompiledPipeline(..., packed=True)`` and
``StreamRunner`` (mirroring ``tests/test_packed_ingest.py`` and
``TestStreamRunner`` of ``tests/test_parallel.py``).

The decoders are held bit for bit to the JAX package's on the same
words (its float32 carriers viewed as uint32), the packed decode bit for
bit to the host decode of both packages; the compiled and streamed
chains to the JAX package's at float32 roundoff, and the runner exactly
to ``run_blocks(read_source_blocks(n))`` (the same step on the same
blocks)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.io import dada as jdada  # noqa: E402
from baseband_tasks_tpu.io import guppi as jguppi  # noqa: E402
from baseband_tasks_tpu.io import mark5b as jmark5b  # noqa: E402
from baseband_tasks_tpu.io import vdif as jvdif  # noqa: E402
from baseband_tasks_tpu.models.compiled import \
    CompiledPipeline as JCompiled  # noqa: E402
from baseband_tasks_tpu.models.runner import \
    StreamRunner as JRunner  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jud  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.io import dada as pdada  # noqa: E402
from baseband_tasks_tpu_torch.io import guppi as pguppi  # noqa: E402
from baseband_tasks_tpu_torch.io import mark5b as pmark5b  # noqa: E402
from baseband_tasks_tpu_torch.io import vdif as pvdif  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import \
    CompiledPipeline as PCompiled  # noqa: E402
from baseband_tasks_tpu_torch.models.runner import StreamRunner  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack as pup  # noqa: E402
from baseband_tasks_tpu_torch.shaping import GetSlice  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

START = "2018-06-15T07:00:00.000000000"
RATE = 1 << 20

# the runner chain's 4096-sample frames are not 2/3/5-smooth once padded
# (advisory only, as for the JAX package's FrameSizeWarning in the pytest
# settings)
pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def samples(shape, dtype, scale, seed=23):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * scale
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape) * scale
    return x.astype(dtype)


def port_template(data, rate_hz, start=START, spf=4096):
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    return pb.StreamGenerator(frame, data.shape, PTime(start),
                              pu.Quantity(rate_hz, pu.Hz),
                              samples_per_frame=spf, dtype=data.dtype,
                              device="cpu")


def write_vdif(tmp_path, bps, shape=(32768, 2), dtype=np.complex64,
               scale=16, spf=None, nthread=None, name=None):
    data = samples(shape, dtype, scale)
    path = str(tmp_path / (name or f"p{bps}.vdif"))
    with pvdif.open(path, "w", template=port_template(data, RATE), bps=bps,
                    samples_per_frame=spf, nthread=nthread) as fw:
        fw.write(data)
    return path


def open_both(path):
    return (pvdif.open(path, sample_rate=pu.Quantity(RATE, pu.Hz),
                       device="cpu"),
            jvdif.open(path, sample_rate=ju.Quantity(RATE, ju.Hz)))


def as_tensors(packed):
    if isinstance(packed, tuple):
        return tuple(torch.from_numpy(p) for p in packed)
    return torch.from_numpy(packed)


def check_packed(preader, jreader, offset, count):
    """The port's packed read and device decode against its host read, the
    JAX package's host read and the JAX package's packed decode; the words
    against the JAX carriers bit for bit."""
    packed = preader.read_packed(offset, count)
    jpacked = jreader.read_packed(offset, count)
    words = packed[0] if isinstance(packed, tuple) else packed
    carrier = jpacked[0] if isinstance(jpacked, tuple) else jpacked
    assert words.dtype == np.int32
    np.testing.assert_array_equal(words.view(np.uint32),
                                  carrier.view(np.uint32))
    if isinstance(packed, tuple):
        np.testing.assert_array_equal(packed[1], jpacked[1] > 0)
    dev = preader.packed_decode_fn()(as_tensors(packed)).numpy()
    preader.seek(offset)
    host = preader.read(count).numpy()
    jreader.seek(offset)
    jhost = np.asarray(jreader.read(count))
    jdev = np.asarray(jax.jit(jreader.packed_decode_fn())(jpacked))
    assert dev.dtype == host.dtype == jhost.dtype
    np.testing.assert_array_equal(host, jhost)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev, jdev)
    return dev


# -- the decoders -------------------------------------------------------------

DECODERS = [
    ("unpack_8bit", (), "unpack_8bit_device"),
    ("unpack_4bit", (), "unpack_4bit_device"),
    ("unpack_2bit", (), "unpack_2bit_device"),
    ("unpack_2bit", (pmark5b.M5B_2BIT_LEVELS,), "unpack_2bit_device"),
    ("unpack_1bit", (), "unpack_1bit_device"),
    ("unpack_16bit", (), "unpack_16bit_device"),
    ("unpack_8bit_signed", (), "unpack_8bit_signed_device"),
    ("unpack_16bit_signed", (), "unpack_16bit_signed_device"),
    ("f32_payload", (), "f32_payload_device"),
]


@pytest.mark.parametrize("name,args,jname", DECODERS)
def test_decoders_bit_for_bit(name, args, jname):
    """Every payload decoder on random words (every bit pattern's field
    values, the sign bit included) equals the JAX decoder on the same
    words as its float32 carrier, bit for bit."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (3, 5, 64), dtype=np.uint8)
    raw[0, 0, :8] = [0, 0, 0, 0x80, 0xFF, 0xFF, 0xFF, 0xFF]
    words = pup.words_from_bytes(raw.tobytes()).reshape(3, 5, 16)
    got = getattr(pup, name)(torch.from_numpy(words), *args).numpy()
    carrier = words.view(np.uint32).view(np.float32)
    want = np.asarray(getattr(jud, jname)(carrier, *args))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the readers --------------------------------------------------------------

@pytest.mark.parametrize("bps", [2, 4, 8, 16])
def test_vdif_dual_pol_complex(tmp_path, bps):
    path = write_vdif(tmp_path, bps,
                      scale={8: 16, 4: 2, 2: 1, 16: 1000}[bps])
    pr, jr = open_both(path)
    with pr, jr:
        spf = pr.packed_alignment
        assert spf == jr.packed_alignment
        check_packed(pr, jr, 0, 4 * spf)
        check_packed(pr, jr, 2 * spf, 2 * spf)      # an offset read


@pytest.mark.parametrize("shape,dtype,nthread", [
    ((16384,), np.float32, None), ((16384, 4, 2), np.complex64, None),
    ((16384, 4), np.float32, 4)])
def test_vdif_layouts(tmp_path, shape, dtype, nthread):
    """Real single channel, channels x threads, real threads."""
    path = write_vdif(tmp_path, 8, shape=shape, dtype=dtype, spf=1024,
                      nthread=nthread)
    pr, jr = open_both(path)
    with pr, jr:
        assert pr.sample_shape == jr.sample_shape == shape[1:]
        check_packed(pr, jr, 0, pr.shape[0])


def test_vdif_missing_frame_zero_filled(tmp_path):
    path = write_vdif(tmp_path, 8, spf=1024, nthread=2)
    pr, jr = open_both(path)
    with pr, jr:
        spf = pr.packed_alignment
        # a dropped frame: both paths of each reader consult its index
        pr._frame_table[1, 0] = -1
        del jr._frame_locs[(1, 0)]
        assert not pr.read_packed(0, 3 * spf)[1][1, 0]
        dev = check_packed(pr, jr, 0, 3 * spf)
    assert np.all(dev[spf:2 * spf, 0] == 0)
    assert np.all(dev[spf:2 * spf, 1] != 0)


def test_vdif_unaligned_read_and_bytes(tmp_path):
    path = write_vdif(tmp_path, 8)
    pr, _ = open_both(path)
    with pr:
        with pytest.raises(ValueError, match="frame-aligned"):
            pr.read_packed(100, pr.packed_alignment)
        # an 8-bit complex block crosses the boundary at ~1/4 the bytes
        # of its complex64 samples
        n = 4 * pr.packed_alignment
        words, mask = pr.read_packed(0, n)
        assert (words.nbytes + mask.nbytes) * 3 < n * 2 * 8
    _.close()


@pytest.mark.parametrize("bps", [1, 2, 4, 8])
def test_mark5b(tmp_path, bps):
    rate, nchan = 10_000_000, 4
    data = samples((40000, nchan), np.float32,
                   {8: 16, 4: 2, 2: 1, 1: 1}[bps], seed=7)
    path = str(tmp_path / f"m{bps}.m5b")
    with pmark5b.open(path, "w", template=port_template(
            data, rate, spf=10000), bps=bps) as fw:
        fw.write(data)
    pr = pmark5b.open(path, nchan=nchan, bps=bps, ref_time=PTime(START),
                      sample_rate=pu.Quantity(rate, pu.Hz), device="cpu")
    jr = jmark5b.open(path, nchan=nchan, bps=bps, ref_time=JTime(START),
                      sample_rate=ju.Quantity(rate, ju.Hz))
    with pr, jr:
        spf = pr.packed_alignment
        n = (pr.shape[0] // spf) * spf
        check_packed(pr, jr, 0, n)
        # a dropped frame decodes to zeros, as the host path fills it
        del pr._frame_locs[1]
        del jr._frame_locs[1]
        dev = check_packed(pr, jr, 0, min(3 * spf, n))
    assert np.all(dev[spf:2 * spf] == 0)


@pytest.mark.parametrize("nbit", [8, 16, 32])
def test_dada(tmp_path, nbit):
    data = samples((4000, 2), np.complex64, 10.0 if nbit != 32 else 1.0,
                   seed=9)
    path = str(tmp_path / f"d{nbit}.dada")
    with pdada.open(path, "w", template=port_template(
            data, 100_000, start="2020-01-01T12:34:56.0", spf=1000),
            nbit=nbit) as fw:
        fw.write(data)
    pr, jr = pdada.open(path, device="cpu"), jdada.open(path)
    with pr, jr:
        align = pr.packed_alignment
        assert align == jr.packed_alignment
        check_packed(pr, jr, 0, 4000)
        check_packed(pr, jr, 10 * align, 20 * align)


def test_guppi(tmp_path):
    data = samples((8192, 4, 2), np.complex64, 1.0, seed=5)
    path = str(tmp_path / "g.raw")
    with pguppi.open(path, "w", template=port_template(
            data, 3_000_000, start="2021-06-01T10:00:00.0", spf=2048),
            samples_per_block=2048) as fw:
        fw.write(data)
    pr, jr = pguppi.open(path, device="cpu"), jguppi.open(path)
    with pr, jr:
        check_packed(pr, jr, 0, 8192)
        check_packed(pr, jr, 2048, 4096)
        with pytest.raises(ValueError, match="whole raw blocks"):
            pr.read_packed(0, 3 * 8192)


# -- the compiled pipeline ----------------------------------------------------

def chains(path, pkg, units, time_fn=None):
    fr = pkg.io.vdif.open(path, sample_rate=units.Quantity(RATE, units.Hz),
                          **({} if pkg is jb else {"device": "cpu"}))
    return fr, pkg.Integrate(pkg.Square(pkg.Channelize(fr, 64)), 16)


@pytest.mark.parametrize("bps", [2, 8])
def test_compiled_packed_equals_float_path(tmp_path, bps):
    """Packed ingest through the compiled chain gives the float path's
    averages (roundoff) and counts (exactly), in the port and in the JAX
    package, and the two packages agree."""
    path = write_vdif(tmp_path, bps, scale=16 if bps == 8 else 1)
    out = {}
    for pkg, units, compiled in ((pb, pu, PCompiled), (jb, ju, JCompiled)):
        fr, tail = chains(path, pkg, units)
        cpf = compiled(tail, block_samples=8192)
        cpp = compiled(tail, block_samples=8192, packed=True)
        assert cpp._decoders[0] is not None and cpf._decoders[0] is None
        ref = cpf.run_reduced(cpf.read_source_blocks(4))
        got = cpp.run_reduced(cpp.read_source_blocks(4))
        got, ref = [tuple(np.asarray(a) for a in r) for r in (got, ref)]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1], ref[1])
        out[pkg] = got
        fr.close()
    np.testing.assert_allclose(out[pb][0], out[jb][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[pb][1], out[jb][1])


def test_compiled_packed_blocks_and_step(tmp_path):
    """read_source_blocks gives (words, mask) stacks of the reader's
    read_packed; step_fn decodes them to the float path's blocks."""
    path = write_vdif(tmp_path, 8)
    fr, tail = chains(path, pb, pu)
    with fr:
        cpp = PCompiled(tail.ih, block_samples=8192, packed=True)
        cpf = PCompiled(tail.ih, block_samples=8192)
        words, mask = cpp.read_source_blocks(2, offset=8192)
        assert words.dtype == torch.int32 and mask.dtype == torch.bool
        assert tuple(words.shape[:2]) == (2, 8192 // fr.packed_alignment)
        w1, m1 = fr.read_packed(2 * 8192, 8192)
        np.testing.assert_array_equal(words[1].numpy(), w1)
        np.testing.assert_array_equal(mask[1].numpy(), m1)
        got = cpp.run_blocks((words, mask))
        want = cpf.run_blocks(cpf.read_source_blocks(2, offset=8192))
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_packed_refusals(tmp_path):
    src = pb.NoiseGenerator(shape=(16384,), start_time=PTime(START),
                            sample_rate=pu.Quantity(RATE, pu.Hz),
                            samples_per_frame=4096, seed=5, device="cpu")
    with pytest.raises(ValueError, match="no source supports"):
        PCompiled(pb.Square(pb.Channelize(src, 64)), packed=True)
    path = write_vdif(tmp_path, 8)
    fr, _ = chains(path, pb, pu)
    with fr:
        # 1536 is a legal block for the chain (24 channelizer groups) but
        # not a multiple of the file's 1024-sample frame
        with pytest.raises(ValueError, match="frame-aligned"):
            PCompiled(pb.Square(pb.Channelize(fr, 64)), block_samples=1536,
                      packed=True)
        cpp = PCompiled(pb.Square(pb.Channelize(fr, 64)), block_samples=8192,
                        packed=True)
        with pytest.raises(NotImplementedError, match="planes"):
            cpp.planes_step()
        with pytest.raises(ValueError, match="mutually exclusive"):
            StreamRunner(cpp, planes=True)


# -- the runner ---------------------------------------------------------------

def dedisperse_file(tmp_path, n=40000, engine="xla"):
    """tests/test_parallel.py TestStreamRunner's file: 100 kHz real noise,
    8-bit VDIF frames of 2000."""
    data = samples((n,), np.float32, 16, seed=21)
    path = str(tmp_path / "runner.vdif")
    with pvdif.open(path, "w", template=port_template(
            data, 100_000, start="2020-01-01T00:00:00.0", spf=10000),
            bps=8, samples_per_frame=2000) as wh:
        wh.write(data)
    return path


def port_runner_chain(path, **kw):
    rh = pvdif.open(path, sample_rate=pu.Quantity(100, pu.kHz),
                    device="cpu")
    src = pb.SetAttribute(rh, frequency=600 * pu.MHz, sideband=1)
    return rh, pb.Square(pb.Dedisperse(src, 0.05, samples_per_frame=4096,
                                       **kw))


def test_runner_matches_run_blocks_and_jax(tmp_path):
    """The runner from an on-disk VDIF file: exactly run_blocks over
    read_source_blocks (the same step on the same blocks), and the JAX
    package's StreamRunner on the same file to float32 roundoff."""
    path = dedisperse_file(tmp_path)
    rh, tail = port_runner_chain(path)
    with rh:
        cp = PCompiled(tail)
        n_blocks = 40000 // cp.block_samples
        batch = cp.run_blocks(cp.read_source_blocks(n_blocks))
        out = StreamRunner(cp, prefetch=2).run(n_blocks)
        assert torch.equal(out, batch)
        out1 = StreamRunner(cp, prefetch=1).run(n_blocks - 1,
                                                offset=cp.block_samples)
        assert torch.equal(out1, cp.run_blocks(cp.read_source_blocks(
            n_blocks - 1, offset=cp.block_samples)))
    jh = jvdif.open(path, sample_rate=ju.Quantity(100, ju.kHz))
    try:
        jtail = jb.Square(jb.Dedisperse(jb.SetAttribute(
            jh, frequency=600 * ju.MHz, sideband=1), 0.05,
            samples_per_frame=4096))
        jcp = JCompiled(jtail)
        assert jcp.block_samples == cp.block_samples
        want = np.asarray(JRunner(jcp, prefetch=2).run(n_blocks))
    finally:
        jh.close()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_runner_planes_mode(tmp_path):
    """planes=True ships (re, im) planes through planes_step (the 'pallas'
    engine's streaming form, plain versions here): equal to planes_step
    over the same blocks, and to the complex step at roundoff."""
    data = samples((6 * 4096, 16), np.complex64, 16, seed=11)
    path = str(tmp_path / "planes.vdif")
    freq = (400 + 0.25 * (np.arange(16) // 2)) * pu.MHz
    # frames of 256 divide the 'pallas' block (config 4's rule: the
    # largest power of two dividing it)
    with pvdif.open(path, "w", template=port_template(data, RATE),
                    samples_per_frame=256, nthread=16) as fw:
        fw.write(data)
    fr = pvdif.open(path, sample_rate=pu.Quantity(RATE, pu.Hz),
                    device="cpu")
    with fr:
        ded = pb.Dedisperse(pb.SetAttribute(fr, frequency=freq, sideband=1),
                            0.5, samples_per_frame=2048, engine="pallas")
        assert ded.samples_per_frame % 256 == 0
        cp = PCompiled(pb.Square(ded))
        n_blocks = fr.shape[0] // cp.block_samples - 1
        yr, yi = StreamRunner(cp, planes=True).run(n_blocks)
        assert yi is None
        step, carry = cp.planes_step(), cp.init_carry(planes=True)
        blocks = cp.read_source_blocks(n_blocks)
        want = []
        for k in range(n_blocks):
            carry, (wr, _) = step(carry, blocks[k])
            want.append(wr)
        assert torch.equal(yr, torch.cat(want))
        ref = cp.run_blocks(blocks)
        torch.testing.assert_close(yr, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        # the packed runner of the same file agrees with both
        cpp = PCompiled(pb.Square(ded), packed=True)
        got = StreamRunner(cpp).run(n_blocks)
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_runner_reduction_applied():
    """A Fold tail streams the reduction too: sums and counts as the
    batch run_fn gives them."""
    t0 = PTime("2020-01-01T00:00:00.0")
    src = pb.NoiseGenerator(shape=(16384,), start_time=t0,
                            sample_rate=1 * pu.MHz, samples_per_frame=2048,
                            seed=13, device="cpu")
    f0 = 123.456
    tail = pb.Fold(pb.Square(pb.Channelize(src, 16)), 8,
                   lambda t: pu.Quantity((t - t0).sec * f0, pu.cycle),
                   samples_per_frame=1)
    cp = PCompiled(tail)
    n_blocks = (16384 // 16) // cp.tail_block
    sums_b, counts_b = cp.run_fn(n_blocks)(cp.read_source_blocks(n_blocks))
    sums_s, counts_s = StreamRunner(cp).run(n_blocks)
    assert torch.equal(counts_s, counts_b)
    assert torch.equal(sums_s, sums_b)
    with pytest.raises(ValueError, match="multiple of block_samples"):
        StreamRunner(cp).run(1, offset=1)


def test_runner_reduction_matches_jax(tmp_path):
    """Config 4's chain at a small size: a VDIF file -> Dedisperse ->
    Square -> Integrate, packed and float runners against the JAX
    package's packed runner on the same file."""
    path = write_vdif(tmp_path, 8, shape=(8 * 4096, 16), spf=1024,
                      nthread=16, scale=16)
    freq = 400 + 0.25 * (np.arange(16) // 2)
    out = []
    for pkg, units, compiled, runner, kw in (
            (pb, pu, PCompiled, StreamRunner, {"device": "cpu"}),
            (jb, ju, JCompiled, JRunner, {})):
        fr = pkg.io.vdif.open(path, sample_rate=units.Quantity(RATE,
                                                               units.Hz),
                              **kw)
        ded = pkg.Dedisperse(pkg.SetAttribute(fr, frequency=freq * units.MHz,
                                              sideband=1), 0.5,
                             samples_per_frame=4096, engine="xla")
        tail = pkg.Integrate(pkg.Square(ded), 512)
        cpp = compiled(tail, packed=True)
        cpf = compiled(tail)
        n_blocks = fr.shape[0] // cpp.block_samples - 1
        res = [tuple(np.asarray(a) for a in runner(c).run(n_blocks))
               for c in (cpp, cpf)]
        np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(res[0][1], res[1][1])
        out.append(res[0])
        fr.close()
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_runner_getslice_offset():
    """A compiled GetSlice shifts where the reader starts."""
    src = pb.NoiseGenerator(shape=(8192,),
                            start_time=PTime("2020-01-01T00:00:00.0"),
                            sample_rate=1 * pu.MHz, samples_per_frame=1024,
                            seed=4, device="cpu")
    tail = pb.Square(pb.Channelize(GetSlice(src, slice(128, None)), 64))
    cp = PCompiled(tail)
    assert cp.source_offsets == [128]
    out = StreamRunner(cp).run(3)
    tail.seek(0)
    eager = tail.read(out.shape[0])
    torch.testing.assert_close(out, eager, rtol=1e-5, atol=1e-5)


def test_runner_errors_propagate(tmp_path):
    src = pb.NoiseGenerator(shape=(4096,),
                            start_time=PTime("2020-01-01T00:00:00.0"),
                            sample_rate=1 * pu.MHz, samples_per_frame=1024,
                            seed=2, device="cpu")
    cp = PCompiled(pb.Square(pb.Channelize(src, 64)))
    with pytest.raises(EOFError):
        StreamRunner(cp).run(10_000)  # far beyond the stream
    path = dedisperse_file(tmp_path, n=20000)
    rh, tail = port_runner_chain(path)
    with rh:
        cp = PCompiled(tail)
        with pytest.raises(EOFError):
            StreamRunner(cp).run(100)
    with pytest.raises(ValueError, match="single-source"):
        StreamRunner(PCompiled(pb.Channelize(pb.Stack([src, src]), 16)))


def _reductions(pkg, units, time):
    """Small absorbed reductions of each kind on a source of 16384
    samples at 1 MHz: Integrate by samples, by time (fractional samples
    a bin), by pulse phase (edges from the phase model), Fold and
    PulseStack, in each package."""
    t0 = time("2020-01-01T00:00:00.0")
    kw = {} if pkg is jb else {"device": "cpu"}
    src = pkg.NoiseGenerator(shape=(16384,), start_time=t0,
                             sample_rate=1 * units.MHz,
                             samples_per_frame=2048, seed=13, **kw)
    det = pkg.Square(pkg.Channelize(src, 16))
    f0 = 123.456

    def phase(t):
        return units.Quantity((t - t0).sec * f0, units.cycle)
    return {"samples": pkg.Integrate(det, 7),
            "time": pkg.Integrate(det, 37.3 * units.us),
            "phase": pkg.Integrate(det, 0.25 * units.cycle, phase),
            "fold": pkg.Fold(det, 8, phase, samples_per_frame=1),
            "pulsestack": pkg.PulseStack(det, 4, phase)}


@pytest.mark.parametrize("kind", ["samples", "time", "phase", "fold",
                                  "pulsestack"])
def test_segment_ids_match_jax(kind):
    """The runner's (and run_fn's) segment ids, computed as runs between
    the bin edges, equal the JAX package's binary search per sample, over
    spans that start before the stream, straddle its end and lie past
    it."""
    port = PCompiled(_reductions(pb, pu, PTime)[kind])
    jax_cp = JCompiled(_reductions(jb, ju, JTime)[kind])
    n_tail = 16384 // 16
    for start, n in ((-40, 100), (0, n_tail), (13, 257),
                     (n_tail - 50, 120), (n_tail + 5, 30), (5, 0)):
        got, n_seg = port._segment_ids(start, n)
        want, j_seg = jax_cp._segment_ids(start, n)
        assert n_seg == j_seg
        np.testing.assert_array_equal(got, np.asarray(want))
