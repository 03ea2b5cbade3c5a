"""The port's ShardedPipeline and ``compile(mesh=)`` against the JAX
package's, on the CPU.

Both packages get the same numpy baseband through ``StreamGenerator`` (or
the same file) and build the same chains as
``tests/test_sharded_pipeline.py``: channelize-square, a (time 4, chan 2)
mesh, dedisperse, convolve -> dedisperse -> fold, the match to eager past
the warm-up, the PFB round trip (quad fusion), SK excision, the joins and
``GetSlice`` offsets, ``Integrate`` with ``run_reduced``, the output
layout, the FX correlator, VDIF and HDF5 packed ingest, and the three
refusals.  Each port run is on a one-process mesh of eight CPU shards
and is held to the port's one-device ``CompiledPipeline`` (1e-6), and to
the JAX ``ShardedPipeline`` on the eight virtual CPU devices at the JAX
test's tolerance (1e-6; the padded HDF5 chain 1e-5 / 1e-6); where the two
packages' FFTs differ in roundoff the absolute part is 1e-6 of the peak.
The sharded step runs stage by stage: its pad hook is called once per
padded stage per super-step, with the ``S`` per-shard blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.models.sharded import (  # noqa: E402
    ShardedPipeline as JSharded)
from baseband_tasks_tpu.ops.dft_matmul import (  # noqa: E402
    set_matmul_precision as jprecision)
from baseband_tasks_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models import (  # noqa: E402
    CompiledPipeline as PCompiled, ShardedPipeline as PSharded)
from baseband_tasks_tpu_torch.parallel import make_mesh  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

T0 = "2020-01-01T00:00:00.0"
LIBS = {pb: (pu, PTime), jb: (ju, JTime)}

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


@pytest.fixture(autouse=True)
def _highest():
    with jprecision("highest"):
        yield


def pmesh(time=8, chan=1):
    return make_mesh(time=time, chan=chan, devices=["cpu"] * (time * chan))


def baseband(n, shape=(), seed=3, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n,) + shape)
    return x.astype(dtype)


def source(pkg, data, spf=4096, rate_mhz=1.0):
    """``data`` as a source of package ``pkg`` (the port's on the CPU)."""
    units, time = LIBS[pkg]

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    return pkg.StreamGenerator(frame, data.shape, time(T0),
                               rate_mhz * units.MHz, samples_per_frame=spf,
                               dtype=data.dtype, **kw)


def close(got, want, rtol=1e-6, atol=1e-6, of_peak=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape
    if of_peak:
        atol = atol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def check(build, n_blocks, *, time=8, chan=1, cp_kw=None, blocks=None,
          jax_tol=(1e-6, 1e-5)):
    """``build(pkg)`` -> tail in each package.  The port's sharded run
    equals its one-device run (1e-6) and the JAX sharded run (``jax_tol``
    rtol / atol, the atol of the peak).  Returns the port's pipelines,
    blocks and output."""
    cp_kw = cp_kw or {}
    cp, jcp = PCompiled(build(pb), **cp_kw), JCompiled(build(jb), **cp_kw)
    assert (cp.block_samples, cp.tail_block, cp.delay, cp.warmup) == \
        (jcp.block_samples, jcp.tail_block, jcp.delay, jcp.warmup)
    pblocks = cp.read_source_blocks(n_blocks) if blocks is None \
        else blocks[0]
    jblocks = (jcp.read_source_blocks(n_blocks) if blocks is None
               else blocks[1])
    sp = PSharded(cp, pmesh(time, chan))
    assert sp.n_shards == time
    got, ref = sp.run_blocks(pblocks), cp.run_blocks(pblocks)
    jgot = JSharded(jcp, jmake_mesh(time=time, chan=chan)).run_blocks(
        jblocks)
    pairs = zip(got, ref, jgot) if isinstance(ref, tuple) \
        else [(got, ref, jgot)]
    for g, r, j in pairs:
        close(g, r)
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        else:
            close(g, j, *jax_tol, of_peak=True)
    return cp, sp, pblocks, got


def test_channelize_square():
    data = baseband(1 << 16, seed=3)
    check(lambda pkg: pkg.Square(pkg.Channelize(source(pkg, data), 64)), 8)


def test_time_chan_mesh():
    """A (time 4, chan 2) mesh: the time axis shards blocks, the chan axis
    replicates."""
    data = baseband(1 << 16, seed=5)
    cp, sp, _, _ = check(
        lambda pkg: pkg.Square(pkg.Channelize(source(pkg, data), 64)), 8,
        time=4, chan=2)
    assert sp.n_shards == 4 and len(sp.devices) == 4


def dedisperse(pkg, data, spf=8192, dm=1.0):
    units, _ = LIBS[pkg]
    src = pkg.SetAttribute(source(pkg, data, spf=8192),
                           frequency=600 * units.MHz, sideband=1)
    return pkg.Dedisperse(src, dm, samples_per_frame=spf)


def test_dedisperse():
    data = baseband(1 << 17, seed=7)
    # the padded frame, 8744 = 8 x 1093 samples, takes Bluestein FFTs,
    # whose roundoff differs between the packages: 5e-5 of the peak
    cp, _, _, _ = check(lambda pkg: dedisperse(pkg, data), 16,
                        jax_tol=(1e-6, 5e-5))
    assert cp.stages[-1].padded and cp.stages[-1].pad <= cp.block_samples


def test_convolve_dedisperse_fold():
    """Convolve -> Dedisperse -> Fold from library parts, the fold
    absorbed: sums and counts as one device's and as the JAX package's."""
    data = baseband(1 << 17, seed=11)
    response = np.exp(-np.arange(64) / 16).astype(np.complex64)
    response /= np.abs(response).sum()
    spf, f0 = 8192, 123.456

    def build(pkg):
        units, time = LIBS[pkg]
        t0 = time(T0)
        src = pkg.SetAttribute(source(pkg, data, spf=8192),
                               frequency=600 * units.MHz, sideband=1)
        conv = pkg.Convolve(src, response, samples_per_frame=spf)
        ded = pkg.Dedisperse(conv, 1.0, samples_per_frame=spf)
        phase = lambda t: units.Quantity((t - t0).sec * f0,  # noqa: E731
                                         units.cycle)
        return pkg.Fold(pkg.Square(ded), 16, phase,
                        units.Quantity(spf / 1e6, units.s),
                        samples_per_frame=1, average=False)
    cp, _, _, got = check(build, 16)
    assert cp.reduction is not None and cp.delay > 0
    assert int(got[1].sum()) > 0


def test_dedisperse_matches_eager_past_warmup():
    """Past the warm-up the sharded output is the port's eager stream
    (60 dB), the whole contract and not only sharded == compiled."""
    data = baseband(1 << 17, seed=13)
    tail = dedisperse(pb, data)
    cp = PCompiled(tail)
    got = PSharded(cp, pmesh()).run_blocks(cp.read_source_blocks(8)).numpy()
    w, d = cp.warmup, int(cp.delay)
    tail.seek(0)
    eager = tail.read(got.shape[0] - w).numpy()
    seg = got[w:]
    ref = eager[w - d:w - d + len(seg)]
    err = np.mean(np.abs(seg - ref) ** 2) / np.mean(np.abs(ref) ** 2)
    assert 10 * np.log10(1 / max(err, 1e-30)) >= 60.0


def test_pfb_inverse_round_trip():
    """The PFB -> inverse PFB quad fusion (the DFT pair cancelled, the
    'pallas' streaming stages) sharded over eight shards."""
    h = jb.sinc_hamming(8, 64)
    data = baseband(1 << 18, (2,), seed=9)

    def build(pkg):
        src = source(pkg, data, spf=8192)
        pfb = pkg.PolyphaseFilterBank(src, h, samples_per_frame=416)
        return pkg.InversePolyphaseFilterBank(
            pfb, h, sn=1e3, pad_start=32, pad_end=32, samples_per_frame=352,
            dtype=src.dtype, engine="pallas")
    cp, _, _, _ = check(build, 8, jax_tol=(1e-5, 1e-5))
    fused = [type(st.fused).__name__ for st in cp.stages
             if getattr(st, "fused", None) is not None]
    assert fused == ["_FusedPolyphaseFIR", "_FusedDechanInvPFB"]


def test_sk_excision():
    """Channelize -> SK excision -> Square: the decision grid lands alike
    on every shard, flag for flag."""
    data = baseband(1 << 16, seed=61)

    def build(pkg):
        chan = pkg.Channelize(source(pkg, data), 32)
        return pkg.Square(pkg.ExciseSpectralKurtosis(chan, 64,
                                                     threshold=2.5))
    cp, _, _, got = check(build, 8)
    assert got.shape[0] == 8 * cp.tail_block
    assert (got == 0).any()


def test_combine_streams():
    a, b = baseband(1 << 16, seed=31), baseband(1 << 16, seed=37)
    cp, _, _, _ = check(lambda pkg: pkg.Square(pkg.CombineStreams(
        [source(pkg, a), source(pkg, b)], lambda d: d[0] + d[1])), 8)
    assert len(cp.sources) == 2


def test_getslice_offsets():
    data = baseband(1 << 16, seed=21)
    cp, _, _, _ = check(lambda pkg: pkg.Square(pkg.Channelize(
        source(pkg, data)[128:], 16)), 8)
    assert cp.source_offsets == [128]


def test_integrate_run_reduced():
    data = baseband(1 << 16, seed=7)

    def build(pkg):
        return pkg.Integrate(pkg.Square(pkg.Channelize(source(pkg, data),
                                                       64)), 16)
    cp, sp, blocks, _ = check(build, 8)
    avg, counts = sp.run_reduced(blocks)
    ref_avg, ref_counts = cp.run_reduced(blocks)
    close(avg, ref_avg)
    np.testing.assert_array_equal(counts.numpy(), ref_counts.numpy())
    jcp = JCompiled(build(jb))
    javg, jcounts = JSharded(jcp, jmake_mesh(time=8)).run_reduced(
        jcp.read_source_blocks(8))
    close(avg, javg, of_peak=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_output_layout_and_stage_by_stage_hook():
    """``sharded_step`` returns each shard's block on its shard's device
    (the JAX output lies on all eight devices), and the pad hook runs once
    per padded stage per super-step with the S per-shard blocks."""
    data = baseband(1 << 17, seed=17)
    units = pu
    src = pb.SetAttribute(source(pb, data, spf=8192),
                          frequency=600 * units.MHz, sideband=1)
    tail = pb.Square(pb.Dedisperse(pb.Dedisperse(src, 1.0,
                                                 samples_per_frame=8192),
                                   -0.5, samples_per_frame=8192))
    cp = PCompiled(tail)
    padded = sum(st.padded for st in cp.stages)
    assert padded == 2
    sp = PSharded(cp, pmesh(4))
    calls = []
    make_hook = sp._pad_hook

    def counting():
        hook = make_hook()

        def wrapped(st, c, xs):
            calls.append(len(xs))
            return hook(st, c, xs)
        return wrapped
    sp._pad_hook = counting
    step = sp.sharded_step()
    blocks = cp.read_source_blocks(8)
    carry = cp.init_carry()
    for k in (0, 4):
        carry, ys = step(carry, [blocks[k + i] for i in range(4)])
        assert len(ys) == 4
        for y, dev in zip(ys, sp.devices):
            assert y.device == dev and y.shape[0] == cp.tail_block
    assert calls == [4] * (2 * padded)
    ref = cp.run_blocks(blocks)
    close(torch.cat(ys), ref[4 * cp.tail_block:])
    # carries are copies, never views of a block
    for c in carry:
        assert all(c.untyped_storage().data_ptr()
                   != b.untyped_storage().data_ptr() for b in blocks)


def test_fx_correlator():
    """The FX chain (fractional-delay resample, channelize, stack,
    cross-multiply, absorbed Integrate) over eight shards."""
    data = baseband(1 << 15, seed=4)
    tau = 2.0 / 1e6

    def build(pkg):
        units, time = LIBS[pkg]
        s1 = source(pkg, data)
        s2 = pkg.SetAttribute(source(pkg, data), start_time=time(T0)
                              + units.Quantity(tau, units.s))
        return pkg.models.fx_correlate(
            [s1, s2], 32, 64, delays=[None, units.Quantity(tau, units.s)])
    check(build, 16, jax_tol=(1e-5, 1e-5))


def write_vdif(tmp_path):
    from baseband_tasks_tpu_torch.io import vdif
    data = (baseband(1 << 16, (2,), seed=41) * 16)
    rate = pu.Quantity(1 << 20, pu.Hz)
    path = str(tmp_path / "ps.vdif")
    gen = pb.StreamGenerator(
        lambda sh: data[sh.tell():sh.tell() + sh.samples_per_frame],
        data.shape, PTime(T0), rate, samples_per_frame=8192,
        dtype=data.dtype, device="cpu")
    with vdif.open(path, "w", template=gen, bps=8) as fw:
        fw.write(data)
    return path


def test_vdif_packed(tmp_path):
    """Packed VDIF words shard by block; each shard decodes its own block
    inside the step: equal to the float path on one device and to the JAX
    packed sharded run."""
    path = write_vdif(tmp_path)
    from baseband_tasks_tpu.io import vdif as jvdif
    with pb.io.vdif.open(path, sample_rate=pu.Quantity(1 << 20, pu.Hz),
                         device="cpu") as pr, \
            jvdif.open(path, sample_rate=ju.Quantity(1 << 20, ju.Hz)) as jr:
        readers = {pb: pr, jb: jr}

        def build(pkg):
            return pkg.Integrate(pkg.Square(pkg.Channelize(readers[pkg],
                                                           64)), 16)
        cp_f = PCompiled(build(pb), block_samples=8192)
        ref = cp_f.run_blocks(cp_f.read_source_blocks(8))
        _, _, _, got = check(build, 8, cp_kw=dict(block_samples=8192,
                                                  packed=True))
        for g, r in zip(got, ref):
            close(g, r)


def test_hdf5_packed_sharded_padded_chain(tmp_path):
    """HDF5 8-bit words through a sharded padded chain (Dedisperse ->
    Square) on four shards: equal to the one-device float path (1e-5 /
    1e-6) and to the JAX package's packed sharded run."""
    pytest.importorskip("h5py")
    from baseband_tasks_tpu.io import hdf5 as jhdf5
    from baseband_tasks_tpu_torch.io import hdf5
    data = baseband(1 << 15, (4,), seed=42)
    gen = source(pb, data, spf=4096)
    path = str(tmp_path / "ps.h5")
    with hdf5.open(path, "w", template=gen, bps=8) as fw:
        fw.write(data)
    with hdf5.open(path, device="cpu") as pr, jhdf5.open(path) as jr:
        readers = {pb: pr, jb: jr}

        def build(pkg):
            units, _ = LIBS[pkg]
            freq = (400 + 0.25 * np.arange(4)) * units.MHz
            return pkg.Square(pkg.Dedisperse(
                pkg.SetAttribute(readers[pkg], frequency=freq, sideband=1),
                5.0, samples_per_frame=4096))
        cp_f = PCompiled(build(pb), block_samples=4096)
        ref = cp_f.run_blocks(cp_f.read_source_blocks(4))
        cp, sp, _, got = check(build, 4, time=4,
                               cp_kw=dict(block_samples=4096, packed=True),
                               jax_tol=(1e-5, 1e-6))
        close(got, ref, rtol=1e-5, atol=1e-6)
        assert cp.stages[-2].padded


def test_refusals():
    """The JAX package's three refusals (no such axis, blocks not a
    multiple of the shards, a pad above the per-shard block), and shards
    on another device than the chain's."""
    data = baseband(1 << 16, seed=3)
    cp = PCompiled(pb.Square(pb.Channelize(source(pb, data), 64)))
    with pytest.raises(ValueError, match="no axis"):
        PSharded(cp, pmesh(), axis_name="bogus")
    with pytest.raises(ValueError, match="multiple of"):
        PSharded(cp, pmesh()).run_blocks(cp.read_source_blocks(6))
    with pytest.raises(ValueError, match="chain's device"):
        PSharded(cp, make_mesh(time=2, devices=["cpu", "meta"]))
    tail = dedisperse(pb, baseband(1 << 17, seed=17), spf=1024, dm=30.0)
    cp = PCompiled(tail)
    assert cp.stages[-1].pad > cp.block_samples
    with pytest.raises(ValueError, match="exceeds its per-shard"):
        PSharded(cp, pmesh()).run_blocks(cp.read_source_blocks(8))
    jcp = JCompiled(dedisperse(jb, baseband(1 << 17, seed=17), spf=1024,
                               dm=30.0))
    with pytest.raises(ValueError, match="exceeds its per-shard"):
        JSharded(jcp, jmake_mesh(time=8)).run_blocks(
            np.asarray(jcp.read_source_blocks(8)))


def test_compile_mesh_with_a_remainder():
    """``compile(mesh=, shard_axis=)`` through the view: whole super-steps
    compiled, the remainder (fewer than S blocks) and the warm-up served
    eagerly; equal to the one-device view where both are compiled, to the
    eager chain where the remainder is served, and to the eager chain to
    the overlap-save leakage (60 dB) over the whole stream, a reduction
    tail included."""
    data = baseband(11 * 8192 + 1000, seed=19)
    tail = dedisperse(pb, data)
    view = tail.compile(mesh=pmesh(4), shard_axis="time")
    assert view._S == 4 and view._max_blocks == 8
    assert view.cp.block_samples == 8192
    single = dedisperse(pb, data).compile()
    assert single._max_blocks == 11
    got = view.read()
    hi = 8 * view.cp.tail_block - int(view.cp.delay)
    close(got[:hi], single.read()[:hi])
    tail.seek(0)
    eager = tail.read().numpy()
    np.testing.assert_array_equal(got[hi:].numpy(), eager[hi:])
    err = np.mean(np.abs(got.numpy() - eager) ** 2) / np.mean(
        np.abs(eager) ** 2)
    assert 10 * np.log10(1 / max(err, 1e-30)) >= 60.0
    view.seek(40000)
    part = view.read(30000)
    np.testing.assert_array_equal(part.numpy(), got[40000:70000].numpy())
    f0 = 123.456

    def fold():
        t0 = PTime(T0)
        return pb.Fold(pb.Square(pb.Channelize(source(pb, data[:1 << 16]),
                                               16)), 8,
                       lambda t: pu.Quantity((t - t0).sec * f0, pu.cycle),
                       pu.Quantity(1024 * 16 / 1e6, pu.s),
                       samples_per_frame=1)
    folded = fold().compile(mesh=pmesh(8))
    assert folded.ih._S == 8
    close(folded.read(4), fold().read(4), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no axis"):
        pb.Channelize(source(pb, data), 16).compile(mesh=pmesh(),
                                                    shard_axis="chan2")
