"""The port's compiled pipelines against the JAX package.

Both packages get the same numpy baseband through ``StreamGenerator`` and
compile the same chains at small size: the config-2-like fused
``Dedisperse(engine='pallas') -> Dechannelize`` (8 channels), the PFB
round-trip quad (n = 64 channels x 2 pols, L = 128 lanes, 8 taps), the
forward PFB alone, ``Dechannelize -> InversePolyphaseFilterBank`` (n = 32,
4 taps) and an unfused chain with ``SetAttribute`` and ``GetSlice``.  The
bookkeeping (block, tail block, delay, warmup, source offsets, which
stages fuse or are skipped) must be identical; signals agree to float32
roundoff and are held to 1e-5 of their largest element (PLANE_TOL), with
the JAX package at 'highest' matmul precision and its Pallas kernels in
interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.ops.dft_matmul import (  # noqa: E402
    set_matmul_precision as jprecision)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled, carry_from_numpy)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PLANE_TOL = 1e-5

# the PFB frames of these chains are not 2/3/5-smooth (advisory only, as
# for the JAX package's FrameSizeWarning in the pytest settings)
pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


@pytest.fixture(autouse=True)
def _highest():
    with jprecision("highest"):
        yield


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_TOL * peak)


def sources(n, shape, rate_mhz, seed, freq=None):
    """The same numpy complex baseband as a source of each package
    (labelled with ``freq`` MHz per channel and sideband +1 if given)."""
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((n,) + shape)
            + 1j * rng.standard_normal((n,) + shape)).astype(np.complex64)

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    def make(pkg, units, time):
        gen = pkg.StreamGenerator(frame, data.shape, time.from_mjd(58000.0),
                                  rate_mhz * units.MHz,
                                  samples_per_frame=8192, dtype=data.dtype)
        if freq is None:
            return gen
        return pkg.SetAttribute(gen, frequency=freq * units.MHz, sideband=1)
    return make(pb, pu, PTime), make(jb, ju, JTime)


def dedisperse_dechannelize(pkg, src):
    return pkg.Dechannelize(pkg.Dedisperse(src, 0.5, samples_per_frame=2048,
                                           pad_margin=32, engine="pallas"))


def pfb_quad(pkg, src):
    h = jb.sinc_hamming(8, 64)
    pfb = pkg.PolyphaseFilterBank(src, h, samples_per_frame=416)
    return pkg.InversePolyphaseFilterBank(
        pfb, h, sn=1e3, pad_start=32, pad_end=32, samples_per_frame=352,
        dtype=src.dtype, engine="pallas")


def pfb_forward(pkg, src):
    return pkg.PolyphaseFilterBank(src, jb.sinc_hamming(8, 64),
                                   samples_per_frame=448)


def dechan_inverse(pkg, src):
    h = jb.sinc_hamming(4, 32)
    pfb = pkg.PolyphaseFilterBank(src, h, samples_per_frame=448)
    return pkg.InversePolyphaseFilterBank(
        pfb, h, sn=1e3, pad_start=16, pad_end=16, samples_per_frame=224,
        dtype=src.dtype, engine="pallas")


def unfused(pkg, src):
    """SetAttribute -> GetSlice -> Channelize -> Square: no padded stage,
    a slice folded into the source offset."""
    lab = pkg.SetAttribute(src, frequency=400 * (pu if pkg is pb else ju).MHz,
                           sideband=1)
    return pkg.Square(pkg.Channelize(lab[640:], 32))


# name -> (chain builder, source (n, sample_shape, MHz, seed, freq),
# fused stage class names)
CHAINS = {
    "dedisperse_dechannelize": (
        dedisperse_dechannelize,
        (1 << 14, (8,), 0.25, 3, 400 + (np.arange(8) - 4) * 0.25),
        ["_FusedDisperseDechan"]),
    "pfb_quad": (pfb_quad, (1 << 17, (2,), 1.0, 4, None),
                 ["_FusedPolyphaseFIR", "_FusedDechanInvPFB"]),
    "pfb_forward": (pfb_forward, (1 << 17, (2,), 1.0, 5, None),
                    ["_FusedPFBForward"]),
    "dechan_inverse": (dechan_inverse, (1 << 16, (2,), 1.0, 6, None),
                       ["_FusedDechanInvPFB"]),
    "unfused": (unfused, (1 << 14, (), 1.0, 7, None), []),
}
FUSED = [name for name in CHAINS if name != "unfused"]


def build(name, fuse=True):
    make, (n, shape, rate, seed, freq), _ = CHAINS[name]
    ps, js = sources(n, shape, rate, seed, freq)
    pt, jt = make(pb, ps), make(jb, js)
    return (PCompiled(pt, fuse=fuse), JCompiled(jt, fuse=fuse), pt, jt)


def stage_summary(cp):
    return [(type(st.node).__name__, type(st.fused).__name__
             if st.fused is not None else None, st.skip, st.padded, st.pad,
             tuple(st.in_sample_shape), np.dtype(st.in_dtype))
            for st in cp.stages]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", CHAINS)
def test_bookkeeping(name, fuse):
    pc, jc, pt, jt = build(name, fuse)
    assert (pc.block_samples, pc.tail_block, pc.delay, pc.warmup,
            pc.source_offsets) == (jc.block_samples, jc.tail_block,
                                   jc.delay, jc.warmup, jc.source_offsets)
    assert stage_summary(pc) == stage_summary(jc)
    fused = [type(st.fused).__name__ for st in pc.stages
             if st.fused is not None]
    assert fused == (CHAINS[name][2] if fuse else [])
    assert (pt.shape, pt.samples_per_frame) == (jt.shape,
                                                jt.samples_per_frame)
    for a, b in zip(pc.init_carry(planes=True), jc.init_carry(planes=True)):
        assert tuple(a[0].shape) == b[0].shape
        assert (a[1] is None) == (b[1] is None)


def test_quad_skips_its_pre():
    """The quad's inverse runs without ``pre``, its carry in spectra rows
    (pads 32 + 7 rounded up to the window's N2 = 32 grid: 32 + 64)."""
    pc, jc, _, pt = build("pfb_quad")
    assert pc.stages[3].fused.pre is None
    assert pc.stages[3].pad == jc.stages[3].pad == 96
    assert (pt.pad_start + pt.pad_end) // 64 == 96


@pytest.mark.parametrize("name", CHAINS)
def test_run_blocks(name):
    """run_blocks over three (four for the quad) blocks equals the JAX
    package's compiled scan, warmup included."""
    pc, jc, _, _ = build(name)
    n_blocks = 4 if name == "pfb_quad" else 3
    jblocks = jc.read_source_blocks(n_blocks)
    pblocks = pc.read_source_blocks(n_blocks)
    np.testing.assert_array_equal(pblocks.numpy(), np.asarray(jblocks))
    got = pc.run_blocks(pblocks)
    assert_close(got.numpy(), jc.run_blocks(jblocks))


def planes_outputs(cp, blocks, scales, jax_side, carry=None):
    """Outputs of ``planes_step`` over ``blocks`` with per-block scales,
    as complex numpy."""
    outs = []
    if jax_side:
        step, caches = cp.cached_planes_step()
        carry = cp.init_carry(planes=True) if carry is None else carry
        for x, s in zip(blocks, scales):
            x = np.asarray(x)
            carry, y = step(carry, (jnp.asarray(x.real), jnp.asarray(x.imag)),
                            None if s is None else jnp.float32(s), caches)
            outs.append(np.asarray(y[0]) + 1j * np.asarray(y[1]))
        return outs, carry
    step = cp.planes_step()
    carry = cp.init_carry(planes=True) if carry is None else carry
    for x, s in zip(blocks, scales):
        carry, y = step(carry, x, s)
        outs.append(y[0].numpy() + 1j * y[1].numpy())
    return outs, carry


@pytest.mark.parametrize("name", FUSED)
def test_planes_step_with_scale(name):
    """The planes step with per-block scales (the stream kernels scale
    the block rows only) against the JAX package's."""
    pc, jc, _, _ = build(name)
    scales = [0.5, 2.0, None]
    got, _ = planes_outputs(pc, pc.read_source_blocks(3), scales, False)
    want, _ = planes_outputs(jc, jc.read_source_blocks(3), scales, True)
    for a, b in zip(got, want):
        assert_close(a, b)


@pytest.mark.parametrize("name", ["pfb_quad", "dedisperse_dechannelize"])
def test_stream_scale_block_only(name):
    """A run with per-block scales equals a run over pre-scaled blocks on
    every block: the carry keeps its own iteration's scale."""
    pc, _, _, _ = build(name)
    blocks = pc.read_source_blocks(3)
    scales = [0.5, 2.0, 4.0]
    a, _ = planes_outputs(pc, blocks, scales, False)
    b, _ = planes_outputs(pc, [s * x for s, x in zip(scales, blocks)],
                          [None] * 3, False)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5 *
                                   float(np.abs(y).max()))


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("name", ["pfb_quad", "dedisperse_dechannelize"])
def test_resume_from_jax_carry(name, planes):
    """The JAX step over one block hands its carry to the port, whose
    next step matches the JAX package's next block."""
    pc, jc, _, _ = build(name)
    jblocks = jc.read_source_blocks(2)
    pblocks = pc.read_source_blocks(2)
    if planes:
        _, jcarry = planes_outputs(jc, jblocks[:1], [None], True)
        want, _ = planes_outputs(jc, jblocks[1:], [None], True,
                                 carry=jcarry)
        carry = carry_from_numpy(
            [(np.asarray(c[0]), None if c[1] is None else np.asarray(c[1]))
             for c in jcarry])
        got, _ = planes_outputs(pc, pblocks[1:], [None], False, carry=carry)
        assert_close(got[0], want[0])
        return
    jstep, caches = jc.cached_step()
    jcarry, _ = jstep(jc.init_carry(), jblocks[0], caches)
    _, want = jstep(jcarry, jblocks[1], caches)
    carry = carry_from_numpy([np.asarray(c) for c in jcarry])
    _, got = pc.step_fn()(carry, pblocks[1])
    assert_close(got.numpy(), want)


def test_planes_matches_complex_step():
    pc, _, _, _ = build("pfb_forward")
    blocks = pc.read_source_blocks(2)
    a = pc.run_blocks(blocks).numpy()
    b, _ = planes_outputs(pc, blocks, [None, None], False)
    assert_close(np.concatenate(b), a)


@pytest.mark.parametrize("name", ["pfb_forward", "unfused"])
def test_compile_view_reads_like_eager(name):
    """chain.compile().read(n) == chain.read(n) in the port (the FIR's
    pads hold its whole response, so the compiled windows give the eager
    output to roundoff)."""
    _, _, pt, _ = build(name)
    view = pt.compile()
    assert (view.shape, view.sample_rate, view.dtype) == \
        (pt.shape, pt.sample_rate, pt.dtype)
    assert (view.start_time.jd1, view.start_time.jd2) == \
        (pt.start_time.jd1, pt.start_time.jd2)
    n = min(pt.shape[0], 3 * view.samples_per_frame + 123)
    got = view.read(n)
    pt.seek(0)
    want = pt.read(n)
    assert_close(got.numpy(), want.numpy())
    view.seek(17)
    pt.seek(17)
    m = min(500, pt.shape[0] - 17)
    assert_close(view.read(m).numpy(), pt.read(m).numpy())


def test_compile_view_dedisperse():
    """A chirp chain whose frames do not divide its pads: the view agrees
    with eager to the overlap-save leakage (45.1 dB here, in both
    packages), and the whole read equals the JAX package's view to
    roundoff."""
    _, _, pt, jt = build("dedisperse_dechannelize")
    got = pt.compile().read().numpy()
    pt.seek(0)
    eager = pt.read().numpy()
    err = np.mean(np.abs(got - eager) ** 2) / np.mean(np.abs(eager) ** 2)
    assert 10 * np.log10(1 / err) > 40
    assert_close(got, jt.compile().read())


def test_config2_geometry_eager_gap():
    """At config 2's per-channel geometry (125 kHz channels at 1400 MHz,
    DM 29.7, 2^17-sample frames: a 2^18 window with 512/512 pads, which
    frames do not divide), compiled sample k differs from eager sample
    k - delay by the overlap-save leakage of the chirp past the pads, by
    design ~60 dB down (``Disperse``'s ``pad_margin``).  The port's gap is
    the JAX package's own, sample for sample, on the same input (8 of
    config 2's 128 channels, two blocks); at config 2's output level
    (128 channels: 1/4 of this rms) the JAX package's gap is itself
    outside its ``_compare_eager`` bound (rtol 1e-3, atol 2e-3)."""
    freq = 1400 + (np.arange(0, 128, 16) - 64) * 0.125
    ps, js = sources(1 << 19, (8,), 0.125, 9, freq)
    gaps = []
    for pkg, src, compiled in ((pb, ps, PCompiled), (jb, js, JCompiled)):
        ded = pkg.Dedisperse(src, 29.7, samples_per_frame=1 << 17,
                             engine="pallas")
        tail = pkg.Dechannelize(ded)
        cp = compiled(tail)
        assert (ded.pad_start, ded.pad_end, cp.block_samples) == \
            (512, 512, (1 << 18) - 1024)
        got = np.asarray(cp.run_blocks(cp.read_source_blocks(2)))
        delay, w = int(cp.delay), cp.warmup
        tail.seek(0)
        eager = np.asarray(tail.read(got.shape[0] - delay))
        gaps.append((got[w:] - eager[w - delay:], eager[w - delay:]))
    (gap, eager), (jgap, jeager) = gaps
    assert_close(eager, jeager)
    np.testing.assert_allclose(gap, jgap, rtol=0,
                               atol=PLANE_TOL * float(np.abs(jeager).max()))
    snr = 10 * np.log10(np.mean(np.abs(jeager) ** 2)
                        / np.mean(np.abs(jgap) ** 2))
    assert 58 < snr < 65
    level = 0.125 / np.sqrt(np.mean(np.abs(jeager) ** 2))
    assert (level * np.abs(jgap)
            / (2e-3 + 1e-3 * level * np.abs(jeager))).max() > 1


def test_refusals():
    ps, _ = sources(1 << 12, (2,), 1.0, 8)
    # packed ingest is ported: a source without packed reads is refused
    # with the JAX package's ValueError
    with pytest.raises(ValueError, match="no source supports packed reads"):
        PCompiled(pb.Channelize(ps, 16), packed=True)
    # a reduction after a chain of fractional delay: refused, as in JAX
    ded = pb.Dedisperse(pb.SetAttribute(
        ps, frequency=400 * pu.MHz, sideband=1), 0.5,
        samples_per_frame=2048, pad_margin=32)
    frac = pb.Integrate(pb.Square(pb.Channelize(ded, 64)), 2)
    assert PCompiled(frac).delay.denominator != 1
    with pytest.raises(ValueError, match="fractional-delay"):
        PCompiled(frac).run_reduced(np.zeros((1, 2048, 2), np.complex64))
    # a mesh without the shard axis: the JAX package's ValueError
    from baseband_tasks_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="no axis"):
        pb.Channelize(ps, 16).compile(
            mesh=make_mesh(time=2, devices=["cpu"] * 2), shard_axis="beam")
    with pytest.raises(ValueError, match="no task nodes"):
        PCompiled(ps)

    # a join compiles: one source block per input, as in JAX
    joined = PCompiled(pb.Channelize(pb.Stack([ps, ps]), 16))
    assert len(joined.sources) == 2 and joined.source_offsets == [0, 0]
