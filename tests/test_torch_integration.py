"""The port's integration tasks and absorbed reduction against the JAX
package.

Both packages get the same numpy data through ``StreamGenerator`` and
integrate it the same way: ``Integrate`` in steps of samples, of time and
of pulse phase, ``Fold`` and ``PulseStack`` on the same phase model (a
Quantity of cycles, or the packages' two-double ``Phase``), averaged or as
sums and counts, with ``start``, and with ``masked=True`` on data with NaN
cells and fully flagged cells.  Then ``CompiledPipeline.run_reduced``,
``run_fn`` and ``compile()`` with a reduction tail, and BASELINE config 1
(Channelize(256) -> Square -> Integrate(16)) at a small size.

Bars: sums and averages at rtol 1e-5 (float32 sums of positive data in
another order); counts and NaN cells exact.  The data are positive (power,
or noise offset by 3), so no sum sits near zero.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.phases import Phase as JPhase  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.integration import (  # noqa: E402
    Integrated, is_index)
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.phases import Phase as PPhase  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

RTOL = 1e-5
MJD = 58000.0
# package -> (module, units, Time, Phase)
PKGS = {"port": (pb, pu, PTime, PPhase), "jax": (jb, ju, JTime, JPhase)}


def sources(data, rate_hz, spf):
    """The same numpy data as a source of each package (the port's on
    the CPU): {"port": ..., "jax": ...}."""
    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]

    out = {}
    for key, (pkg, units, time, _) in PKGS.items():
        extra = dict(device="cpu") if key == "port" else {}
        out[key] = pkg.StreamGenerator(
            frame, data.shape, time.from_mjd(MJD), rate_hz * units.Hz,
            samples_per_frame=spf, dtype=data.dtype, **extra)
    return out


def positive(n, shape, seed, nan=None):
    """float32 noise offset by 3; ``nan`` is a list of index expressions
    set to NaN."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n,) + shape).astype(np.float32) + 3.0
    for idx in nan or ():
        data[idx] = np.nan
    return data


def complex_noise(n, shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape)
            + 1j * rng.standard_normal((n,) + shape)).astype(np.complex64)


def phase_model(key, f0, phi0=0.05, two_double=False):
    """Linear pulse phase f0 (t - t0) + phi0 in the package's units, as
    a Quantity of cycles or, with ``two_double``, the package's Phase."""
    _, units, time, phase = PKGS[key]
    t0 = time.from_mjd(MJD)
    if two_double:
        return lambda t: phase((t - t0).sec * f0 + phi0)
    return lambda t: units.Quantity((t - t0).sec * f0 + phi0, units.cycle)


def to_numpy(x):
    if isinstance(x, Integrated):
        return np.asarray(x)
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(got, want, rtol=RTOL):
    """A port result against the JAX package's: counts and NaN cells
    exact, sums or averages at ``rtol``."""
    if isinstance(got, Integrated):
        assert got.data.shape == got.count.shape == want.shape
        np.testing.assert_array_equal(got.count.numpy(), want["count"])
        got, want = got.data.numpy(), want["data"]
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def both(build, data, rate_hz, spf):
    """``build(key, source)`` on each package's source: {key: node}."""
    src = sources(data, rate_hz, spf)
    return {key: build(key, src[key]) for key in PKGS}


def read_both(nodes, count=None):
    out = {}
    for key, node in nodes.items():
        node.seek(0)
        out[key] = node.read(count)
    return out["port"], out["jax"]


# -- eager -----------------------------------------------------------------

INTEGRATE_CASES = {
    "samples": dict(step=100),
    "samples_no_average": dict(step=100, average=False),
    "time": dict(step=("s", 0.0375)),          # 37.5 samples per bin
    "time_no_average": dict(step=("s", 0.0375), average=False),
    "whole_stream": dict(),
    "start_int": dict(step=64, start=130),
    "start_time": dict(step=64, start=("s", 0.2)),
    "frames_of_three": dict(step=50, samples_per_frame=3, average=False),
}


@pytest.mark.parametrize("case", list(INTEGRATE_CASES))
def test_integrate_matches_jax(case):
    kw = dict(INTEGRATE_CASES[case])
    data = positive(1000, (3,), seed=1)

    def build(key, src):
        pkg, units, time, _ = PKGS[key]
        args = dict(kw)
        if isinstance(args.get("step"), tuple):
            args["step"] = units.Quantity(args["step"][1], units.s)
        if isinstance(args.get("start"), tuple):
            args["start"] = time.from_mjd(MJD) + units.Quantity(
                args["start"][1], units.s)
        return pkg.Integrate(src, **args)

    nodes = both(build, data, 1000, 100)
    p, j = nodes["port"], nodes["jax"]
    assert p.shape == j.shape
    assert p.dtype == j.dtype if kw.get("average", True) else \
        p.dtype.names == j.dtype.names
    assert float(p.sample_rate.to_value(pu.Hz)) == \
        float(j.sample_rate.to_value(ju.Hz))
    np.testing.assert_allclose(p.start_time.mjd, j.start_time.mjd,
                               rtol=0, atol=1e-12)
    assert_same(*read_both(nodes))


def test_integrate_complex_stream():
    data = complex_noise(2048, (2,), seed=2) + np.complex64(3 + 3j)
    nodes = both(lambda key, src: PKGS[key][0].Integrate(src, 128),
                 data, 1000, 256)
    got, want = read_both(nodes)
    assert got.dtype == torch.complex64
    assert_same(got, want)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("two_double", [False, True])
def test_integrate_phase_steps_matches_jax(average, two_double):
    data = positive(4000, (2,), seed=3)

    def build(key, src):
        pkg, units, _, _ = PKGS[key]
        return pkg.Integrate(src, units.Quantity(0.5, units.cycle),
                             phase_model(key, 7.3, two_double=two_double),
                             average=average, samples_per_frame=2)

    nodes = both(build, data, 1000, 500)
    assert nodes["port"].shape == nodes["jax"].shape
    assert_same(*read_both(nodes))
    # the bin times come from the phase -> offset inversion
    for n in (0, 3, nodes["port"].shape[0]):
        assert nodes["port"]._tell_time(n).mjd == \
            pytest.approx(nodes["jax"]._tell_time(n).mjd, abs=1e-12)


FOLD_CASES = {
    "whole_stream": dict(),
    "time_step": dict(step=0.5),
    "time_step_no_average": dict(step=0.5, average=False),
    "short_step": dict(step=0.05, average=False),
    "start": dict(step=0.5, start=250),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
@pytest.mark.parametrize("two_double", [False, True])
def test_fold_matches_jax(case, two_double):
    kw = dict(FOLD_CASES[case])
    data = positive(4000, (2,), seed=4)

    def build(key, src):
        pkg, units, _, _ = PKGS[key]
        args = dict(kw)
        if "step" in args:
            args["step"] = units.Quantity(args["step"], units.s)
        return pkg.Fold(src, 16, phase_model(key, 9.7, two_double=two_double),
                        samples_per_frame=1, **args)

    nodes = both(build, data, 1000, 400)
    assert nodes["port"].shape == nodes["jax"].shape
    assert nodes["port"].n_phase == 16
    assert_same(*read_both(nodes))


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("start", [0, 37])
def test_pulsestack_matches_jax(average, start):
    data = positive(3000, (2,), seed=5)

    def build(key, src):
        return PKGS[key][0].PulseStack(src, 8, phase_model(key, 12.5),
                                       start=start, average=average,
                                       samples_per_frame=2)

    nodes = both(build, data, 1000, 300)
    p, j = nodes["port"], nodes["jax"]
    assert p.shape == j.shape and p.n_phase == 8
    # one output sample per pulse: the rate in pulses per cycle
    assert float(p.sample_rate.value) == pytest.approx(
        float(j.sample_rate.value), rel=1e-15)
    assert str(p.sample_rate.unit) == str(j.sample_rate.unit)
    got, want = read_both(nodes)
    assert_same(got, want)
    # a slice of the output is the same pulses
    p.seek(1)
    j.seek(1)
    assert_same(p.read(2), j.read(2))


def test_stack_is_a_deprecated_pulsestack():
    data = positive(1000, (), seed=6)
    src = sources(data, 1000, 100)["port"]
    with pytest.warns(DeprecationWarning, match="PulseStack"):
        st = pb.integration.Stack(src, 4, phase_model("port", 20.0))
    assert isinstance(st, pb.PulseStack)
    assert is_index(3) and not is_index(3.0)


# -- masked ------------------------------------------------------------------

# data[0:1000, 1] flagged in its first half frame by frame; channel 2
# fully flagged; scattered single NaN samples
NAN_CELLS = [(slice(0, 4000, 2), 1), (slice(None), 2), (17, 0), (1234, 3),
             (3999, 0)]


@pytest.mark.parametrize("average", [True, False])
def test_integrate_masked_matches_jax(average):
    data = positive(4000, (4,), seed=7, nan=NAN_CELLS)
    nodes = both(lambda key, src: PKGS[key][0].Integrate(
        src, 1000, masked=True, average=average), data, 1000, 500)
    got, want = read_both(nodes)
    assert_same(got, want)
    if average:
        # the fully flagged channel averages to NaN, the others do not
        assert torch.isnan(got[:, 2]).all()
        assert torch.isfinite(got[:, [0, 1, 3]]).all()
    else:
        assert (got.count[:, 2] == 0).all() and (got.data[:, 2] == 0).all()
        assert (got.count[:, 1] == 500).all()


@pytest.mark.parametrize("average", [True, False])
def test_fold_masked_matches_jax(average):
    data = positive(4000, (4,), seed=8, nan=NAN_CELLS)

    def build(key, src):
        units = PKGS[key][1]
        return PKGS[key][0].Fold(src, 8, phase_model(key, 31.3),
                                 units.Quantity(1.0, units.s), masked=True,
                                 average=average)

    nodes = both(build, data, 1000, 500)
    got, want = read_both(nodes)
    assert_same(got, want)
    if average:
        assert torch.isnan(got[..., 2]).all()
        assert torch.isfinite(got[..., 0]).all()


def test_unmasked_nan_propagates():
    data = positive(4000, (4,), seed=9, nan=NAN_CELLS)
    nodes = both(lambda key, src: PKGS[key][0].Integrate(src, 500), data,
                 1000, 500)
    got, want = read_both(nodes)
    assert_same(got, want)
    assert torch.isnan(got[:, 2]).all()


def test_integrate_errors_match_jax():
    data = positive(1000, (), seed=10)
    src = sources(data, 1000, 100)
    for key, (pkg, units, time, _) in PKGS.items():
        s = src[key]
        with pytest.raises(ValueError, match="not within"):
            pkg.Integrate(s, 10, start=1001)
        with pytest.raises(ValueError, match="cannot step"):
            pkg.Integrate(s, units.Quantity(1.0, units.m))
        with pytest.raises(ValueError, match="requires a phase"):
            pkg.Integrate(s, units.Quantity(1.0, units.cycle))
        with pytest.raises(ValueError, match="explicit step"):
            pkg.Integrate(s, phase=phase_model(key, 1.0))
        with pytest.raises(ValueError, match="PulseStack"):
            pkg.Fold(s, 4, phase_model(key, 1.0),
                     units.Quantity(1.0, units.cycle))
        with pytest.raises(ValueError, match="too short"):
            pkg.Integrate(s, 10, start=1000)


def test_integrated_structure():
    data = positive(600, (2,), seed=11)
    nodes = both(lambda key, src: PKGS[key][0].Fold(
        src, 4, phase_model(key, 5.0), PKGS[key][1].Quantity(0.2,
                                                             PKGS[key][1].s),
        average=False), data, 1000, 200)
    got, want = read_both(nodes)
    assert isinstance(got, Integrated)
    assert got.shape == want.shape == (3, 4, 2)
    assert got["data"] is got.data and got["count"] is got.count
    assert got.count.dtype == torch.int64
    host = np.asarray(got)
    assert host.dtype.names == want.dtype.names
    np.testing.assert_array_equal(host["count"], want["count"])
    np.testing.assert_allclose(host["data"], want["data"], rtol=RTOL)
    assert_same(got[1:], want[1:])
    assert len(got) == 3


# -- compiled -----------------------------------------------------------------

def compiled_both(build, data, rate_hz, spf, **kw):
    """The reduction chain of each package, compiled: {key: (tail, cp)}."""
    nodes = both(build, data, rate_hz, spf)
    return {key: (tail, (PCompiled if key == "port" else JCompiled)(
        tail, **kw)) for key, tail in nodes.items()}


def chain_power(key, src, n):
    pkg = PKGS[key][0]
    return pkg.Square(pkg.Channelize(src, n))


def check_reduced(cps, n_blocks, eager_rows=None):
    """run_reduced of each package on its own source blocks, the port's
    against the JAX package's and against its own eager read."""
    outs = {}
    for key, (tail, cp) in cps.items():
        assert cp.reduction is tail
        outs[key] = cp.run_reduced(cp.read_source_blocks(n_blocks))
    (pd, pc), (jd, jc) = outs["port"], outs["jax"]
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert_same(pd, np.asarray(jd))
    tail = cps["port"][0]
    tail.seek(0)
    n = pd.shape[0] if eager_rows is None else eager_rows
    assert_same(pd[:n], tail.read(n).numpy())
    return pd, pc


def test_absorbed_integrate_matches_jax():
    data = complex_noise(16384, (), seed=12)
    cps = compiled_both(lambda key, src: PKGS[key][0].Integrate(
        chain_power(key, src, 64), 16), data, 1e6, 4096)
    cp = cps["port"][1]
    assert cp.delay == 0 and cp.tail_block == cps["jax"][1].tail_block
    _, counts = check_reduced(cps, 16384 // cp.block_samples)
    assert (counts == 16).all()


def test_absorbed_integrate_sums_and_cache():
    data = complex_noise(16384, (), seed=13)
    cps = compiled_both(lambda key, src: PKGS[key][0].Integrate(
        chain_power(key, src, 32), 8, average=False), data, 1e6, 4096)
    (tail, cp), (_, jcp) = cps["port"], cps["jax"]
    n_blocks = 16384 // cp.block_samples
    assert cp.run_fn(n_blocks) is cp.run_fn(n_blocks)
    sums, counts = cp.run_fn(n_blocks)(cp.read_source_blocks(n_blocks))
    jsums, jcounts = jcp.run_fn(n_blocks)(jcp.read_source_blocks(n_blocks))
    assert_same(sums, np.asarray(jsums))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    tail.seek(0)
    eager = tail.read(sums.shape[0])
    assert_same(Integrated(sums, counts[:, None].expand(sums.shape)), eager)


@pytest.mark.parametrize("two_double", [False, True])
def test_absorbed_fold_matches_jax(two_double):
    data = complex_noise(16384, (), seed=14)
    cps = compiled_both(lambda key, src: PKGS[key][0].Fold(
        chain_power(key, src, 16), 8,
        phase_model(key, 123.456, two_double=two_double),
        samples_per_frame=1), data, 1e6, 4096)
    _, counts = check_reduced(cps, (16384 // 16) // cps["port"][1].tail_block)
    assert int(counts.sum()) == 16384 // 16


def test_absorbed_pulsestack_matches_jax():
    data = complex_noise(16384, (), seed=15)
    cps = compiled_both(lambda key, src: PKGS[key][0].PulseStack(
        chain_power(key, src, 16), 8, phase_model(key, 123.456),
        samples_per_frame=1), data, 1e6, 4096)
    cp = cps["port"][1]
    tail = cps["port"][0]
    n_blocks = (16384 // 16) // cp.tail_block
    check_reduced(cps, n_blocks, eager_rows=tail.shape[0])


def test_absorbed_phase_integrate_matches_jax():
    data = complex_noise(16384, (), seed=16)
    cps = compiled_both(lambda key, src: PKGS[key][0].Integrate(
        chain_power(key, src, 16), PKGS[key][1].Quantity(2.0, PKGS[key][1]
                                                         .cycle),
        phase_model(key, 11.5), samples_per_frame=1), data, 1000, 2048)
    check_reduced(cps, (16384 // 16) // cps["port"][1].tail_block,
                  eager_rows=cps["port"][0].shape[0])


def test_absorbed_masked_fold_matches_jax():
    # channel 3 fully flagged: its cells average to NaN; scattered NaN
    # samples drop out of their cells only
    data = positive(1 << 14, (4,), seed=17,
                    nan=[(slice(None), 3), (100, 0), (5000, 1), (9999, 2)])

    def build(key, src):
        pkg, units, _, _ = PKGS[key]
        return pkg.Fold(pkg.Square(src), 8, phase_model(key, 12345.6),
                        units.Quantity(4096 / 1e6, units.s),
                        samples_per_frame=1, masked=True)

    cps = compiled_both(build, data, 1e6, 4096, block_samples=4096)
    avg, counts = check_reduced(cps, 4)
    assert counts.shape == (4, 8, 4)
    assert torch.isnan(avg[..., 3]).all()
    assert torch.isfinite(avg[..., :3]).all()
    assert int(counts[..., 0].sum()) == (1 << 14) - 1


@pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")
def test_absorbed_fold_after_padded_stage():
    """Dedisperse with its frame equal to its pads: integral delay; the
    compiled fold bins past the warmup match the eager fold."""
    n = 1 << 16
    data = complex_noise(n, (), seed=18)

    def build(key, src):
        pkg, units, _, _ = PKGS[key]
        lab = pkg.SetAttribute(src, frequency=600 * units.MHz, sideband=1)
        probe = pkg.Dedisperse(lab, 1.0)
        pad = probe.pad_start + probe.pad_end
        ded = pkg.Dedisperse(lab, 1.0, samples_per_frame=pad)
        return pkg.Fold(pkg.Square(ded), 8, phase_model(key, 123.456),
                        units.Quantity(pad / 1e6, units.s),
                        samples_per_frame=1, average=False)

    cps = compiled_both(build, data, 1e6, 8192)
    (tail, cp), (_, jcp) = cps["port"], cps["jax"]
    assert cp.delay == jcp.delay == cp.block_samples
    n_blocks = 6
    sums, counts = cp.run_fn(n_blocks)(cp.read_source_blocks(n_blocks))
    jsums, jcounts = jcp.run_fn(n_blocks)(jcp.read_source_blocks(n_blocks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-4)
    # the first n_blocks - 1 time bins are complete
    tail.seek(0)
    eager = tail.read(n_blocks - 1)
    np.testing.assert_array_equal(counts[:n_blocks - 1].numpy(),
                                  eager.count.numpy())
    np.testing.assert_allclose(sums[:n_blocks - 1].numpy(),
                               eager.data.numpy(), rtol=1e-4)


@pytest.mark.parametrize("average", [True, False])
def test_compile_with_reduction_tail(average):
    data = complex_noise(1 << 15, (), seed=19)
    nodes = both(lambda key, src: PKGS[key][0].Integrate(
        chain_power(key, src, 64), 16, average=average,
        samples_per_frame=4), data, 1e6, 4096)
    views = {key: node.compile() for key, node in nodes.items()}
    view = views["port"]
    assert isinstance(view, pb.Integrate) and view is not nodes["port"]
    assert type(view.ih).__name__ == "CompiledStreamView"
    assert view.shape == nodes["port"].shape
    got, want = read_both(views)
    assert_same(got, want)
    assert_same(got, read_both(nodes)[0] if average else
                np.asarray(read_both(nodes)[0]))


def test_config1_small():
    """BASELINE config 1, Channelize(256) -> Square -> Integrate(16), on
    2^16 complex samples: eager and compiled in both packages."""
    data = complex_noise(1 << 16, (), seed=7)
    nodes = both(lambda key, src: PKGS[key][0].Integrate(
        chain_power(key, src, 256), 16), data, 16e6, 1 << 13)
    got, want = read_both(nodes)
    assert tuple(got.shape) == (16, 256)
    assert_same(got, want)
    cps = {key: (tail, (PCompiled if key == "port" else JCompiled)(
        tail, block_samples=1 << 14)) for key, tail in nodes.items()}
    avg, counts = check_reduced(cps, 4)
    assert (counts == 16).all()
    assert_same(avg, got.numpy())


def test_reduction_refusals():
    data = complex_noise(4096, (), seed=20)
    src = sources(data, 1e6, 1024)["port"]
    with pytest.raises(ValueError, match="no reduction"):
        PCompiled(chain_power("port", src, 16)).run_reduced(
            np.zeros((1, 16), np.complex64))
    with pytest.raises(ValueError, match="no task nodes"):
        PCompiled(pb.Integrate(src, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert PCompiled(pb.Integrate(chain_power("port", src, 16), 4)
                         ).reduction is not None
