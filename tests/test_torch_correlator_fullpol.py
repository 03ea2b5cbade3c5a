"""The port's FX correlator with full polarization products and fringe
stopping per subband, on the CPU.

``CrossMultiply(products='full')`` against a numpy einsum; an array
``lo`` (one sky frequency a subband) against the correlator without
fringe stopping turned by a direct numpy rotation of each station and
subband; the chain with both options eager against compiled; the LOFAR
HBA node's chain (``benchmark/systems/lofar_hba_cobalt.py``) at a small
size against the benchmark's float64 reference of it
(``benchmark/reference/lofar_hba_cobalt.py``) under its limits, and the
reference in bfloat16 outside them; and the defaults as they were:
``products='elementwise'`` and a scalar ``lo`` give the same bits as the
formulas they had."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models import (  # noqa: E402
    CrossMultiply, fx_correlate)
from baseband_tasks_tpu_torch.models import correlator  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline)
from benchmark import harness  # noqa: E402

pu = pb.units
SPEC = harness.load_spec()
SYSTEM = harness.module("systems", "lofar_hba_cobalt")
REF = harness.module("reference", "lofar_hba_cobalt")
START = pb.Time.from_mjd(58000.0)
RATE = 195312.5 * pu.Hz
LO_MHZ = np.array([[120.1171875], [120.3125]])      # two subbands

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def source(data, spf=64, **labels):
    """A stream of ``data`` (time first), read from memory."""
    return pb.StreamGenerator(
        lambda sh: data[sh.tell():sh.tell() + sh.samples_per_frame],
        data.shape, START, RATE, samples_per_frame=spf, dtype=np.complex64,
        device="cpu", **labels)


def stations(n_st=3, n=1024, seed=1):
    """``n_st`` stations of (time, subband, pol): a common signal at
    whole-sample delays 0, 3, 6, ... plus station noise."""
    sky = noise((n + 64, 2, 2), seed)
    return [source(sky[64 - 3 * k:64 - 3 * k + n] + noise((n, 2, 2),
                                                          seed + 1 + k),
                   frequency=LO_MHZ * pu.MHz, sideband=1)
            for k in range(n_st)]


DELAYS = (0.0, 3.4, 5.8)


def correlate(**kw):
    kw.setdefault("delays", [d / RATE for d in DELAYS])
    return fx_correlate(stations(), 8, 16, method="phase",
                        samples_per_frame=64, average=False, **kw)


def test_full_products_match_an_einsum():
    """(time, station, subband, pol) spectra: XX*, XY*, YX*, YY* of every
    baseline i <= j, in that order; the labels of the pairs."""
    x = noise((32, 3, 5, 2), 3)
    src = source(x, polarization=np.array(["X", "Y"]))
    cm = CrossMultiply(src, products="full")
    assert cm.sample_shape == (6, 5, 4)
    assert list(cm.polarization) == ["XX", "XY", "YX", "YY"]
    got = cm.read(32).numpy()
    i, j = np.array(cm.baselines).T
    want = np.einsum("tbsp,tbsq->tbspq", x[:, i], np.conj(x[:, j]))
    np.testing.assert_allclose(got, want.reshape(32, 6, 5, 4), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="trailing polarization axis"):
        CrossMultiply(source(noise((8, 3, 5), 1)), products="full")
    with pytest.raises(ValueError, match="elementwise"):
        CrossMultiply(src, products="cross")
    # a label that differs between the polarizations has no place in
    # the products
    per_pol = source(x, frequency=np.array([1400.0, 1401.0]) * pu.MHz,
                     sideband=1)
    with pytest.raises(ValueError, match="polarizations disagree"):
        CrossMultiply(per_pol, products="full")
    both = source(x, frequency=np.array([1400.0, 1400.0]) * pu.MHz,
                  sideband=np.array([1, 1]))
    assert CrossMultiply(both, products="full").sample_shape == (6, 5, 4)


def test_elementwise_products_as_before():
    """The default is the element by element product, the same bits as
    ``X_i conj(X_j)`` gathered by baseline."""
    x = noise((32, 3, 5, 2), 4)
    data = torch.from_numpy(x)
    bi, bj = torch.tensor([0, 0, 1]), torch.tensor([1, 2, 2])
    for cm in (CrossMultiply(source(x), baselines=[(0, 1), (0, 2), (1, 2)]),
               CrossMultiply(source(x), baselines=[(0, 1), (0, 2), (1, 2)],
                             products="elementwise")):
        assert cm.sample_shape == (3, 5, 2)
        assert torch.equal(cm.read(32), data[:, bi] * torch.conj(data[:, bj]))


def old_phase_rotation(n_chan, tau, lo_hz, d_s, sb=1):
    """The scalar-lo rotation as it was computed: the slope, times the
    fringe term, cast to complex64."""
    ishift = int(round(tau))
    fk = np.fft.fftfreq(n_chan)
    rot = np.exp(2j * np.pi * fk * (tau - ishift))
    rot = rot * np.exp(2j * np.pi * float(lo_hz) * float(d_s) * float(sb))
    return rot.astype(np.complex64)


@pytest.mark.parametrize("tau", [3.4, -2.75, 0.0])
def test_scalar_lo_as_before(tau):
    """A scalar lo gives the bits of the old rotation; an array lo equal
    in every subband gives the same bits in each."""
    s = stations(1)[0]
    d = tau / RATE
    _, rot = correlator._phase_rotation(s, s.start_time, 195312.5, 8, d,
                                        150 * pu.MHz, 64)
    want = old_phase_rotation(8, tau, 150e6, d.to_value(pu.s))
    assert rot.shape == (8, 1, 1)
    assert np.array_equal(rot.ravel(), want)
    _, arr = correlator._phase_rotation(s, s.start_time, 195312.5, 8, d,
                                        np.full((2, 1), 150.0) * pu.MHz, 64)
    assert arr.shape == (8, 2, 1)
    assert np.array_equal(arr[:, 0], rot[:, 0])
    assert np.array_equal(arr[:, 1], rot[:, 0])


def test_per_subband_fringe_stopping():
    """Each station's subband s is turned by exp(2 pi i lo_s d_k): the
    visibilities are those without fringe stopping times exp(2 pi i lo_s
    (d_i - d_j)), to float32 roundoff."""
    lo = LO_MHZ * pu.MHz
    with_lo = correlate(lo=lo, products="full").read(2).data.numpy()
    without = correlate(products="full").read(2).data.numpy()
    tau = np.array(DELAYS) / RATE.to_value(pu.Hz)
    turn = np.exp(2j * np.pi * LO_MHZ[:, 0] * 1e6 * tau[:, None])  # (k, s)
    i, j = np.triu_indices(3)
    want = without * (turn[i] * np.conj(turn[j]))[None, :, None, :, None]
    peak = np.abs(want).max()
    np.testing.assert_allclose(with_lo, want, rtol=0, atol=2e-6 * peak)
    # a phase of ~2e3 cycles: one lo for both subbands is visibly wrong
    one = correlate(lo=120.1171875 * pu.MHz, products="full").read(2)
    assert np.abs(one.data.numpy()[:, :, :, 1] - with_lo[:, :, :, 1]).max() \
        > 0.1 * peak


def test_lo_must_broadcast():
    with pytest.raises(ValueError, match="broadcast"):
        correlate(lo=np.array([120.0, 120.2, 120.4]) * pu.MHz)


@pytest.mark.parametrize("products", ["full", "elementwise"])
def test_compiled_matches_eager(products):
    """The chain with the array lo compiled (one block stack a station,
    the integration absorbed, the first dump after the carries'
    warm-up) gives the eager stream's sums and counts."""
    tail = correlate(lo=LO_MHZ * pu.MHz, products=products, start=1)
    cp = CompiledPipeline(tail, block_samples=64)
    assert (cp.delay, cp.warmup, cp.source_offsets) == (0, 1, [0, 3, 6])
    sums, counts = cp.run_fn(8)(cp.read_source_blocks(8))
    n = int((counts == 16).sum())
    assert n >= 2
    tail.seek(0)
    eager = tail.read(n)
    np.testing.assert_array_equal(counts[:n].numpy(),
                                  eager.count.reshape(n, -1)[:, 0].numpy())
    np.testing.assert_allclose(sums[:n].numpy(), eager.data.numpy(),
                               rtol=0, atol=1e-6 * float(
                                   eager.data.abs().max()))


def small_cfg():
    """The LOFAR node at 4 stations, 2 subbands, 8 channels, dumps of 64
    spectra in blocks of 16, delays of up to 16 samples."""
    cfg = harness.config_of(SPEC, "lofar_hba_cobalt")
    cfg.update(n_station=4, n_subband=2, n_chan=8, n_avg=64,
               block_samples=128, max_delay_samples=16)
    return cfg


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 5])
def test_node_matches_the_reference(seed):
    """The system's compiled chain on a seeded dump: every number of the
    benchmark's comparison within its limit, the dump counting n_avg,
    and the reference computed in bfloat16 (the control) outside one;
    the eager chain over the same dump gives the same sums."""
    cfg = small_cfg()
    traffic = dict(harness.traffic_of("dump_1s"), pool=1, steps_per_call=4)
    feed = SYSTEM.make_feed(cfg, traffic, seed, torch.device("cpu"),
                            harness.Spans())
    sums, counts = feed.unit(0)
    assert sums.shape == (1, 10, 8, 2, 4) and list(counts) == [64]
    data = feed.reference_data()
    ref = REF.expected(cfg, traffic, data, [0], "cpu")[0]
    nums = REF.compare((sums, counts), ref)
    assert set(nums) == set(REF.LIMITS)
    assert all(nums[k] <= REF.LIMITS[k] for k in nums), nums
    low = REF.expected(cfg, traffic, data, [0], "cpu", precision="bfloat16")
    ctl = REF.compare(low[0], ref)
    assert any(ctl[k] > 10 * REF.LIMITS[k] for k in ctl), ctl
    eager = SYSTEM.chain(cfg, data["delays"], "cpu",
                         dump=data["pool"][0]).read(1)
    np.testing.assert_allclose(sums, eager.data.numpy(), rtol=0,
                               atol=1e-6 * float(eager.data.abs().max()))
    # the visibilities are far from zero: a common sky in every station
    i, j = np.triu_indices(4)
    auto = np.abs(sums[0][i == j]).mean()
    assert np.abs(sums[0][i != j][..., [0, 3]]).mean() > 0.2 * auto
    feed.close()


def test_node_geometry_at_full_size():
    """The deployment's chain compiles to the geometry the feed lays its
    blocks out for: no delay, one spectrum of warm-up, each station read
    from its whole-sample delay; one dump of 3072 spectra a run of 49
    blocks."""
    cfg = harness.config_of(SPEC, "lofar_hba_cobalt")
    d = SYSTEM.delays(cfg, 2 ** 31 + 77)
    t = time.perf_counter()
    cp = SYSTEM.compiled(cfg, d, "cpu")
    assert time.perf_counter() - t < 30
    assert cp.block_samples == 4096 and cp.tail_block == 64
    assert cp.reduction.shape == (1, 1953, 64, 30, 4)
    assert SYSTEM.dump_blocks(cfg) == (48, 49)
    assert SYSTEM.station_samples(cfg) == 49 * 4096 + 64
    ids, n_seg = cp.segment_ids_np(49)
    assert n_seg == 1 and (ids == 0).sum() == 3072
