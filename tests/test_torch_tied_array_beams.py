"""The port's tied-array beams (TABs) and their coherent Stokes I, on the
CPU.

``BeamformStations(..., tabs=True, stokes='I')`` and ``tied_array_beam(...,
beam_delays=..., stokes='I')``: the LOTAAS node's chain
(``benchmark/systems/lofar_lotaas_tabs.py``) at a small size (3 fields,
5 TABs, 2 subbands, 16 channels, 3 blocks), eager and compiled, against
the benchmark's float64 reference of it
(``benchmark/reference/lofar_lotaas_tabs.py``) under its limits, and the
reference in bfloat16 outside them; one TAB of uniform weights against
the JAX package's ``tied_array_beam``, eager and compiled; a source at
a TAB's delays peaking in that TAB; the TAB weights against their
formula; the product in float32 where the process allows TF32; the
spans, the compiled form query, the labels and the refusals; and the
weight forms of the JAX package, (n_st,) and (n_st, n_chan), giving the
same bits as the sum they always were."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu.models as jmodels  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import units as ju  # noqa: E402
import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.models import (  # noqa: E402
    BeamformStations, beamform, fx_correlate, tied_array_beam)
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline)
from baseband_tasks_tpu_torch.models.correlator import (  # noqa: E402
    _aligned_spectra, _phase_rotation)
from benchmark import harness  # noqa: E402

pu = pb.units
SPEC = harness.load_spec()
SYSTEM = harness.module("systems", "lofar_lotaas_tabs")
REF = harness.module("reference", "lofar_lotaas_tabs")
START = "2018-01-01T00:00:00.000000000"
RATE = 195312.5
LO_MHZ = np.array([[120.1171875], [120.3125]])      # two subbands

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def source(data, spf=64, **labels):
    """A port stream of ``data`` (time first), read from memory."""
    return pb.StreamGenerator(
        lambda sh: data[sh.tell():sh.tell() + sh.samples_per_frame],
        data.shape, PTime(START), RATE * pu.Hz, samples_per_frame=spf,
        dtype=np.complex64, device="cpu", **labels)


def small_cfg():
    """The LOTAAS node at 3 fields, 5 TABs, 2 subbands and 16 channels:
    units of 2 blocks of 192 samples (24 spectra, 4 Stokes rows) and the
    lead block."""
    cfg = harness.config_of(SPEC, "lofar_lotaas_tabs")
    cfg.update(n_station=3, n_tab=5, n_subband=2, block_samples=192,
               cobalt_block_samples=384)
    return cfg


def small_feed(seed):
    cfg = small_cfg()
    traffic = dict(harness.traffic_of("stokes_1s"), pool=1,
                   steps_per_call=2)
    return cfg, traffic, SYSTEM.make_feed(cfg, traffic, seed,
                                          torch.device("cpu"),
                                          harness.Spans())


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 5])
@pytest.mark.parametrize("path", ["compiled", "eager"])
def test_tabs_stokes_match_the_reference(seed, path):
    """The node's TAB Stokes I sums on a seeded block, compiled (the
    system's ``run_fn``) and eager (the same chain read as a stream):
    every number of the benchmark's comparison within its limit, each row
    counting 6 spectra, and the reference in bfloat16 (the control) more
    than 10x outside one."""
    cfg, traffic, feed = small_feed(seed)
    assert SYSTEM.unit_blocks(cfg) == (2, 3) and SYSTEM.rows(cfg) == 4
    data = feed.reference_data()
    if path == "compiled":
        sums, counts = feed.unit(0)
    else:
        eager = SYSTEM.chain(cfg, data["delays"], data["tabs"], "cpu",
                             dump=data["pool"][0]).read(4)
        sums = eager.data.numpy()
        counts = eager.count.reshape(4, -1)[:, 0].numpy()
    assert sums.shape == (4, 5, 16, 2) and list(counts) == [6] * 4
    ref = REF.expected(cfg, traffic, data, [0], "cpu")[0]
    nums = REF.compare((sums, counts), ref)
    assert set(nums) == set(REF.LIMITS)
    assert all(nums[k] <= REF.LIMITS[k] / 10 for k in nums), nums
    low = REF.expected(cfg, traffic, data, [0], "cpu", precision="bfloat16")
    ctl = REF.compare(low[0], ref)
    assert any(ctl[k] > 10 * REF.LIMITS[k] for k in ctl), ctl
    # TAB 0 points at the SAP centre, where the common sky adds in phase:
    # it holds more power than the TABs around it
    power = sums.mean(axis=(0, 2, 3))
    assert power[0] > power[1:].max()
    feed.close()


def test_eager_and_compiled_agree():
    """The compiled run's sums are the eager stream's, to float32
    roundoff."""
    cfg, _, feed = small_feed(11)
    data = feed.reference_data()
    sums, counts = feed.unit(0)
    eager = SYSTEM.chain(cfg, data["delays"], data["tabs"], "cpu",
                         dump=data["pool"][0]).read(4)
    np.testing.assert_array_equal(counts,
                                  eager.count.reshape(4, -1)[:, 0].numpy())
    np.testing.assert_allclose(sums, eager.data.numpy(), rtol=1e-5,
                               atol=1e-6 * float(eager.data.max()))
    feed.close()


def test_node_geometry_at_full_size():
    """The deployment's chain compiles to the geometry the feed lays its
    blocks out for: no delay, a spectrum of warm-up at most, each field
    read from its whole-sample delay, the TABs in their products form;
    a COBALT block is 8 blocks of 24,576 samples run as 9 and gives 2048
    rows of 6 spectra."""
    cfg = harness.config_of(SPEC, "lofar_lotaas_tabs")
    seed = 2 ** 31 + 77
    d, tau = SYSTEM.cobalt.delays(cfg, seed), SYSTEM.tab_delays(cfg, seed)
    assert tau.shape == (73, 12) and not tau[0].any()
    # Superterp fields within 175 m, TABs within 2 degrees: |tau| < 21 ns
    assert 0 < np.abs(tau).max() < 175 * np.sin(np.radians(2)) / 2.998e8
    t = time.perf_counter()
    cp = SYSTEM.compiled(cfg, d, tau, "cpu")
    assert time.perf_counter() - t < 30
    assert cp.block_samples == 24576 and cp.tail_block == 1536
    assert cp.reduction.shape == (2048, 73, 16, 61)
    assert cp.bf_form == "products" and cp.x_form == "products"
    assert SYSTEM.unit_blocks(cfg) == (8, 9)
    ids, n_seg = cp.segment_ids_np(9)
    assert n_seg == 2048
    assert (np.bincount(ids.ravel(), minlength=n_seg + 1)[:-1] == 6).all()


# -- against the JAX package ------------------------------------------------

def series(seed, n=1 << 13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def station(side, data, delay=0.0):
    """``data`` recorded by a station whose clock labels it ``delay``
    samples late (1 MHz), in the port (``pb``) or the JAX package."""
    if side is pb:
        time_, units = PTime, pu
    else:
        time_, units = JTime, ju

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    s = side.StreamGenerator(frame, data.shape, time_(START), 1 * units.MHz,
                             samples_per_frame=2048, dtype=data.dtype)
    return side.SetAttribute(s, start_time=time_(START)
                             + delay / (1 * units.MHz))


def stations(side):
    return [station(side, series(3) + 0.5 * series(10 + k), 3.25 * k)
            for k in range(4)]


def delays(units):
    return [None] + [3.25 * k / (1 * units.MHz) for k in range(1, 4)]


def port_one_tab():
    stacked = _aligned_spectra(stations(pb), 16, delays=delays(pu),
                               lo=None, samples_per_frame=2048,
                               method="phase")
    return BeamformStations(stacked, np.full((1, 4), 0.25), tabs=True)


def test_one_tab_of_uniform_weights_is_the_jax_beam():
    """One TAB of uniform weights (the TAB axis of 1 leading the output)
    is the JAX package's default coherent beam over the same four
    delayed stations, eagerly and compiled."""
    port = port_one_tab()
    jax = jmodels.tied_array_beam(stations(jb), 16, delays=delays(ju),
                                  method="phase", samples_per_frame=2048)
    assert port.sample_shape == (1, 16) and port.n_tab == 1
    got = port.read(256).numpy()
    want = np.asarray(jax.read(256))
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got[:, 0], want, rtol=0, atol=1e-5 * peak)
    pc = CompiledPipeline(port_one_tab(), block_samples=2048)
    jc = JCompiled(jmodels.tied_array_beam(
        stations(jb), 16, delays=delays(ju), method="phase",
        samples_per_frame=2048), block_samples=2048)
    assert (pc.delay, pc.warmup, pc.source_offsets) == \
        (jc.delay, jc.warmup, jc.source_offsets)
    got = pc.run_blocks(pc.read_source_blocks(3)).numpy()
    want = np.asarray(jc.run_blocks(jc.read_source_blocks(3)))
    np.testing.assert_allclose(got[:, 0], want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


# -- steering, the weights and the float32 product ---------------------------

TAU = np.array([[0.0, 0.0, 0.0, 0.0],
                [0.0, 6e-9, -4e-9, 9e-9],
                [0.0, -8e-9, 5e-9, 2e-9],
                [0.0, 3e-9, 11e-9, -7e-9],
                [0.0, -12e-9, -3e-9, 6e-9]])


def steered(source_tab, n=4096, seed=21):
    """Four fields of (time, subband, pol) holding a common sky arriving
    at the delays of TAB ``source_tab`` (its phase at each subband's sky
    frequency: the delays are far below a sample) over weaker field
    noise."""
    sky = noise((n, 2, 2), seed)
    tau = TAU[source_tab]
    return [source(sky * np.exp(-2j * np.pi * LO_MHZ * 1e6 * tau[k])
                   .astype(np.complex64)
                   + 0.3 * noise((n, 2, 2), seed + 1 + k), spf=256,
                   frequency=LO_MHZ * pu.MHz, sideband=1)
            for k in range(4)]


@pytest.mark.parametrize("j", [1, 3])
def test_source_at_a_tabs_delays_peaks_in_it(j):
    """A source at TAB j's geometric delays adds in phase in TAB j: its
    Stokes I is the largest of the five TABs in every channel and
    subband, near the source's full power."""
    beams = tied_array_beam(steered(j), 16, samples_per_frame=256,
                            beam_delays=TAU * pu.s, stokes="I")
    assert beams.sample_shape == (5, 16, 2) and beams.dtype == np.float32
    power = beams.read(128).numpy().mean(0)             # (tab, chan, sb)
    assert (power.argmax(0) == j).all()
    # the sky's 2 x 16 per spectrum in each polarization, plus the
    # fields' noise averaged down by 4
    assert 0.9 < power[j].mean() / (2 * 2 * 16 * (1 + 0.09 / 4)) < 1.1


def test_tab_weights_formula():
    """``tab_weights``: exp(+2 pi i f tau sideband) / n_station at each
    channel's sky frequency, the sign of the correlator's fringe
    stopping for the same delay; constant axes kept as length 1."""
    chan = np.fft.fftfreq(16) * RATE
    f = (LO_MHZ.T * 1e6 + chan[:, None])[..., None]      # (16, 2, 1)
    freq = np.broadcast_to(f, (16, 2, 2)) * pu.Hz
    w = beamform.tab_weights(freq, np.int8(1), TAU * pu.s, 4)
    assert w.shape == (5, 4, 16, 2, 1) and w.dtype == np.complex64
    want = np.exp(2j * np.pi * f[None, None] * TAU[:, :, None, None, None])
    np.testing.assert_allclose(w, want / 4, rtol=0, atol=1e-7)
    lower = beamform.tab_weights(freq, np.int8(-1), TAU * pu.s, 4)
    np.testing.assert_allclose(lower, np.conj(w), rtol=0, atol=1e-7)
    s = source(noise((256, 2, 2), 1), frequency=LO_MHZ * pu.MHz,
               sideband=1)
    d = 9e-9 * pu.s
    _, rot = _phase_rotation(s, s.start_time, RATE, 16, d,
                             LO_MHZ * pu.MHz, 256)
    one = beamform.tab_weights(LO_MHZ * pu.MHz, 1, np.array([[9e-9]]) * pu.s,
                               1)
    np.testing.assert_allclose(one[0, 0, :, 0], rot[0, :, 0], rtol=0,
                               atol=1e-6)


def test_tab_product_runs_in_float32(monkeypatch):
    """Where the process allows TF32 for its products, the TAB product
    runs with it off, and the process's setting is back after it."""
    flags = []
    matmul = torch.matmul

    def spy(*args):
        flags.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    beams = tied_array_beam(steered(2), 16, samples_per_frame=256,
                            beam_delays=TAU * pu.s, stokes="I")
    beams.read(64)
    assert flags and not any(flags)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_coherent_tabs_and_their_stokes():
    """Without ``stokes`` the TABs are complex beams, (tab, chan, sb,
    pol); their |B_X|^2 + |B_Y|^2 is the Stokes I output; TAB b is the
    sum over the fields of its weights times their spectra."""
    fields = steered(1)
    coherent = tied_array_beam(fields, 16, samples_per_frame=256,
                               beam_delays=TAU * pu.s)
    assert coherent.sample_shape == (5, 16, 2, 2)
    b = coherent.read(64)
    stokes = tied_array_beam(steered(1), 16, samples_per_frame=256,
                             beam_delays=TAU * pu.s, stokes="I").read(64)
    np.testing.assert_allclose(stokes.numpy(),
                               (b.abs() ** 2).sum(-1).numpy(), rtol=1e-5)
    stacked = _aligned_spectra(steered(1), 16, delays=None, lo=None,
                               samples_per_frame=256, method="phase")
    x = stacked.read(64)
    w = torch.as_tensor(coherent._w).permute(2, 3, 0, 1)   # (b, k, c, s)
    want = torch.einsum("bkcs,tkcsp->tbcsp", w.to(torch.complex128),
                        x.to(torch.complex128))
    np.testing.assert_allclose(b.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("stokes", [None, "I"])
@pytest.mark.parametrize("shape", [(5, 4), (5, 4, 16), (5, 4, 1, 2),
                                   (5, 4, 16, 2, 2)])
def test_tab_weights_of_any_broadcasting_shape(shape, stokes):
    """TAB weights varying along none, some or all of the axes after the
    stations (the polarization axis too) give each TAB's weighted sum
    over the stations, and its Stokes I."""
    stacked = _aligned_spectra(steered(1, n=1024), 16, delays=None, lo=None,
                               samples_per_frame=256, method="phase")
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    beams = BeamformStations(stacked, w, tabs=True, stokes=stokes)
    assert beams.sample_shape == (5, 16, 2) + ((2,) if stokes is None
                                               else ())
    got = beams.read(32)
    stacked.seek(0)
    x = stacked.read(32).to(torch.complex128)
    full = torch.as_tensor(w.reshape(shape + (1,) * (5 - len(shape))))
    want = torch.einsum("bkcsp,tkcsp->tbcsp", full.to(torch.complex128)
                        .expand(5, 4, 16, 2, 2), x)
    if stokes:
        want = (want.abs() ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_existing_weight_forms_keep_their_bits():
    """(n_st,) and (n_st, n_chan) weights, coherent and incoherent, give
    the bits of ``sum(x * w, dim=1)`` they always gave."""
    stacked = _aligned_spectra([source(noise((1024, 2, 2), 30 + k))
                                for k in range(3)], 16, delays=None, lo=None,
                               samples_per_frame=64, method="phase")
    x = stacked.read(32)
    rng = np.random.default_rng(4)
    per_station = (rng.standard_normal(3)
                   + 1j * rng.standard_normal(3)).astype(np.complex64)
    per_chan = (rng.standard_normal((3, 16))
                + 1j * rng.standard_normal((3, 16))).astype(np.complex64)
    real = rng.uniform(0.1, 1.0, 3).astype(np.float32)
    for w, mode, shaped in (
            (None, "coherent", np.full(3, 1 / 3, np.complex64)[:, None,
                                                                None, None]),
            (per_station, "coherent", per_station[:, None, None, None]),
            (per_chan, "coherent", per_chan[..., None, None]),
            (real, "incoherent", real[:, None, None, None])):
        beam = BeamformStations(stacked, w, mode=mode)
        stacked.seek(0)
        got = beam.read(32)
        y = x if mode == "coherent" else x.real ** 2 + x.imag ** 2
        want = torch.sum(y * torch.as_tensor(shaped)[None], dim=1)
        assert beam.sample_shape == (16, 2, 2)
        assert torch.equal(got, want)
    # Stokes I of the one beam: its power summed over the polarizations
    beam = BeamformStations(stacked, per_station, stokes="I")
    stacked.seek(0)
    b = torch.sum(x * torch.as_tensor(per_station[:, None, None, None])[None],
                  dim=1)
    assert torch.equal(beam.read(32), (b.real ** 2 + b.imag ** 2).sum(-1))


# -- the compiled path, spans, labels, refusals ------------------------------

def test_spans_and_the_form_query():
    """``beamformer.weights`` around the weights' build; in a traced
    ``run_fn`` one ``beamformer.bf`` inside each ``compiled.block``;
    ``bf_form`` is 'products' for a TAB tail and None for a correlator or
    a one-beam tail."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tail = pb.Integrate(tied_array_beam(
            steered(1, n=2048), 16, samples_per_frame=256,
            beam_delays=TAU * pu.s, stokes="I"), 4, average=False)
        cp = CompiledPipeline(tail, block_samples=256)
        cp.run_fn(4)(cp.read_source_blocks(4))
    names = [e.name for e in prof.events()]
    assert names.count("beamformer.weights") == 1
    assert names.count("compiled.block") == 4
    assert names.count("beamformer.bf") == 4
    assert cp.bf_form == "products"
    one = CompiledPipeline(tied_array_beam(steered(1, n=2048), 16,
                                           samples_per_frame=256),
                           block_samples=256)
    assert one.bf_form is None
    corr = CompiledPipeline(fx_correlate(
        steered(1, n=2048), 16, 4, samples_per_frame=256, method="phase"),
        block_samples=256)
    assert corr.bf_form is None


def test_labels():
    """The fields' labels as one field carries them: each channel's sky
    frequency (n_chan, n_subband) on the Stokes I TABs, polarization
    'I'; the complex TABs keep the polarization names."""
    fields = [source(noise((1024, 2, 2), 40 + k), spf=256,
                     frequency=LO_MHZ * pu.MHz, sideband=1,
                     polarization=np.array(["X", "Y"])) for k in range(3)]
    tau = TAU[:2, :3] * pu.s
    beams = tied_array_beam(fields, 16, samples_per_frame=256,
                            beam_delays=tau, stokes="I")
    chan = np.fft.fftfreq(16) * RATE
    np.testing.assert_allclose(beams.frequency.to_value(pu.Hz),
                               LO_MHZ.T * 1e6 + chan[:, None])
    assert str(beams.polarization) == "I"
    coherent = tied_array_beam(fields, 16, samples_per_frame=256,
                               beam_delays=tau)
    assert list(np.asarray(coherent.polarization).ravel()[-2:]) == ["X", "Y"]


def test_refusals():
    fields = steered(1, n=1024)
    stacked = _aligned_spectra(fields, 16, delays=None, lo=None,
                               samples_per_frame=256, method="phase")
    with pytest.raises(ValueError, match="TABs' weights"):
        BeamformStations(stacked, tabs=True)
    with pytest.raises(ValueError, match="TABs and the 4 stations"):
        BeamformStations(stacked, np.ones((5, 3)), tabs=True)
    for shape in ((5, 4, 3), (5, 4, 16, 2, 2, 1), (5, 4, 1, 16)):
        with pytest.raises(ValueError, match="broadcast"):
            BeamformStations(stacked, np.ones(shape), tabs=True)
    with pytest.raises(ValueError, match="coherent beams"):
        BeamformStations(stacked, np.ones((5, 4)), tabs=True,
                         mode="incoherent")
    with pytest.raises(ValueError, match="must be None or 'I'"):
        BeamformStations(stacked, stokes="Q")
    one_pol = _aligned_spectra([source(noise((1024, 3), k), spf=256)
                                for k in range(2)], 16, delays=None,
                               lo=None, samples_per_frame=256,
                               method="phase")
    with pytest.raises(ValueError, match="polarization axis of 2"):
        BeamformStations(one_pol, stokes="I")
    with pytest.raises(ValueError, match="not both"):
        tied_array_beam(fields, 16, weights=np.ones(4),
                        beam_delays=TAU * pu.s)
    with pytest.raises(ValueError, match=r"\(n_tab, 4\)"):
        tied_array_beam(fields, 16, beam_delays=TAU[:, :3] * pu.s)
    with pytest.raises(ValueError, match="frequency and sideband"):
        tied_array_beam([source(noise((1024, 2, 2), k)) for k in range(4)],
                        16, beam_delays=TAU * pu.s)
