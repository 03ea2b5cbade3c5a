"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; without a device they skip.
On a GPU machine (which need not have jax) run them with

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \
        --noconftest -o filterwarnings=error

They cover what the smoke (``chip_smoke.py``) does not: every bit
depth, the float32 twin, small and lopsided windows, a fold whose
partial profile does not fit shared memory (K3's gather form),
the four-step passes (k1_window, k2_fwd, k2_inv, k3_trim) at 8, 16 and
128 lanes and windows of 2^9 to 2^18 with and without pads, the FFT
engine and the dispersion tasks on the card, ShiftAndResample's kernel
path (eager and compiled, with an LO), the wrappers' refusals,
the forward-PFB kernel (n_tap 2, 8, 9, with and without its DFT and a
scale), the streaming stage A (with and without the ``pre`` mix) and
k3_trim with the ``post`` mix (L 128 and 512, pads 0 and not), lane_mix
at ragged shapes, and lane_mix and bank_power (3xTF32 on the tensor
cores) against float64 products at 1e-5 of the peak, and the
compiled fusions on the card, and the flagship's variants (the
full-Stokes fold k3_fold_stokes, k3_power, k2_theta, k1_planes,
k1_stream_planes, and the pipeline's step_fn, step_bins_fn and planes
step on the kernels, against the plain versions and the torch.fft path),
the bf16 passes (K1p, K1f, K2 with a float32 or a bf16 chirp, K3 power
and Stokes) and the split ops in bf16 mode, K3's four launch names on
one- and two-lane tiles and the flagship's column (the register FFT's
compiled shape), accel_corr's used-lane entry (seg_len 2 to 4096, 1 to
128 lanes, rows padded to whole sectors), their refusals (mixed y/z
dtypes, strided or misaligned bf16 planes), the absorbed reduction
(masked fold, config 1) on the card, and the mesh: the halo_remote
kernel against its plain copies on virtual shards of one card (any
dtype, several rings a launch), its refusals, the sharded flagship
('remote' against 'ppermute', launches counted) and the sharded
searches on one card, and the peer reads between two cards (skipped
with fewer than two); stored baseband: ``StreamRunner``'s three modes
(packed, float, planes) from a VDIF file against ``run_fn`` on the card
and on the plain versions, a source on the card passed through, the
pinned ring waiting for a slot's copy before refilling it, and the
filter passes at config 4's 16 lanes; the slice beyond the reference:
the FRB chain ('pallas' Disperse on one lane, launches counted) and its
DM-trial search against the plain versions and the CPU, DeFaraday's
planes form in a compiled chain behind a 'pallas' Dedisperse, and the
Faraday, polarization, SK, RM-synthesis and secondary-spectrum code on
CUDA tensors against the CPU; the sharded config-2 step on four virtual
shards of the card against one device (launches and output), the
HDF5 and PSRFITS readers handing out CUDA tensors, and two processes on
the one card through the multi-process transport (gloo, host-staged) and
with ``halo='remote'`` across them (the halo_remote push form through
CUDA IPC, its stream flags, a 64-exchange stress; a card each where
there are two); the GUPPI entry: guppi_repack bit for bit against its
plain version, K3 Stokes at 2048 bins on the deployment's 2^18 window
(its form asserted) and the entry's call under the sync check; K3's
gather form at 1024 to 8192 bins, power and Stokes, against the plain
version over the bin map's edge cases, and bit for bit from call to
call; host-fed calls: both entries on pinned host blocks return while
the compute stream is held (they wait for their copies alone, in one
``mesh.copy_wait`` after the steps) and match a device-block call, and
``shard`` keeps ``.to()``'s blocks and contract for pinned, pageable and
non-contiguous inputs; the LOTAAS beamformer: one block of the cell's
widths (12 fields, 73 TABs, 16 channels, 61 subbands) against the
float64 reference in a process that allows TF32 (the product run with it
off), the same block with the product's inputs rounded to TF32 failing
the cell's limit, and the spans its metrics read.
Tolerances as in ``chip_smoke.py``: planes
to 1e-4 of their largest element (float32 FFT roundoff is ~1e-6 of it),
profiles elementwise to rtol 2e-4 (atomic summation order), counts
exact.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import fft as ff  # noqa: E402
from baseband_tasks_tpu_torch.ops import pfb as opfb  # noqa: E402
from baseband_tasks_tpu_torch.ops import spectral_filter as sf  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

pytestmark = pytest.mark.cuda

FFT_TOL, PROFILE_RTOL = 1e-4, 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_num_threads(1)
    return torch.device("cuda", 0)


def inputs(dev, t_main, p0, p1, L, bits, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    per = 32 // bits
    words = [torch.randint(0, 256, (t_main // per, L, 4), generator=g,
                           dtype=torch.uint8, device=dev
                           ).view(torch.int32)[..., 0].contiguous()
             for _ in range(2)]
    planes = [torch.randn((t_main, L), generator=g, device=dev)
              for _ in range(2)]
    edges = [torch.randn((n, L), generator=g, device=dev)
             for n in (p0, p0, p1, p1)]
    scale = torch.tensor([0.75], device=dev)
    return words, planes, edges, scale


def assert_planes(got, ref):
    torch.cuda.synchronize()
    peak = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= FFT_TOL * peak, (err, peak)


# (t_main, pad_start, pad_end, L): flagship-like, small, lopsided N2 > N1
GEOMS = [(896, 32, 96, 128), (4096 - 512, 256, 256, 16),
         ((1 << 20) - 8192, 4096, 4096, 16)]
# and the columns the register K1 is compiled for at its 16-lane tile:
# the flagship's N1 = 512 (pads 3584/4608), 256 and 128 (config 3's
# stream), and N1 = 512 on an 8-lane tile (the general kernel)
K1_GEOMS = GEOMS + [((1 << 18) - 8192, 3584, 4608, 128),
                    ((1 << 16) - 512, 256, 256, 32),
                    ((1 << 14) - 256, 128, 128, 16),
                    ((1 << 18) - 8192, 3584, 4608, 8)]


def k1_form_of(n, L, name="k1_float"):
    """The form K1 launch ``name`` must run on an n-row window: the
    register kernel compiled for its column at the 16-lane tile (N1 512,
    and 256, 128 for float32 planes), else the general one."""
    n1 = dd.split_n(n)[0]
    compiled = (128, 256, 512) if name == "k1_float" else (512,)
    want = "register" if n1 in compiled and L % 16 == 0 else "general"
    assert dd.k1_form(n1, L, name) == want
    return want


def _packed_geom(n, L, bits):
    """(t_main, pad_start, pad_end, L) of an n-row window, pads 7 and 9
    columns (the flagship's 3584/4608 at N2 = 512), the end pad grown
    until the main rows divide by 32 / bits."""
    n1, n2 = dd.split_n(n)
    kf, ke = 7, 9
    while (n1 - kf - ke) % (32 // bits):
        ke += 1
    return n - (kf + ke) * n2, kf * n2, ke * n2, L


@pytest.mark.parametrize("n", [1 << 12, 1 << 18])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_k1_packed(dev, bits, n):
    # the main rows must divide by 32/bits: a 4096-window, 64 x 64 (the
    # general kernel), and the flagship's 512 x 512 (compiled)
    t_main, p0, p1, L = ((2048, 1024, 1024, 32) if n == 1 << 12
                         else _packed_geom(n, 32, bits))
    k1_form_of(n, L, "k1_packed")
    words, _, edges, scale = inputs(dev, t_main, p0, p1, L, bits)
    got = dd.stage_a_packed(*words, *edges, scale, bits=bits)
    ref = dd.stage_a_packed_ref(*words, *edges, scale, bits=bits)
    assert_planes(got, ref)


def test_k1_packed_custom_levels(dev):
    words, _, edges, scale = inputs(dev, 512, 256, 256, 128, 2, seed=1)
    levels = (-7.0, -2.0, 2.0, 7.0)
    got = dd.stage_a_packed(*words, *edges, scale, bits=2, levels=levels)
    ref = dd.stage_a_packed_ref(*words, *edges, scale, bits=2,
                                levels=levels)
    assert_planes(got, ref)


@pytest.mark.parametrize("geom", K1_GEOMS)
def test_k1_float_and_k2(dev, geom):
    t_main, p0, p1, L = geom
    k1_form_of(t_main + p0 + p1, L)
    _, planes, edges, scale = inputs(dev, t_main, p0, p1, L, 8, seed=2)
    y = dd.stage_a(*planes, *edges, scale)
    yref = dd.stage_a_ref(*planes, *edges, scale)
    assert_planes(y, yref)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ph = torch.rand(yref[0].shape, generator=g, device=dev) * 6.283
    chirp = (torch.cos(ph), torch.sin(ph))
    z = dd.stage_b(*[p.clone() for p in yref], *chirp)
    zref = dd.stage_b_ref(*[p.clone() for p in yref], *chirp)
    assert_planes(z, zref)


@pytest.mark.parametrize("n_phase", [8, 64, 32768])
@pytest.mark.parametrize("geom", GEOMS[:2])
def test_k3_fold(dev, geom, n_phase):
    t_main, p0, p1, L = geom
    n = t_main + p0 + p1
    n1, n2 = dd.split_n(n)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    z = [torch.randn((n2, n1, L), generator=g, device=dev)
         for _ in range(2)]
    for rate in (1.0 / 97.0, 1 - 1e-8):
        fold = torch.as_tensor(dd.fold_phase_vector(0.3, rate), device=dev)
        prof, cnt = dd.detect_fold(*z, fold, n_phase=n_phase, pad_start=p0,
                                   n_valid=t_main)
        rprof, rcnt = dd.fold_ref(*z, fold, n_phase=n_phase, pad_start=p0,
                                  n_valid=t_main)
        assert torch.equal(cnt, rcnt)
        hit = rcnt > 0
        rel = ((prof - rprof).abs()[hit] / rprof.abs()[hit]).max()
        assert float(rel) <= PROFILE_RTOL
        assert not prof[~hit].any()


def test_public_entry_matches_cpu(dev):
    """dedisperse_fold_split_packed on the card (kernels) against the
    same call on the CPU (plain versions)."""
    rng = np.random.default_rng(5)
    t_main, p0, p1, L = 896, 32, 96, 128
    fields = [rng.integers(0, 256, (t_main, L), dtype=np.uint8)
              for _ in range(2)]
    words = [unpack.pack_time_planes(f, 8) for f in fields]
    edges = [rng.standard_normal((n, L)).astype(np.float32)
             for n in (p0, p0, p1, p1)]
    n1, n2 = dd.split_n(1024)
    ph = rng.uniform(0, 1, (n2, n1, L))
    chirp = [f(2 * np.pi * ph).astype(np.float32) for f in (np.cos, np.sin)]
    fold = dd.fold_phase_vector(0.1, 1.0 / 97.0)
    scale = np.float32([1 / 64.0])
    kw = dict(n_phase=8, pad_start=p0, n_valid=t_main)
    dd.reset_launch_counts()
    got = dd.dedisperse_fold_split_packed(*(w.to(dev) for w in words),
                                          *edges, *chirp, fold, scale, **kw)
    assert dd.launch_counts == dict(dict.fromkeys(dd.launch_counts, 0),
                                    k1_packed=1, k2=1, k3_fold=1)
    ref = dd.dedisperse_fold_split_packed(*words, *edges, *chirp, fold,
                                          scale, **kw)
    assert torch.equal(got[1].cpu(), ref[1])
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=PROFILE_RTOL,
                               atol=0.0)


def test_pipeline_kernels_match_plain(dev):
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    kw = dict(n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
              block_samples=1024, device=dev)
    kern = bt.WidebandPulsarPipeline(use_kernels=True, **kw)
    for bits in (8, None):
        prof, cnt = kern.run_fn(3, ingest_bits=bits)(seed=1)
        with dd.plain_versions():
            rprof, rcnt = kern.run_fn(3, ingest_bits=bits)(seed=1)
        assert torch.equal(cnt, rcnt)
        assert int(cnt.sum()) == 3 * kern.global_block
        torch.testing.assert_close(prof, rprof, rtol=PROFILE_RTOL, atol=0.0)


# the profiler's own notice on starting a trace without a schedule
@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
def test_pipeline_kernel_call_spans_nest(dev, tmp_path):
    import json
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.utils import profiling
    u = bt.units
    kern = bt.WidebandPulsarPipeline(
        n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
        block_samples=1024, device=dev, use_kernels=True)
    run = kern.run_fn(2, ingest_bits=8)
    shape = (kern.global_block // 4, kern.n_chan, kern.n_pol)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    words = tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                dtype=torch.uint8, device=dev).view(
        torch.int32).reshape(shape) for _ in range(2))
    run(blocks=words)
    with profiling.trace(str(tmp_path / "t")):
        run(blocks=words)
    with open(tmp_path / "t" / "trace.json") as f:
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    # the two planes of words are sharded one by one
    assert sorted(n for n, _, _ in spans) == [
        "mesh.shard", "mesh.shard", "wideband.call", "wideband.prep",
        "wideband.step", "wideband.step"]
    by = {n: (a, b) for n, a, b in spans}
    c0, c1 = by["wideband.call"]
    assert all(c0 <= a and b <= c1 for _, a, b in spans)
    shards = sorted(b for n, _, b in spans if n == "mesh.shard")
    steps = sorted((a, b) for n, a, b in spans if n == "wideband.step")
    assert shards[-1] <= by["wideband.prep"][0]
    assert by["wideband.prep"][1] <= steps[0][0]
    assert steps[0][1] <= steps[1][0]


# torch's notice on entering its sync debug mode
@pytest.mark.filterwarnings(
    "ignore:Synchronization debug mode is a prototype:UserWarning")
@pytest.mark.parametrize("period", [(512, 1), (4099, 2)])
def test_pipeline_call_does_not_sync(dev, period):
    """After a first call, a call of ``run_fn(1)`` on device blocks, and
    one on its cached seeded block, waits for nothing on the device,
    launches K1p, K2 and K3 once each and repeats the first calls'
    counts (profiles to the fold's atomic order)."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    kern = bt.WidebandPulsarPipeline(
        n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=period, n_phase=8,
        block_samples=1024, device=dev, use_kernels=True)
    run = kern.run_fn(1, offset0=3 * kern.global_block, ingest_bits=8)
    shape = (kern.global_block // 4, kern.n_chan, kern.n_pol)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    words = tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                dtype=torch.uint8, device=dev).view(
        torch.int32).reshape(shape) for _ in range(2))
    first = run(blocks=words), run(seed=5)
    torch.cuda.synchronize()
    got, counts = [], []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for kw in (dict(blocks=words), dict(seed=5)):
            dd.reset_launch_counts()
            got.append(run(**kw))
            counts.append(dict(dd.launch_counts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = dict(dict.fromkeys(dd.launch_counts, 0), k1_packed=1, k2=1,
                k3_fold=1)
    assert counts == [want, want]
    for a, b in zip(first, got):
        # K3 sums in atomic order: the same samples, another order
        assert torch.equal(a[1], b[1])
        torch.testing.assert_close(b[0], a[0], rtol=PROFILE_RTOL, atol=0.0)
    assert int(got[0][1].sum()) == kern.global_block


def _guppi_words(dev, n_chan, t, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n_chan, t, 4), generator=g,
                         dtype=torch.uint8, device=dev).view(
        torch.int32).reshape(n_chan, t)


@pytest.mark.filterwarnings(
    "ignore:Synchronization debug mode is a prototype:UserWarning")
def test_guppi_call_does_not_sync(dev):
    """The GUPPI entry (``ingest_layout='guppi'``, full Stokes at 2048
    bins): after a first call, a call on device words and one on the
    cached seeded block wait for nothing on the device; the words' call
    launches guppi_repack, K1p, K2 and K3 Stokes (its gather form) once
    each, the seeded one (its planes cached) the last three; both repeat
    the first calls' outputs (bins 0 .. n_phase-1 bit for bit), and the
    words' call matches the plain versions."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    kern = bt.WidebandPulsarPipeline(
        n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(4099, 2), n_phase=2048,
        block_samples=4096, device=dev, use_kernels=True, detect="stokes",
        ingest_layout="guppi")
    run = kern.run_fn(1, offset0=3 * kern.global_block, ingest_bits=8)
    words = _guppi_words(dev, kern.n_chan, kern.global_block, 6)
    first = run(blocks=words), run(seed=5)
    torch.cuda.synchronize()
    got, counts = [], []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for kw in (dict(blocks=words), dict(seed=5)):
            dd.reset_launch_counts()
            got.append(run(**kw))
            counts.append(dict(dd.launch_counts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = dict(dict.fromkeys(dd.launch_counts, 0), k1_packed=1, k2=1,
                k3_fold_stokes=1, k3_fold_gather=1)
    assert counts == [dict(want, guppi_repack=1), want]
    for a, b in zip(first, got):
        # the gather form sums each bin in a fixed order
        assert torch.equal(a[1], b[1]) and torch.equal(a[0][:-1], b[0][:-1])
        torch.testing.assert_close(b[0], a[0], rtol=PROFILE_RTOL,
                                   atol=FFT_TOL * float(a[0].abs().max()))
    with dd.plain_versions():
        prof, cnt = kern.run_fn(1, offset0=3 * kern.global_block,
                                ingest_bits=8)(blocks=words)
    assert torch.equal(cnt, got[0][1])
    hit = cnt > 0
    power, rpower = got[0][0][hit][..., :2], prof[hit][..., :2]
    assert float(((power - rpower).abs() / rpower).max()) <= PROFILE_RTOL
    assert_planes((got[0][0][..., 2:],), (prof[..., 2:],))


def _small_entry(dev, layout):
    """A small flagship (plane-packed words) or GUPPI entry, its
    ``run_fn(1)``, one input block on the card, and the launches a call
    on it makes."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    kw = dict(n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, device=dev, use_kernels=True)
    want = dict.fromkeys(dd.launch_counts, 0)
    if layout == "guppi":
        kern = bt.WidebandPulsarPipeline(
            period_samples=(4099, 2), n_phase=2048, block_samples=4096,
            detect="stokes", ingest_layout="guppi", **kw)
        words = _guppi_words(dev, kern.n_chan, kern.global_block, 6)
        want.update(guppi_repack=1, k1_packed=1, k2=1, k3_fold_stokes=1,
                    k3_fold_gather=1)
    else:
        kern = bt.WidebandPulsarPipeline(
            period_samples=(512, 1), n_phase=8, block_samples=1024, **kw)
        shape = (kern.global_block // 4, kern.n_chan, kern.n_pol)
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        words = tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                    dtype=torch.uint8, device=dev).view(
            torch.int32).reshape(shape) for _ in range(2))
        want.update(k1_packed=1, k2=1, k3_fold=1)
    run = kern.run_fn(1, offset0=3 * kern.global_block, ingest_bits=8)
    return run, words, want


def _pinned(words):
    if isinstance(words, tuple):
        return tuple(w.cpu().pin_memory() for w in words)
    return words.cpu().pin_memory()


@pytest.mark.parametrize("layout", ["planes", "guppi"])
def test_pinned_call_waits_only_for_its_copies(dev, layout):
    """A call on blocks in pinned host memory returns while the compute
    stream is still held behind earlier work (it waits for its copies,
    which run on the copy stream, not for the kernels); the blocks may be
    overwritten as soon as it returns, and once the card has run it the
    output is a device-block call's: counts bit for bit, the profile to
    the fold's atomic order, the same launches once each."""
    run, words, want = _small_entry(dev, layout)
    host = _pinned(words)
    ref = run(blocks=words)
    run(blocks=host)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 31)          # ~1 s of the compute stream
    held = torch.cuda.Event()
    held.record()
    dd.reset_launch_counts()
    got = run(blocks=host)
    counts = dict(dd.launch_counts)
    assert not held.query(), "the call waited for the compute stream"
    for h in (host if isinstance(host, tuple) else (host,)):
        h.zero_()
    torch.cuda.synchronize()
    assert counts == want
    assert torch.equal(got[1], ref[1])
    atol = FFT_TOL * float(ref[0].abs().max()) if layout == "guppi" else 0.0
    torch.testing.assert_close(got[0], ref[0], rtol=PROFILE_RTOL, atol=atol)


# the profiler's own notice on starting a trace without a schedule
@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
@pytest.mark.parametrize("layout", ["planes", "guppi"])
def test_pinned_call_spans(dev, tmp_path, layout):
    """Traced, a call on pinned blocks ends in one ``mesh.copy_wait``,
    inside its ``wideband.call`` and after its last ``wideband.step``; a
    call on device blocks has none."""
    import json
    from baseband_tasks_tpu_torch.utils import profiling
    run, words, _ = _small_entry(dev, layout)
    host = _pinned(words)
    run(blocks=host)
    with profiling.trace(str(tmp_path / "t")):
        for b in (host, words, host):
            run(blocks=b)
    with open(tmp_path / "t" / "trace.json") as f:
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    calls = sorted((a, b) for n, a, b in spans if n == "wideband.call")
    assert len(calls) == 3
    waits = [(a, b) for n, a, b in spans if n == "mesh.copy_wait"]
    assert len(waits) == 2
    for (c0, c1), pinned in zip(calls, (True, False, True)):
        inside = [(a, b) for a, b in waits if c0 <= a and b <= c1]
        assert len(inside) == pinned
        last_step = max(b for n, a, b in spans
                        if n == "wideband.step" and c0 <= a and b <= c1)
        assert all(last_step <= a for a, _ in inside)


def test_shard_copies_pinned_blocks_on_the_copy_stream(dev):
    """``shard`` of a pinned tensor gives ``.to()``'s blocks, and the
    source may be overwritten as soon as it returns; ``shard_async`` of
    contiguous pinned blocks has copies pending, of pageable numpy or a
    non-contiguous pinned view (a channel shard) none."""
    from baseband_tasks_tpu_torch import parallel as par
    g = torch.Generator()
    g.manual_seed(7)
    x = torch.randn((1 << 16, 8, 2), generator=g).pin_memory()
    want = x.to(dev)
    time2 = par.make_mesh(2, 1, devices=[dev] * 2)
    chan2 = par.make_mesh(1, 2, devices=[dev] * 2)
    spec = ("time", "chan")
    torch.cuda._sleep(1 << 28)          # ~0.1-0.2 s of the compute stream
    grid = par.shard(x, time2, spec)
    x.zero_()
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([grid[0, 0], grid[1, 0]]), want)
    x.copy_(want.cpu())
    grid, pending = par.shard_async(x, time2, spec)
    assert pending
    pending.wait()
    assert not pending
    assert torch.equal(grid[1, 0], want[1 << 15:])
    for src, mesh in ((want.cpu().numpy(), time2), (x, chan2)):
        grid, pending = par.shard_async(src, mesh, spec)
        assert not pending
        assert torch.equal(par.unshard(grid, mesh, spec), want)
        assert all(b.is_contiguous() and b.device == dev for b in grid.flat)


@pytest.mark.parametrize("n_chan, t", [(1, 4), (4, 2304), (33, 1000),
                                       (64, 200704)])
def test_guppi_repack(dev, n_chan, t):
    """Bit for bit against the plain version: one channel and one row,
    ragged tiles of rows and channels, the GUPPI deployment's block."""
    words = _guppi_words(dev, n_chan, t, 60 + n_chan)
    dd.reset_launch_counts()
    got = dd.guppi_repack(words)
    assert dd.launch_counts["guppi_repack"] == 1
    ref = dd.guppi_repack_ref(words)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_wrappers_refuse_bad_inputs(dev):
    words, planes, edges, scale = inputs(dev, 896, 32, 96, 128, 8)
    with pytest.raises(TypeError):
        dd.stage_a(*planes, *edges, scale.double())
    with pytest.raises(ValueError, match="contiguous"):
        y = [torch.randn((128, 128, 8), device=dev).transpose(0, 2)
             for _ in range(2)]
        dd.stage_b(*y, *y)
    with pytest.raises(ValueError, match="on cpu"):
        dd.stage_a(*planes, *[e.cpu() for e in edges], scale)


def test_no_fallback_when_library_missing(dev, monkeypatch):
    from baseband_tasks_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    _, planes, edges, scale = inputs(dev, 896, 32, 96, 128, 8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dd.stage_a(*planes, *edges, scale)


# -- the four-step passes ---------------------------------------------------

LANES = [8, 16, 128]
WINDOWS = [1 << 9, 1 << 12, 1 << 15, 1 << 18]
K1_WINDOWS = WINDOWS + [1 << 16]          # N1 = 256


def randn(dev, shape, seed, count=2):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(count)]


@pytest.mark.parametrize("n", K1_WINDOWS)
@pytest.mark.parametrize("L", LANES)
def test_k1_window(dev, L, n):
    k1_form_of(n, L)
    x = randn(dev, (n, L), 10)
    assert_planes(ff.k1_window(*x), ff.k1_window_ref(*x))


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("n", WINDOWS)
@pytest.mark.parametrize("L", LANES)
def test_k2_fwd_inv(dev, L, n, ortho):
    n1, n2 = dd.split_n(n)
    y = randn(dev, (n2, n1, L), 11)
    fwd = ff.fft_scale(n, inverse=False, ortho=ortho)
    inv = ff.fft_scale(n, inverse=True, ortho=ortho) * n1
    assert_planes(ff.k2_fwd(*y, fwd), ff.k2_fwd_ref(*y, fwd))
    assert_planes(ff.k2_inv(*y, inv), ff.k2_inv_ref(*y, inv))


@pytest.mark.parametrize("pads", [(0, 0), (1, 1), (2, 5)])
@pytest.mark.parametrize("n", WINDOWS)
@pytest.mark.parametrize("L", LANES)
def test_k3_trim(dev, L, n, pads):
    """pads in rows of N2: none, one each side, lopsided."""
    n1, n2 = dd.split_n(n)
    kw = dict(pad_start=pads[0] * n2, pad_end=pads[1] * n2)
    z = randn(dev, (n2, n1, L), 12)
    got = ff.k3_trim(*z, **kw)
    assert got[0].shape == (n - (pads[0] + pads[1]) * n2, L)
    assert_planes(got, ff.k3_trim_ref(*z, **kw))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << 10, 1 << 16])
def test_fft_pow2_planes(dev, n, inverse):
    x = randn(dev, (n, 16), 13)
    dd.reset_launch_counts()
    got = ff.fft_pow2_planes(*x, inverse=inverse)
    names = ("k2_inv", "k3_trim") if inverse else ("k1_window", "k2_fwd")
    assert all(dd.launch_counts[k] == 1 for k in names)
    assert_planes(got, ff.fft_pow2_planes_ref(*x, inverse=inverse))
    with dd.plain_versions():
        plain = ff.fft_pow2_planes(*x, inverse=inverse)
    assert all(dd.launch_counts[k] == 1 for k in names)
    assert_planes(got, plain)


@pytest.mark.parametrize("n,L,pads", [(1 << 12, 8, (64, 128)),
                                      (1 << 18, 128, (512, 512))])
def test_spectral_filter(dev, n, L, pads):
    n1, n2 = dd.split_n(n)
    x = randn(dev, (n, L), 14)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(device=dev
                                                           ).manual_seed(15),
                    device=dev) * 6.283
    g = (torch.cos(ph), torch.sin(ph))
    kw = dict(pad_start=pads[0], pad_end=pads[1])
    assert_planes(sf.spectral_filter_pow2(*x, *g, **kw),
                  sf.spectral_filter_pow2_ref(*x, *g, **kw))


def test_four_step_refusals(dev):
    big = torch.zeros((1 << 25, 1), device=dev)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        ff.k1_window(big, big)
    with pytest.raises(ValueError, match="power of two"):
        ff.k1_window(*randn(dev, (768, 8), 16))
    z = randn(dev, (32, 16, 8), 17)
    with pytest.raises(ValueError, match="multiple of N2"):
        ff.k3_trim(*z, pad_start=16)
    with pytest.raises(TypeError):
        ff.k2_fwd(*[t.double() for t in z], 1.0)


def test_tasks_on_card(dev):
    """Dedisperse on both engines and the 'pallas' FFT engine, built on a
    card stream: kernels against the plain versions."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.fourier import fft_maker
    u = bt.units
    freq = (400 + (np.arange(16) - 8) * 0.25) * u.MHz
    src = bt.SetAttribute(bt.NoiseGenerator(
        shape=(1 << 16, 16), start_time=bt.Time.from_mjd(58000.0),
        sample_rate=250 * u.kHz, samples_per_frame=4096, seed=3,
        device=dev), frequency=freq, sideband=1)
    outs = []
    for plain in (contextlib.nullcontext, dd.plain_versions):
        ded = bt.Dedisperse(src, 2.0, samples_per_frame=1 << 13)
        assert ded.engine == "pallas"
        chain = bt.Dechannelize(ded)
        with fft_maker.set("pallas"), plain():
            # pads 385 + 387: a 2^13 window, on the four-step kernels
            xla = bt.Dedisperse(src, 2.0, engine="xla",
                                samples_per_frame=(1 << 13) - 772)
            assert xla._padded_samples_per_frame == 1 << 13
            assert fft_maker((1 << 13, 16), np.complex64)._use_pallas
            outs.append((chain.read(3 * chain.samples_per_frame),
                         xla.read(2 * xla.samples_per_frame)))
    for got, ref in zip(*outs):
        assert got.device == dev
        assert_planes((got.real, got.imag), (ref.real, ref.imag))


# -- the compiled slice's kernels ---------------------------------------------

def mats(dev, L, seed):
    """A random complex (L, L) mixer scaled to keep outputs O(1)."""
    return [t / L ** 0.5 for t in randn(dev, (L, L), seed)]


@pytest.mark.parametrize("dft", [False, True])
@pytest.mark.parametrize("scale", [None, 0.75])
@pytest.mark.parametrize("n_tap", [2, 8, 9])
@pytest.mark.parametrize("m,L", [(48, 128), (1000, 512), (32256, 512),
                                 (40, 100)])
def test_pfb_fwd(dev, m, L, n_tap, scale, dft):
    """The FIR (64-row runs of 4 lanes a thread; 100 lanes take single
    lanes) and the fused DFT (128-row tiles) against their plain
    versions, with ragged last row runs (48, 1000 and 40 rows)."""
    k = n_tap - 1
    carry = randn(dev, (k, L), 20)
    x = randn(dev, (m, L), 21)
    taps = randn(dev, (n_tap, L), 22, count=1)[0]
    f = mats(dev, L, 23) if dft else [None, None]
    sc = None if scale is None else torch.tensor([scale], device=dev)
    if dft and L % 16:
        # the fused DFT's depth slices are 16 lanes of one plane
        with pytest.raises(ValueError, match="multiple of 16"):
            opfb.pfb_forward_stream(*carry, *x, taps, *f, n_tap=n_tap,
                                    scale=sc)
        return
    dd.reset_launch_counts()
    got = opfb.pfb_forward_stream(*carry, *x, taps, *f, n_tap=n_tap,
                                  scale=sc)
    name = "pfb_fwd_dft" if dft else "pfb_fwd"
    assert dd.launch_counts[name] == 1
    ref = opfb.pfb_forward_stream_ref(*carry, *x, taps, *f, n_tap=n_tap,
                                      scale=sc)
    assert_planes(got, ref)
    # a number as the scale gives the same as the device scalar
    if scale is not None:
        assert_planes(opfb.pfb_forward_stream(*carry, *x, taps, *f,
                                              n_tap=n_tap, scale=scale), ref)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("n,L,pad", [(1 << 12, 128, 256),
                                     (1 << 15, 512, 512),
                                     (1 << 18, 128, 512)])
def test_stream_stage_a(dev, n, L, pad, pre):
    # config 3's k1_stream (N1 = 128, 512 lanes) and config 2's (N1 = 512)
    k1_form_of(n, L)
    c = randn(dev, (pad, L), 24)
    x = randn(dev, (n - pad, L), 25)
    sc = torch.tensor([1.25], device=dev)
    got = ff.k1_stream(*c, *x, sc)
    ref = ff.k1_stream_ref(*c, *x, sc)
    if pre:
        w = mats(dev, L, 26)
        got = sf.lane_mix(*(p.reshape(n, L) for p in got), *w)
        ref = sf.lane_mix_ref(*(p.reshape(n, L) for p in ref), *w)
    assert_planes(got, ref)


@pytest.mark.parametrize("pads", [(0, 0), (1, 1), (2, 5)])
@pytest.mark.parametrize("n,L", [(1 << 12, 128), (1 << 15, 512)])
def test_k3_trim_post(dev, n, L, pads):
    n1, n2 = dd.split_n(n)
    kw = dict(pad_start=pads[0] * n2, pad_end=pads[1] * n2)
    z = randn(dev, (n2, n1, L), 27)
    w = mats(dev, L, 28)
    dd.reset_launch_counts()
    got = sf.lane_mix(*ff.k3_trim(*z, **kw), *w)
    assert dd.launch_counts["k3_trim"] == dd.launch_counts["lane_mix"] == 1
    assert_planes(got, sf.lane_mix_ref(*ff.k3_trim_ref(*z, **kw), *w))


@pytest.mark.parametrize("L", [1, 3, 100, 1600])
@pytest.mark.parametrize("rows", [1, 63, 65])
def test_lane_mix_ragged(dev, rows, L):
    """Rows off the 64-row MMA tile, depth 2L off the 16-deep stage and
    the 128-column tile, odd L (4-byte copies)."""
    x = randn(dev, (rows, L), 32)
    w = mats(dev, L, 33)
    dd.reset_launch_counts()
    got = sf.lane_mix(*x, *w)
    assert dd.launch_counts["lane_mix"] == 1
    assert_planes(got, sf.lane_mix_ref(*x, *w))


# 3xTF32 against the float64 product: one TF32 pass is ~3e-4 of the peak
# (tests/test_torch_tf32_split.py); the kernels, which promote each
# stage's partial into a float32 total, stay float32-class at every depth
TF32X3_TOL = 1e-5


@pytest.mark.parametrize("L", [128, 512, 1600])
def test_lane_mix_precision_guard(dev, L):
    x = randn(dev, (4096, L), 34)
    w = mats(dev, L, 35)
    got = sf.lane_mix(*x, *w)
    ref = sf.lane_mix_ref(*(t.double() for t in (*x, *w)))
    _peak_close(torch.cat(got).double(), torch.cat(ref), TF32X3_TOL)


@pytest.mark.parametrize("L", [128, 512, 1600])
def test_pfb_fwd_dft_precision_guard(dev, L):
    """The fused PFB's DFT (3xTF32 on the tensor cores, partials promoted
    to float32) against the float64 tap sum and product: float32-class,
    within 1e-5 of the peak at every depth."""
    m, n_tap = 1000, 8
    carry = randn(dev, (n_tap - 1, L), 36)
    x = randn(dev, (m, L), 37)
    taps = randn(dev, (n_tap, L), 38, count=1)[0]
    f = mats(dev, L, 39)
    dd.reset_launch_counts()
    got = opfb.pfb_forward_stream(*carry, *x, taps, *f, n_tap=n_tap,
                                  scale=0.75)
    assert dd.launch_counts["pfb_fwd_dft"] == 1
    ref = opfb.pfb_forward_stream_ref(
        *(t.double() for t in (*carry, *x, taps, *f)), n_tap=n_tap,
        scale=0.75)
    _peak_close(torch.cat(got).double(), torch.cat(ref), TF32X3_TOL)


@pytest.mark.parametrize("pre,post", [(True, False), (False, True)])
def test_spectral_filter_stream(dev, pre, post):
    n, L, p0, p1 = 1 << 12, 128, 256, 512
    n1, n2 = dd.split_n(n)
    c = randn(dev, (p0 + p1, L), 29)
    x = randn(dev, (n - p0 - p1, L), 30)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(device=dev
                                                           ).manual_seed(31),
                    device=dev) * 6.283
    g = (torch.cos(ph), torch.sin(ph))
    kw = dict(pad_start=p0, pad_end=p1, scale=0.5,
              pre=mats(dev, L, 32) if pre else None,
              post=mats(dev, L, 33) if post else None)
    assert_planes(sf.spectral_filter_stream(*c, *x, *g, **kw),
                  sf.spectral_filter_stream_ref(*c, *x, *g, **kw))


@pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")
def test_compiled_fusions_on_card(dev):
    """The four fusions' planes steps on the card: each chain fuses as the
    JAX package fuses it, launches its kernels (and not the ones its
    fusion removes), and agrees with the plain versions over three blocks
    with a scale."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    h = bt.sinc_hamming(8, 64)

    def noise(shape, seed):
        return bt.NoiseGenerator(shape=shape, start_time=bt.Time.from_mjd(
            58000.0), sample_rate=1 * u.MHz, samples_per_frame=8192,
            seed=seed, device=dev)

    def chains():
        src = noise((1 << 17, 2), 1)
        pfb = bt.PolyphaseFilterBank(src, h, samples_per_frame=416)
        inv = bt.InversePolyphaseFilterBank(
            pfb, h, sn=1e3, pad_start=32, pad_end=32, samples_per_frame=352,
            dtype=src.dtype, engine="pallas")
        freq = (400 + (np.arange(16) - 8) * 0.25) * u.MHz
        chan = bt.SetAttribute(noise((1 << 16, 16), 2), frequency=freq,
                               sideband=1)
        ded = bt.Dechannelize(bt.Dedisperse(chan, 2.0, engine="pallas",
                                            samples_per_frame=1 << 13))
        spectra = bt.Channelize(noise((1 << 20, 2), 3), 64)
        single = bt.InversePolyphaseFilterBank(
            spectra, h, sn=1e3, pad_start=32, pad_end=32,
            samples_per_frame=352, engine="pallas")
        return [bt.CompiledPipeline(c) for c in (inv, pfb, ded, single)]

    # per chain: the fused stage classes, the kernels it must launch, the
    # kernels its fusion must not launch
    expect = [
        (["_FusedPolyphaseFIR", "_FusedDechanInvPFB"],
         ("pfb_fwd", "k1_stream", "k2", "k3_trim"),
         ("lane_mix", "pfb_fwd_dft", "k1_window")),
        (["_FusedPFBForward"], ("pfb_fwd_dft",), ("pfb_fwd",)),
        (["_FusedDisperseDechan"], ("k1_stream", "k2", "k3_trim", "lane_mix"),
         ("k1_window",)),
        (["_FusedDechanInvPFB"], ("k1_stream", "lane_mix", "k2", "k3_trim"),
         ("k1_window",)),
    ]
    for kern, plain, (names, needs, forbidden) in zip(
            chains(), chains(), expect):
        assert [type(st.fused).__name__ for st in kern.stages
                if st.fused is not None] == names
        outs = []
        for cp in (kern, plain):
            blocks = cp.read_source_blocks(3)
            step, carry = cp.planes_step(), cp.init_carry(planes=True)
            dd.reset_launch_counts()
            got = []
            with (dd.plain_versions() if cp is plain
                  else contextlib.nullcontext()):
                for k, s in enumerate((0.5, 2.0, 1.0)):
                    carry, y = step(carry, blocks[k], s)
                    got.append(y)
            outs.append(got)
            counts = dict(dd.launch_counts)
            if cp is kern:
                assert all(counts[k] >= 3 for k in needs), (names, counts)
                assert not any(counts[k] for k in forbidden), (names, counts)
            else:
                assert not any(counts.values()), (names, counts)
        for a, b in zip(*outs):
            assert_planes(a, b)


@pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")
def test_resample_on_card(dev):
    """ShiftAndResample(engine='pallas') with an LO on a 16-lane card
    stream: eager frames launch k1_window, k2 and k3_trim, the compiled
    planes step k1_stream, k2 and k3_trim; each against the plain
    versions, and the compiled blocks against the eager frames (the
    65-tap response fits its 128-row pad, so overlap-save is exact at any
    window offset and the LO is in every form)."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    freq = (400 + (np.arange(16) - 8) * 0.25) * u.MHz
    src = bt.SetAttribute(bt.NoiseGenerator(
        shape=(1 << 16, 16), start_time=bt.Time.from_mjd(58000.0),
        sample_rate=250 * u.kHz, samples_per_frame=4096, seed=5,
        device=dev), frequency=freq, sideband=1)

    def node():
        r = bt.ShiftAndResample(src, np.linspace(0.1, 0.9, 16),
                                lo=400 * u.MHz, pad=32,
                                samples_per_frame=8000, engine="pallas")
        assert (r.engine, r._padded_samples_per_frame,
                r.pad_start + r.pad_end) == ("pallas", 1 << 13, 128)
        return r

    outs = []
    for plain in (contextlib.nullcontext, dd.plain_versions):
        r = node()
        cp = bt.CompiledPipeline(node())
        blocks = cp.read_source_blocks(3)
        dd.reset_launch_counts()
        with plain():
            eager = r.read(3 * r.samples_per_frame)
            eager_counts = dict(dd.launch_counts)
            dd.reset_launch_counts()
            step, carry = cp.planes_step(), cp.init_carry(planes=True)
            got = []
            for x in blocks:
                carry, y = step(carry, x)
                got.append(torch.complex(*y))
        counts = dict(dd.launch_counts)
        if plain is contextlib.nullcontext:
            assert all(eager_counts[k] == 3 for k in
                       ("k1_window", "k2", "k3_trim")), eager_counts
            assert all(counts[k] == 3 for k in
                       ("k1_stream", "k2", "k3_trim")), counts
            assert not counts["k1_window"], counts
        else:
            assert not any(eager_counts.values()) and not any(
                counts.values())
        outs.append((eager, torch.cat(got)))
    for got, ref in zip(*outs):
        assert got.device == dev
        assert_planes((got.real, got.imag), (ref.real, ref.imag))
    eager, comp = outs[0]
    d = int(cp.delay)
    assert_planes((comp[cp.warmup:].real, comp[cp.warmup:].imag),
                  (eager[cp.warmup - d:comp.shape[0] - d].real,
                   eager[cp.warmup - d:comp.shape[0] - d].imag))


# -- the flagship's variants --------------------------------------------------

@pytest.mark.parametrize("n_phase", [8, 64, 32768])
@pytest.mark.parametrize("geom", GEOMS[:2] + [(896, 32, 96, 2)])
def test_k3_fold_stokes(dev, geom, n_phase):
    """Every lane's partner, the tile's last lane and the wrap included;
    the gather form at n_phase 2^15."""
    t_main, p0, p1, L = geom
    n1, n2 = dd.split_n(t_main + p0 + p1)
    z = randn(dev, (n2, n1, L), 40)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 97.0), device=dev)
    kw = dict(n_phase=n_phase, pad_start=p0, n_valid=t_main, stokes=True)
    dd.reset_launch_counts()
    prof, cnt = dd.detect_fold(*z, fold, **kw)
    assert dd.launch_counts["k3_fold_stokes"] == 1
    rprof, rcnt = dd.fold_ref(*z, fold, **kw)
    assert prof.shape == (n_phase + 1, 3 * L) and torch.equal(cnt, rcnt)
    hit = rcnt > 0
    rel = ((prof[:, :L] - rprof[:, :L]).abs()[hit]
           / rprof[:, :L].abs()[hit]).max()
    assert float(rel) <= PROFILE_RTOL
    assert_planes((prof[:, L:],), (rprof[:, L:],))
    assert not prof[~hit].any()


def test_k3_fold_stokes_guppi_shape(dev):
    """The GUPPI deployment's fold: 2048 Stokes bins over 128 lanes of a
    2^18 window (pads 32768 / 28672) take the gather form on the 16-lane
    column compiled for it (8 lanes' shared partials exceed the budget);
    the flagship's 64 bins keep the compiled 8-lane runs form."""
    n, p0, p1, L = 1 << 18, 32768, 28672, 128
    n1, n2 = dd.split_n(n)
    assert dd.k3_form("k3_fold_stokes", n1, L, 2048) == {
        "tile": 16, "partials": "gather", "form": "register"}
    for name in ("k3_fold", "k3_fold_stokes"):
        assert dd.k3_form(name, n1, L, 64) == {
            "tile": 8, "partials": "shared", "form": "register"}
    z = randn(dev, (n2, n1, L), 45)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 2434.07),
                           device=dev)
    kw = dict(n_phase=2048, pad_start=p0, n_valid=n - p0 - p1, stokes=True)
    dd.reset_launch_counts()
    prof, cnt = dd.detect_fold(*z, fold, **kw)
    assert {k: v for k, v in dd.launch_counts.items() if v} == {
        "k3_fold_stokes": 1, "k3_fold_gather": 1}
    rprof, rcnt = dd.fold_ref(*z, fold, **kw)
    assert torch.equal(cnt, rcnt) and int(cnt[:2048].sum()) == n - p0 - p1
    hit = rcnt > 0
    rel = ((prof[:, :L] - rprof[:, :L]).abs()[hit]
           / rprof[:, :L].abs()[hit]).max()
    assert float(rel) <= PROFILE_RTOL
    assert_planes((prof[:, L:],), (rprof[:, L:],))


# the GUPPI node's rate (~2434 samples a period, 1.19 a bin at 2048
# bins) and one whose bin edges fall on whole samples (2^20 a sample)
GATHER_RATES = (1.0 / 2434.07, 1.0 / 2048)


@pytest.mark.parametrize("pads", [(0, 0), (32768, 28672)])
@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("n_phase", [1024, 2048, 4096, 8192])
def test_k3_fold_many_bins(dev, n_phase, stokes, pads):
    """K3 at 1024 to 8192 bins on the GUPPI node's 2^18 x 128 window,
    power and Stokes, in the form its shape takes (the gather form where
    the runs form cannot keep its 8-lane tile with shared partials:
    Stokes from 2048 bins, power from 4096), against the plain version:
    phase offsets 0 and 2^31 - 1, the node's rate and one that puts the
    bin edges on samples, no pads and the node's; counts exact, power
    within PROFILE_RTOL, cross planes within FFT_TOL of their peak."""
    n, L = 1 << 18, 128
    p0, p1 = pads
    n1, n2 = dd.split_n(n)
    name = "k3_fold_stokes" if stokes else "k3_fold"
    form = dd.k3_form(name, n1, L, n_phase)
    gather = n_phase >= (2048 if stokes else 4096)
    assert form == ({"tile": 16, "partials": "gather", "form": "register"}
                    if gather else
                    {"tile": 8, "partials": "shared", "form": "register"})
    z = randn(dev, (n2, n1, L), 46)
    kw = dict(n_phase=n_phase, pad_start=p0, n_valid=n - p0 - p1,
              stokes=stokes)
    for i0 in (0, (1 << 31) - 1):
        for rate in GATHER_RATES:
            p = int(round(rate * (1 << 31)))
            fold = torch.tensor([i0, p, 0], dtype=torch.int32, device=dev)
            dd.reset_launch_counts()
            prof, cnt = dd.detect_fold(*z, fold, **kw)
            assert dd.launch_counts[name] == 1
            assert dd.launch_counts["k3_fold_gather"] == int(gather)
            rprof, rcnt = dd.fold_ref(*z, fold, **kw)
            assert torch.equal(cnt, rcnt)
            assert int(cnt[:n_phase].sum()) == n - p0 - p1
            hit = rcnt > 0
            rel = ((prof[:, :L] - rprof[:, :L]).abs()[hit]
                   / rprof[:, :L].abs()[hit]).max()
            assert float(rel) <= PROFILE_RTOL, (i0, rate)
            if stokes:
                assert_planes((prof[:, L:],), (rprof[:, L:],))
            assert not prof[~hit].any()
            del rprof, rcnt


@pytest.mark.parametrize("stokes", [False, True])
def test_k3_gather_is_deterministic(dev, stokes):
    """The gather form sums each (bin, lane) in registers in time order,
    with no atomics on bins 0 .. n_phase-1: two calls on the same planes
    give those rows bit for bit, and the same counts (the GUPPI node's
    window and rate, 8192 bins for power, 2048 for Stokes)."""
    n, p0, p1, L = 1 << 18, 32768, 28672, 128
    n1, n2 = dd.split_n(n)
    n_phase = 2048 if stokes else 8192
    name = "k3_fold_stokes" if stokes else "k3_fold"
    assert dd.k3_form(name, n1, L, n_phase)["partials"] == "gather"
    z = randn(dev, (n2, n1, L), 47)
    fold = torch.as_tensor(dd.fold_phase_vector(0.7, 1.0 / 2434.07),
                           device=dev)
    kw = dict(n_phase=n_phase, pad_start=p0, n_valid=n - p0 - p1,
              stokes=stokes)
    dd.reset_launch_counts()
    a = dd.detect_fold(*z, fold, **kw)
    b = dd.detect_fold(*z, fold, **kw)
    assert dd.launch_counts["k3_fold_gather"] == 2
    # the trash row too: its pad rows are summed in a fixed order
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


@pytest.mark.parametrize("n", [1 << 10, 1 << 18])
@pytest.mark.parametrize("L", [16, 128])
def test_k3_power_and_k2_theta(dev, L, n):
    n1, n2 = dd.split_n(n)
    z = randn(dev, (n2, n1, L), 41)
    dd.reset_launch_counts()
    assert_planes((dd.k3_power(*z),), (dd.k3_power_ref(*z),))
    theta = torch.rand((n2, n1, L), generator=torch.Generator(
        device=dev).manual_seed(42), device=dev) - 0.5
    got = dd.stage_b_theta(*[p.clone() for p in z], theta)
    ref = dd.k2_theta_ref(*[p.clone() for p in z], theta)
    assert_planes(got, ref)
    assert dd.launch_counts["k3_power"] == dd.launch_counts["k2_theta"] == 1


@pytest.mark.parametrize("geom", K1_GEOMS)
def test_k1_planes_and_stream_planes(dev, geom):
    t_main, p0, p1, L = geom
    n = t_main + p0 + p1
    k1_form_of(n, L)
    (x2,) = randn(dev, (2, n, L), 43, count=1)
    assert_planes(dd.stage_a_planes(x2),
                  dd.stage_a_window_ref(torch.complex(x2[0], x2[1])))
    front, end = (randn(dev, (2, p, L), 44 + p, count=1)[0]
                  for p in (p0, p1))
    scale = torch.tensor([0.75], device=dev)
    block = x2[:, :t_main].contiguous()
    got = dd.stage_a_stream_planes(block, front, end, scale)
    assert_planes(got, dd.stage_a_ref(x2[0, :t_main], x2[1, :t_main],
                                      front[0], front[1], end[0], end[1],
                                      scale))
    with pytest.raises(ValueError, match="contiguous"):
        dd.stage_a_planes(x2.transpose(1, 2).contiguous().transpose(1, 2))
    # the public op passes a strided card tensor on uncopied: refused
    n1, n2 = dd.split_n(n)
    chirp = randn(dev, (n2, n1, L), 46)
    view = block.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dd.dedisperse_fold_stream(view, front, end, *chirp,
                                  dd.fold_phase_vector(0.3, 1.0 / 97.0),
                                  scale, n_phase=8, pad_start=p0,
                                  n_valid=t_main)


@pytest.mark.parametrize("detect", ["power", "stokes"])
def test_pipeline_variants_on_card(dev, detect):
    """step_fn, step_bins_fn and the planes step on the kernels against
    the plain versions, and step_fn against the torch.fft path on the
    same power-of-two window (the JAX package's
    test_pallas_stokes_matches_xla bound)."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    kw = dict(n_chan=8, n_pol=2, dm=1.0, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, period_samples=(800, 1), n_phase=16,
              block_samples=1024, device=dev, detect=detect)
    kern = bt.WidebandPulsarPipeline(use_kernels=True, **kw)
    xla = bt.WidebandPulsarPipeline(fft_pow2=True, **kw)
    T = kern.global_block
    xf = torch.randn((T, 8, 2, 2), generator=torch.Generator(
        device=dev).manual_seed(45), device=dev)
    bins = (torch.arange(T, device=dev) % 16).float()
    x2 = torch.movedim(xf, -1, 0).contiguous()
    calls = [lambda: kern.step_fn()(xf, 300),
             lambda: kern.step_bins_fn()(xf, bins),
             lambda: kern.planes_step(x2, *kern._chirp_device(), 300, 300),
             lambda: kern.planes_step(x2, kern._theta_device(), None, 300,
                                      300)]
    for call in calls:
        dd.reset_launch_counts()
        prof, cnt = call()
        assert any(dd.launch_counts.values())
        with dd.plain_versions():
            rprof, rcnt = call()
        assert torch.equal(cnt, rcnt)
        torch.testing.assert_close(prof, rprof, rtol=PROFILE_RTOL,
                                   atol=1e-6 * float(rprof.abs().max()))
    dd.reset_launch_counts()
    prof, cnt = xla.step_fn()(xf, 300)
    assert not any(dd.launch_counts.values())
    kprof, kcnt = kern.step_fn()(xf, 300)
    assert torch.equal(cnt, kcnt)
    torch.testing.assert_close(kprof, prof, rtol=1e-3, atol=1e-2)


# -- the search and resident slice ------------------------------------------

def _peak_close(got, ref, tol=FFT_TOL):
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("n_seg,L,n_cols", [(256, 64, 512), (512, 256, 1024),
                                            (256, 512, 16896)])
def test_bank_power(dev, n_seg, L, n_cols):
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    fr, fi = randn(dev, (n_seg, L), 70)
    ka, kb, kc = randn(dev, (L, n_cols), 71, count=3)
    dd.reset_launch_counts()
    got = ac.bank_matmul_power(fr, fi, ka, kb, kc)
    assert dd.launch_counts["bank_power"] == 1
    _peak_close(got, ac.bank_matmul_power_ref(fr, fi, ka, kb, kc))
    with pytest.raises(ValueError, match="tiles"):
        ac.bank_matmul_power(fr[:, :L - 4].contiguous(),
                             fi[:, :L - 4].contiguous(), ka[4:], kb[4:],
                             kc[4:], seg_tile=64, col_tile=128)


def test_bank_power_precision_guard(dev):
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    fr, fi = randn(dev, (256, 512), 74)
    ka, kb, kc = randn(dev, (512, 16896), 75, count=3)
    got = ac.bank_matmul_power(fr, fi, ka, kb, kc)
    ref = ac.bank_matmul_power_ref(*(t.double() for t in (fr, fi, ka, kb,
                                                          kc)))
    _peak_close(got.double(), ref, TF32X3_TOL)


@pytest.mark.parametrize("seg_len,valid", [(512, 384), (4096, 3840),
                                           (2, 1)])
def test_accel_corr(dev, seg_len, valid):
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    sr, si = randn(dev, (5, seg_len), 72)
    tr, ti = randn(dev, (seg_len, ac.LANES), 73)
    segs = torch.complex(sr, si)
    dd.reset_launch_counts()
    got = ac.accel_correlate_bank(segs, tr, ti, valid=valid)
    assert dd.launch_counts["accel_corr"] == 1
    assert got.shape == (5, valid, ac.LANES)
    _peak_close(got, ac.accel_correlate_bank_ref(segs, tr, ti, valid=valid))


def test_accel_corr_many_segments(dev):
    """More segments than a grid has rows (65535): the blocks walk them."""
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    sr, si = randn(dev, (70001, 8), 74)
    tr, ti = randn(dev, (8, ac.LANES), 75)
    segs = torch.complex(sr, si)
    dd.reset_launch_counts()
    got = ac.accel_correlate_bank(segs, tr, ti, valid=5)
    assert dd.launch_counts["accel_corr"] == 1
    ref = ac.accel_correlate_bank_ref(segs, tr, ti, valid=5)
    _peak_close(got, ref)
    _peak_close(got[65535:], ref[65535:])


@pytest.mark.parametrize("n_used", [1, 17, 65, 128])
@pytest.mark.parametrize("full", [False, True], ids=["valid1", "validN"])
@pytest.mark.parametrize("seg_len", [2, 8, 512, 4096])
def test_accel_corr_lanes(dev, seg_len, full, n_used):
    """The search's used-lane entry: the first n_used lanes of the public
    op, its rows padded to whole sectors underneath (the map and its
    (-1, n_used) reshape are views of them), one launch."""
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    valid = seg_len if full else 1
    sr, si = randn(dev, (5, seg_len), 76)
    tr, ti = randn(dev, (seg_len, ac.LANES), 77)
    segs = torch.complex(sr, si)
    dd.reset_launch_counts()
    got = ac._accel_correlate_lanes(segs, tr, ti, valid=valid, n_used=n_used)
    assert dd.launch_counts["accel_corr"] == 1
    assert got.shape == (5, valid, n_used)
    assert got.reshape(-1, n_used).data_ptr() == got.data_ptr()
    _peak_close(got, ac._accel_correlate_lanes_ref(segs, tr, ti, valid=valid,
                                                   n_used=n_used))
    _peak_close(got, ac.accel_correlate_bank(segs, tr, ti,
                                             valid=valid)[..., :n_used])


def test_accel_corr_lanes_many_segments(dev):
    """More segments than a grid has rows, on the used-lane entry."""
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    sr, si = randn(dev, (70001, 8), 78)
    tr, ti = randn(dev, (8, ac.LANES), 79)
    segs = torch.complex(sr, si)
    got = ac._accel_correlate_lanes(segs, tr, ti, valid=5, n_used=17)
    ref = ac._accel_correlate_lanes_ref(segs, tr, ti, valid=5, n_used=17)
    _peak_close(got, ref)
    _peak_close(got[65535:], ref[65535:])


@pytest.mark.parametrize("n_phase", [8, 64, 32768])
@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(32, 32, 1), (32, 32, 2), (32, 32, 3),
                                   (16, 512, 24), (16, 512, 128)])
def test_k3_fold_tiles(dev, shape, bf16, stokes, n_phase):
    """K3's four launch names on one-lane tiles (L 1 and 3), two-lane
    tiles, and the flagship's column (N1 = 512, 8-lane tiles: three of
    them at L 24, sixteen at 128): every Stokes partner, across each tile
    edge and from lane L-1 to lane 0; the gather form at n_phase 2^15
    (counted beside the launch name); counts exact, the power plane within
    PROFILE_RTOL, the cross planes within FFT_TOL of their peak."""
    n2, n1, L = shape
    z = randn(dev, (n2, n1, L), 80)
    if bf16:
        z = [p.to(torch.bfloat16) for p in z]
    pad = n1 * n2 // 8
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 97.0), device=dev)
    kw = dict(n_phase=n_phase, pad_start=pad, n_valid=n1 * n2 - 2 * pad,
              stokes=stokes)
    dd.reset_launch_counts()
    prof, cnt = dd.detect_fold(*z, fold, **kw)
    name = ("k3_fold_stokes" if stokes else "k3_fold") + (
        "_bf16" if bf16 else "")
    gather = dd.k3_form(name, n1, L, n_phase)["partials"] == "gather"
    assert gather == (n_phase == 32768)
    assert {k: v for k, v in dd.launch_counts.items() if v} == dict(
        {name: 1}, **({"k3_fold_gather": 1} if gather else {}))
    rprof, rcnt = dd.fold_ref(*z, fold, **kw)
    assert torch.equal(cnt, rcnt)
    assert int(cnt.sum()) == n1 * n2
    hit = rcnt > 0
    rel = ((prof[:, :L] - rprof[:, :L]).abs()[hit]
           / rprof[:, :L].abs()[hit]).max()
    assert float(rel) <= PROFILE_RTOL
    if stokes:
        assert_planes((prof[:, L:],), (rprof[:, L:],))
    assert not prof[~hit].any()


def _k2_columns(n2, L):
    """Columns N1 for a K2 tile test: about 2^20 rows of N2 x L, at least
    two, so that every case has more columns than the persistent grid has
    blocks (at most a few hundred) except the largest lane counts, whose
    grids are L / tile lane tiles wide."""
    n1 = 1 << max(1, (1 << 20).bit_length() - 1 - (n2 * L).bit_length() + 1)
    return min(n1, (1 << 24) // n2)


@pytest.mark.parametrize("name", ["k2", "k2_bf16", "k2_bf16_chirp",
                                  "k2_theta"])
@pytest.mark.parametrize("L", [1, 2, 3, 24, 128])
@pytest.mark.parametrize("n2", [32, 256, 512, 4096, 8192])
def test_k2_tiles(dev, n2, L, name):
    """K2's four launch names against their plain versions on one-, two-
    and three-lane tiles and the compiled columns (N2 = 512 on 8-lane
    tiles at L 24 and 16-lane tiles at 128; N2 = 256 on 16-lane tiles at
    128), N2 32 to 4096 in registers and
    8192 on the shared-memory body (the form asserted), each block walking
    several columns; float32 planes within FFT_TOL of the peak, bf16
    within one bf16 ulp plus 1e-6 of it."""
    n1 = _k2_columns(n2, L)
    assert dd.k2_form(name, n2, L) == ("register" if n2 <= 4096 else "shared")
    y = randn(dev, (n2, n1, L), 81)
    g = torch.Generator(device=dev)
    g.manual_seed(82)
    theta = torch.rand((n2, n1, L), generator=g, device=dev)
    chirp = (torch.cos(2 * np.pi * theta), torch.sin(2 * np.pi * theta))
    if name != "k2" and name != "k2_theta":
        y = [p.to(torch.bfloat16) for p in y]
    if name == "k2_bf16_chirp":
        chirp = tuple(c.to(torch.bfloat16) for c in chirp)
    dd.reset_launch_counts()
    if name == "k2_theta":
        got = dd.stage_b_theta(*[p.clone() for p in y], theta)
        ref = dd.k2_theta_ref(*[p.clone() for p in y], theta)
    else:
        got = dd.stage_b(*[p.clone() for p in y], *chirp)
        ref = dd.stage_b_ref(*[p.clone() for p in y], *chirp)
    assert {k: v for k, v in dd.launch_counts.items() if v} == {name: 1}
    if name in ("k2", "k2_theta"):
        assert_planes(got, ref)
    else:
        assert_bf16_planes(got, ref)


@pytest.mark.parametrize("engine", ["mx", "pallas", "xla"])
def test_accel_search_on_card(dev, engine):
    """The search on the card (kernels) against the same search on the
    CPU (plain versions), and 'auto' is 'pallas' on the card."""
    from baseband_tasks_tpu_torch.models import accelsearch as acc
    u = pytest.importorskip("baseband_tasks_tpu_torch").units
    n = 1 << 15
    t = np.arange(n) / n
    x = (np.cos(2 * np.pi * (3000 * t + 0.5 * 12.0 * t ** 2))
         + np.random.default_rng(1).standard_normal(n) * 0.5).astype(
             np.float32)
    kw = dict(z_max=24, z_step=2, seg_len=1024, engine=engine)
    card = acc.FourierDomainAccelSearch(n, 1 * u.kHz, **kw)
    assert card.device.type == "cuda"
    dd.reset_launch_counts()
    got = card.search(x)
    want = {"mx": "bank_power", "pallas": "accel_corr", "xla": None}[engine]
    assert {k for k, v in dd.launch_counts.items() if v} == (
        {want} if want else set())
    ref = acc.FourierDomainAccelSearch(n, 1 * u.kHz, device="cpu",
                                       **kw).search(x)
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=2e-4)
    auto = acc.FourierDomainAccelSearch(n, 1 * u.kHz, z_max=24,
                                        seg_len=1024)
    assert auto._engine() == "pallas" and not auto._use_mx()
    dd.reset_launch_counts()
    auto.search(x)
    assert {k: v for k, v in dd.launch_counts.items() if v} == {
        "accel_corr": 1}


def test_sources_default_to_card(dev):
    import baseband_tasks_tpu_torch as bt
    ng = bt.NoiseGenerator(shape=(1000, 2), start_time=bt.Time.from_mjd(
        58000.0), sample_rate=1 * bt.units.kHz, samples_per_frame=100, seed=1)
    assert ng.device.type == "cuda" and ng.read(10).device.type == "cuda"


@pytest.mark.parametrize("n_phase", [16, 32768])
@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("n_window,L", [
    (n, L) for n in (1024, 2048, 4096, 8192) for L in (1, 3, 4, 8, 128)]
    + [(512, 2)])
def test_resident(dev, n_window, L, stokes, n_phase):
    """Both engines against the plain versions: windows 512 to 8192 (the
    register form up to 4096, the shared-memory body for 8192, asserted),
    one-lane tiles (L 1, 3: the partner the lane itself or the next
    tile's), L 4 (the 2048-row Stokes tile is the whole row: the partner
    wraps to lane 0), 8 and 128; the global-atomic fold at 2^15 bins."""
    from baseband_tasks_tpu_torch.ops import dedisperse_resident as dr
    form = dr.resident_form(n_window, L, n_phase, stokes)
    assert form == ("register" if n_window <= 4096 else "shared")
    ps = pe = n_window // 8
    hop, n1, n2 = dr.resident_geometry(n_window, ps, pe)
    T = 3 * hop
    xr, xi = randn(dev, (T, L), 74)
    fr, fi = randn(dev, (ps, L), 75)
    er, ei = randn(dev, (pe, L), 76)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(
        device=dev).manual_seed(77), device=dev)
    cr, ci = torch.cos(2 * np.pi * ph), torch.sin(2 * np.pi * ph)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 97.3), device=dev)
    scale = torch.tensor([0.5], device=dev)
    kw = dict(n_window=n_window, n_phase=n_phase, pad_start=ps, pad_end=pe,
              stokes=stokes)
    args = (xr, xi, fr, fi, er, ei, cr, ci, fold, scale)
    for engine in ("stockham", "mxu"):
        dd.reset_launch_counts()
        prof, cnt = dr.dedisperse_fold_resident(*args, engine=engine, **kw)
        assert dd.launch_counts["resident"] == 1
        with dd.plain_versions():
            rprof, rcnt = dr.dedisperse_fold_resident(*args, engine=engine,
                                                      **kw)
        assert torch.equal(cnt, rcnt) and int(cnt.sum()) == 3 * n_window
        _peak_close(prof, rprof)
    with pytest.raises(ValueError, match="shared-memory"):
        big = 1 << 15
        hop, n1, n2 = dr.resident_geometry(big, 4096, 4096)
        z = torch.zeros((hop, L), device=dev)
        e = torch.zeros((4096, L), device=dev)
        c = torch.zeros((n2, n1, L), device=dev)
        dr.dedisperse_fold_resident(z, z, e, e, e, e, c, c, fold, scale,
                                    n_window=big, n_phase=8, pad_start=4096,
                                    pad_end=4096)


# -- the bf16-intermediate passes and the absorbed reduction ---------------

def assert_bf16_planes(got, ref):
    """bf16 planes of a kernel against the plain version's: within one
    bf16 ulp of the plain value plus 1e-6 of the peak (the float32 values
    before rounding differ by FFT roundoff, so a rounding may flip)."""
    torch.cuda.synchronize()
    peak = max(float(r.float().abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == torch.bfloat16
        g, r = g.float(), r.float()
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
                         - 7)
        assert bool(((g - r).abs() <= ulp + 1e-6 * peak).all())


def _peak_rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("geom", GEOMS[:2] + [((1 << 18) - 8192, 3584,
                                               4608, 128)])
def test_bf16_passes(dev, geom):
    """K1p, K1f, K2 (float32 and bf16 chirp) and K3 (power, Stokes) on
    bf16 planes against their plain versions, each launching its own
    bf16 kernel (K1 on the general kernel and, at the flagship's window,
    the compiled one)."""
    t_main, p0, p1, L = geom
    for name in ("k1_float_bf16", "k1_packed_bf16"):
        k1_form_of(t_main + p0 + p1, L, name)
    words, planes, edges, scale = inputs(dev, t_main, p0, p1, L, 8, seed=9)
    bf16 = torch.bfloat16
    dd.reset_launch_counts()
    y = dd.stage_a(*planes, *edges, scale, out_dtype=bf16)
    assert_bf16_planes(y, dd.stage_a_ref(*planes, *edges, scale,
                                         out_dtype=bf16))
    yp = dd.stage_a_packed(*words, *edges, scale, bits=8, out_dtype=bf16)
    assert_bf16_planes(yp, dd.stage_a_packed_ref(*words, *edges, scale,
                                                 bits=8, out_dtype=bf16))
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    ph = torch.rand(y[0].shape, generator=g, device=dev) * 6.283
    chirp = (torch.cos(ph), torch.sin(ph))
    for c in (chirp, tuple(p.to(bf16) for p in chirp)):
        z = dd.stage_b(*[p.clone() for p in y], *c)
        assert_bf16_planes(z, dd.stage_b_ref(*[p.clone() for p in y], *c))
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 97.0), device=dev)
    kw = dict(n_phase=64, pad_start=p0, n_valid=t_main)
    for stokes in (False, True):
        prof, cnt = dd.detect_fold(*z, fold, stokes=stokes, **kw)
        rprof, rcnt = dd.fold_ref(*z, fold, stokes=stokes, **kw)
        assert torch.equal(cnt, rcnt)
        assert _peak_rel(prof, rprof) <= 1e-5
    assert {k: v for k, v in dd.launch_counts.items() if v} == dict(
        k1_float_bf16=1, k1_packed_bf16=1, k2_bf16=1, k2_bf16_chirp=1,
        k3_fold_bf16=1, k3_fold_stokes_bf16=1)


@pytest.mark.parametrize("stokes", [False, True])
def test_bf16_split_op_on_card(dev, stokes):
    """dedisperse_fold_split(_packed) in bf16 mode on the card: the bf16
    kernels, against the plain bf16 path and the float32 kernels (1e-3 of
    the peak, the bar of TestBF16Intermediates, which holds where a bin
    averages a few hundred samples: 896 here), counts exact."""
    t_main, p0, p1, L = 7168, 512, 512, 128
    words, planes, edges, scale = inputs(dev, t_main, p0, p1, L, 8, seed=11)
    n1, n2 = dd.split_n(8192)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(
        device=dev).manual_seed(12), device=dev) * 6.283
    chirp = (torch.cos(ph), torch.sin(ph))
    fold = torch.as_tensor(dd.fold_phase_vector(0.1, 1.0 / 97.0), device=dev)
    kw = dict(n_phase=8, pad_start=p0, n_valid=t_main, stokes=stokes)
    for op, x in ((dd.dedisperse_fold_split, planes),
                  (dd.dedisperse_fold_split_packed, words)):
        for c in (chirp, tuple(p.to(torch.bfloat16) for p in chirp)):
            dd.reset_launch_counts()
            prof, cnt = op(*x, *edges, *c, fold, scale,
                           inter_dtype="bfloat16", **kw)
            launched = {k for k, v in dd.launch_counts.items() if v}
            assert all(k.endswith(("_bf16", "_bf16_chirp"))
                       for k in launched) and len(launched) == 3
            with dd.plain_versions():
                rprof, rcnt = op(*x, *edges, *c, fold, scale,
                                 inter_dtype="bfloat16", **kw)
            f32 = op(*x, *edges, *chirp, fold, scale, **kw)
            assert torch.equal(cnt, rcnt) and torch.equal(cnt, f32[1])
            assert _peak_rel(prof, rprof) < 1e-3
            assert _peak_rel(prof, f32[0]) < 1e-3


def test_bf16_refusals(dev):
    bf16 = torch.bfloat16
    y = [torch.randn((32, 32, 128), device=dev).to(bf16) for _ in (0, 1)]
    c = [torch.randn((32, 32, 128), device=dev) for _ in (0, 1)]
    fold = torch.as_tensor(dd.fold_phase_vector(0.1, 0.01), device=dev)
    # stage B works in place: y and z planes of one dtype only
    with pytest.raises(TypeError, match="share one dtype"):
        dd.stage_b(y[0], y[1].float(), *c)
    with pytest.raises(TypeError, match="share one dtype"):
        dd.detect_fold(y[0].float(), y[1], fold, n_phase=8, pad_start=0,
                       n_valid=1024)
    with pytest.raises(TypeError, match="expected one of"):
        dd.stage_b(y[0].float(), y[1].float(), c[0].to(bf16), c[1].to(bf16))
    strided = torch.randn((32, 32, 256), device=dev).to(bf16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        dd.stage_b(strided, y[1], *c)
    odd = torch.empty(32 * 32 * 128 + 1, dtype=bf16, device=dev)[1:]
    with pytest.raises(ValueError, match="4-byte"):
        dd.detect_fold(odd.view(32, 32, 128), y[1], fold, n_phase=8,
                       pad_start=0, n_valid=1024)


@pytest.mark.parametrize("masked", [False, True])
def test_reduction_on_card(dev, masked):
    """The absorbed reduction on the card (Square -> Fold, and config 1's
    Channelize -> Square -> Integrate) against the same runs on the
    CPU: counts and NaN cells exact, sums rtol 1e-5."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.models.compiled import CompiledPipeline
    u = bt.units
    t0 = bt.Time.from_mjd(58000.0)
    rng = np.random.default_rng(13)
    data = rng.standard_normal((1 << 14, 8)).astype(np.float32) + 2.0
    data[:, 3] = np.nan
    data[100:300, 5] = np.nan
    if not masked:
        data = np.nan_to_num(data, nan=1.0)

    def chain(device):
        src = bt.StreamGenerator(
            lambda sh: data[sh.tell():sh.tell() + 4096], shape=data.shape,
            start_time=t0, sample_rate=1 * u.MHz, samples_per_frame=4096,
            dtype=np.float32, device=device)
        phase = (lambda t: u.Quantity((t - t0).sec * 12345.6, u.cycle))
        return bt.Fold(bt.Square(src), 8, phase, u.Quantity(4096e-6, u.s),
                       samples_per_frame=1, masked=masked)

    outs = {}
    for device in ("cpu", dev):
        tail = chain(device)
        cp = CompiledPipeline(tail, block_samples=4096)
        outs[str(device)] = cp.run_reduced(cp.read_source_blocks(4))
        tail.seek(0)
        eager = tail.read(4)
    (avg, cnt), (ravg, rcnt) = outs[str(dev)], outs["cpu"]
    assert avg.device.type == "cuda"
    assert torch.equal(cnt.cpu(), rcnt)
    assert torch.equal(avg.isnan().cpu(), ravg.isnan())
    torch.testing.assert_close(avg.cpu(), ravg, rtol=1e-5, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(avg, eager, rtol=1e-5, atol=0, equal_nan=True)
    if masked:
        assert bool(avg[..., 3].isnan().all())
        assert bool(avg[..., :3].isfinite().all())
    # config 1 at a small size: compiled on the card against eager there
    noise = bt.NoiseGenerator(shape=(1 << 16,), start_time=t0,
                              sample_rate=16 * u.MHz, samples_per_frame=4096,
                              seed=7, device=dev)
    tail = bt.Integrate(bt.Square(bt.Channelize(noise, 256)), 16,
                        masked=masked)
    cp = CompiledPipeline(tail, block_samples=1 << 14)
    avg, cnt = cp.run_reduced(cp.read_source_blocks(4))
    tail.seek(0)
    eager = tail.read()
    assert avg.device.type == "cuda" and tuple(avg.shape) == (16, 256)
    assert bool((cnt == 16).all())
    torch.testing.assert_close(avg, eager, rtol=1e-5, atol=0)


# -- the mesh layer and the halo_remote kernel -------------------------------

def _halo_case(dev, shape, dtype, rows, seed):
    """A (time, ring) grid of random blocks of ``rows`` rows on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        if dtype.is_complex:
            b = torch.randn((rows, 3, 2), generator=g, device=dev,
                            dtype=torch.complex64)
        elif dtype.is_floating_point:
            b = torch.randn((rows, 3, 5), generator=g, device=dev
                            ).to(dtype)
        else:
            b = torch.randint(-99, 99, (rows, 7), generator=g, device=dev,
                              dtype=dtype)
        grid[idx] = b
    return grid


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pads", [(6, 4), (5, 0), (0, 3), (16, 16)])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 3), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.bfloat16, torch.int8])
def test_halo_remote(dev, dtype, shape, pads, periodic):
    """The kernel against its plain version on virtual shards of one
    card, bit for bit, one launch for every ring of the grid, with rows
    of 48 B (complex64), 60 B (float32), 30 B (bf16) and 7 B (int8): the
    16-byte, 4-byte and 1-byte moves, as the byte counts allow."""
    from baseband_tasks_tpu_torch.parallel import halo_remote as hr
    grid = _halo_case(dev, shape, dtype, 16, seed=sum(pads) + 7)
    dd.reset_launch_counts()
    front, end = hr.halo_edges_remote(grid, *pads, periodic=periodic)
    assert dd.launch_counts["halo_remote"] == (1 if any(pads) else 0)
    rfront, rend = hr.halo_edges_remote_ref(grid, *pads, periodic=periodic)
    torch.cuda.synchronize()
    for got, ref in zip((*front.flat, *end.flat), (*rfront.flat, *rend.flat)):
        assert got.device == ref.device and got.dtype == ref.dtype
        assert torch.equal(got, ref)


def test_halo_remote_flagship_planes(dev):
    """The flagship float path's shapes: four shards of (253,952, 128)
    float32 planes, pads 3584 / 4608."""
    from baseband_tasks_tpu_torch import parallel as par
    x = torch.randn((4 * 253952, 128), device=dev)
    blocks = list(x.chunk(4))
    front, end = par.halo_edges_remote(blocks, 3584, 4608)
    rfront, rend = par.halo_edges_remote_ref(blocks, 3584, 4608)
    for got, ref in zip(front + end, rfront + rend):
        assert torch.equal(got, ref)
    assert not front[0].any() and not end[3].any()
    assert torch.equal(front[1], blocks[0][-3584:])


def test_halo_remote_refuses_rather_than_falls_back(dev, monkeypatch):
    """On the card halo='remote' launches its kernel or raises: with the
    kernel library broken it raises; shards split between the card and
    the CPU are refused; the pipeline's planes step refuses it."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import parallel as par
    from baseband_tasks_tpu_torch.ops import _build
    blocks = [torch.randn((16, 4), device=dev) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA device"):
        par.halo_edges_remote([blocks[0], blocks[1].cpu()], 2, 2)

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    from baseband_tasks_tpu_torch.parallel import halo_remote as hr
    monkeypatch.setattr(hr, "library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        par.halo_edges_remote(blocks, 2, 2)
    u = bt.units
    pipe = bt.WidebandPulsarPipeline(
        n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
        block_samples=1024, use_kernels=True, halo="remote",
        mesh=par.make_mesh(2, 1, devices=[dev] * 2))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pipe.run_fn(1)(seed=0)


def _assert_fold_order_close(got, ref, cnt, detect):
    """Two folds of the same samples in different atomic orders.  Power
    bins hold positive terms only: rtol PROFILE_RTOL.  Stokes adds,
    elementwise, the float32 summation bound of each bin: two float32
    sums of the same n terms in any two orders differ by at most
    2 (n - 1) 2^-24 times the terms' summed magnitude; a bin's terms are
    the samples folded into it (``cnt`` per phase bin), and |Re XY*|,
    |Im XY*| <= (|X|^2 + |Y|^2) / 2, so a cross-term bin's summed
    magnitude is at most (XX + YY) / 2 of the same bin.  Q/U/V bins of
    noise sum to nearly zero, so a bound relative to the bin alone cannot
    hold there under reordering."""
    if detect != "stokes":
        torch.testing.assert_close(got, ref, rtol=PROFILE_RTOL, atol=0.0)
        return
    n = cnt.to(ref.dtype).reshape(-1, 1, 1)
    half_i = (ref[..., 0:1] + ref[..., 1:2]) / 2
    mag = torch.cat([ref[..., 0:2], half_i, half_i], dim=-1)
    bound = (PROFILE_RTOL * ref.abs()
             + 2 * (n - 1).clamp_min(0) * 2.0 ** -24 * mag)
    err = (got - ref).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("detect", ["power", "stokes"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_pipeline_on_card(dev, shape, detect):
    """The sharded flagship with every shard on one card: 'remote'
    against 'ppermute' (step_fn on both paths bit for bit, run_fn's
    profiles to the fold's atomic-order bound, counts exact), the
    halo_remote launches (one per step_fn step, two per float run_fn
    step, none for packed ingest), and the kernels against the plain
    versions."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import parallel as par
    u = bt.units
    mesh = par.make_mesh(*shape, devices=[dev] * 4)
    kw = dict(n_chan=8, n_pol=2, dm=1.0, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, period_samples=(800, 1), n_phase=16,
              block_samples=1024, mesh=mesh, detect=detect)
    pipes = {(k, h): bt.WidebandPulsarPipeline(use_kernels=k, halo=h, **kw)
             for k in (False, True) for h in ("ppermute", "remote")}
    for kernels in (False, True):
        T = pipes[kernels, "remote"].global_block
        xf = torch.randn((T, 8, 2, 2), generator=torch.Generator(
            device=dev).manual_seed(46), device=dev)
        dd.reset_launch_counts()
        got = pipes[kernels, "remote"].step_fn()(xf, 300)
        assert dd.launch_counts["halo_remote"] == 1
        want = pipes[kernels, "ppermute"].step_fn()(xf, 300)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[1].sum()) == T
    T = pipes[True, "remote"].global_block
    for bits, halo_launches in ((None, 2 * 3), (8, 0)):
        dd.reset_launch_counts()
        prof, cnt = pipes[True, "remote"].run_fn(3, ingest_bits=bits)(seed=1)
        assert dd.launch_counts["halo_remote"] == halo_launches
        rprof, rcnt = pipes[True, "ppermute"].run_fn(3, ingest_bits=bits)(
            seed=1)
        assert torch.equal(cnt, rcnt) and int(cnt.sum()) == 3 * T
        _assert_fold_order_close(prof, rprof, rcnt, detect)
        with dd.plain_versions():
            pprof, pcnt = pipes[True, "remote"].run_fn(
                3, ingest_bits=bits)(seed=1)
        assert torch.equal(cnt, pcnt)
        torch.testing.assert_close(prof, pprof, rtol=PROFILE_RTOL,
                                   atol=1e-6 * float(pprof.abs().max()))


def test_sharded_searches_on_card(dev):
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import parallel as par
    from baseband_tasks_tpu_torch.models import accelsearch as pacc
    from baseband_tasks_tpu_torch.models import ffa as pffa
    n = 1 << 13
    t = np.arange(n) / n
    x = (np.cos(2 * np.pi * (700 * t + 5.0 * t ** 2))
         + np.random.default_rng(3).standard_normal(n) * 0.3
         ).astype(np.float32)
    mesh = par.Mesh([dev] * 4, ("z",))
    for engine, launched in (("mx", "bank_power"), ("pallas", "accel_corr")):
        s = pacc.FourierDomainAccelSearch(n, 1 * bt.units.kHz,
                                          engine=engine, z_max=24,
                                          z_step=2, seg_len=512, device=dev)
        dd.reset_launch_counts()
        got = s.search_sharded(x, mesh)
        assert dd.launch_counts[launched] == 4
        _peak_close(got, s.search(x))
    f = pffa.FastFoldingSearch(20, 4096, device=dev)
    rows = np.random.default_rng(4).standard_normal((6, 4096)).astype(
        np.float32)
    got = f.snr_sharded(rows, par.Mesh([dev] * 4, ("batch",)))
    torch.testing.assert_close(got, f.snr(rows), rtol=1e-5, atol=1e-5)


def test_halo_remote_two_cards():
    """Shards on two cards: the kernel reads the neighbour's block through
    a peer pointer after the streams are fenced.  Needs two cards with
    peer access; skips otherwise."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    if not torch.cuda.can_device_access_peer(0, 1):
        pytest.skip("cuda:0 cannot read cuda:1")
    from baseband_tasks_tpu_torch import parallel as par
    devs = [torch.device("cuda", i % 2) for i in range(4)]
    blocks = [torch.randn((4096, 128), device=d) for d in devs]
    for periodic in (False, True):
        dd.reset_launch_counts()
        front, end = par.halo_edges_remote(blocks, 512, 768, periodic)
        assert dd.launch_counts["halo_remote"] == 2      # one per card
        rfront, rend = par.halo_edges_remote_ref(blocks, 512, 768, periodic)
        for got, ref in zip(front + end, rfront + rend):
            assert got.device == ref.device and torch.equal(got, ref)


# -- stored baseband: packed ingest and the runner ------------------------------

C4_THREADS, C4_RATE = 16, 1 << 18      # config 4: 8 channels x 2 pols


def _config4_file(tmp_path, n, spf, seed=11):
    """A VDIF file of config 4's layout: 16 threads of 8-bit complex noise
    at 2^18 Hz, frames of ``spf``; written on the host."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.io import vdif
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C4_THREADS, 2)).astype(np.float32) * 16
    data = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    src = bt.NoiseGenerator(shape=data.shape,
                            start_time=bt.Time.from_mjd(58000.0),
                            sample_rate=C4_RATE * bt.units.Hz,
                            samples_per_frame=spf, device="cpu")
    path = str(tmp_path / "c4.vdif")
    with vdif.open(path, "w", template=src, bps=8,
                   samples_per_frame=spf) as fw:
        fw.write(data)
    return path


def _config4_chain(path, dev, block):
    """Config 4's chain on a reader on ``dev``: Dedisperse(29.7) ('auto':
    'pallas' on the card) -> Square -> Integrate(1024)."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    fr = bt.open(path, sample_rate=C4_RATE * u.Hz, device=dev)
    freq = (1400 + 0.262144 * (np.arange(C4_THREADS) // 2)) * u.MHz
    ded = bt.Dedisperse(bt.SetAttribute(fr, frequency=freq, sideband=1),
                        29.7, samples_per_frame=block)
    return fr, ded, bt.Integrate(bt.Square(ded), 1024)


@pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")
def test_runner_modes_on_card(dev, tmp_path):
    """StreamRunner's three modes from a VDIF file on the card (packed,
    float, planes) against ``run_fn`` of the same pipeline on the card
    and on the plain versions: counts exact, sums to the float32
    summation bound of a 1024-sample bin (and of the fold order), the
    launches one k1_window (k1_stream for planes), k2 and k3_trim a
    block; packed against float as config 4 holds them."""
    from baseband_tasks_tpu_torch import CompiledPipeline, StreamRunner
    n_blocks, block, spf = 4, 7424, 256
    path = _config4_file(tmp_path, (n_blocks + 1) * block, spf)
    fr, ded, tail = _config4_chain(path, dev, block)
    with fr:
        assert ded.engine == "pallas" and ded.samples_per_frame == block
        cps = {"packed": CompiledPipeline(tail, packed=True),
               "float": CompiledPipeline(tail)}
        out = {}
        for mode, cp, planes, k1 in (("packed", cps["packed"], False,
                                      "k1_window"),
                                     ("float", cps["float"], False,
                                      "k1_window"),
                                     ("planes", cps["float"], True,
                                      "k1_stream")):
            runner = StreamRunner(cp, planes=planes)
            dd.reset_launch_counts()
            sums, counts = runner.run(n_blocks)
            torch.cuda.synchronize()
            launched = {k: v for k, v in dd.launch_counts.items() if v}
            assert launched == {k1: n_blocks, "k2": n_blocks,
                                "k3_trim": n_blocks}, (mode, launched)
            assert sums.device == counts.device == fr.device
            blocks = cp.read_source_blocks(n_blocks)
            ref = cp.run_fn(n_blocks)(blocks)
            with dd.plain_versions():
                plain = cp.run_fn(n_blocks)(blocks)
            for want in (ref, plain):
                assert torch.equal(counts, want[1])
                torch.testing.assert_close(sums, want[0],
                                           rtol=PROFILE_RTOL, atol=1e-6)
            out[mode] = sums, counts
        for mode in ("float", "planes"):
            assert torch.equal(out["packed"][1], out[mode][1])
            torch.testing.assert_close(out["packed"][0], out[mode][0],
                                       rtol=1e-4, atol=1e-6)


def test_runner_device_source_on_card(dev):
    """A source that reads onto the card (a NoiseGenerator on CUDA) is
    read on the copy stream and passed through: exactly run_blocks."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import CompiledPipeline, StreamRunner
    src = bt.NoiseGenerator(shape=(1 << 15, 16),
                            start_time=bt.Time.from_mjd(58000.0),
                            sample_rate=1 * bt.units.MHz,
                            samples_per_frame=4096, seed=4, device=dev)
    cp = CompiledPipeline(bt.Square(bt.Channelize(src, 64)))
    n = (1 << 15) // cp.block_samples
    got = StreamRunner(cp, prefetch=1).run(n)
    want = cp.run_blocks(cp.read_source_blocks(n))
    assert got.device == want.device and torch.equal(got, want)


def test_pinned_ring_waits_for_its_copy(dev):
    """The runner's ring never refills a pinned slot whose copy to the
    card is still queued: with one slot, a copy held back on the copy
    stream, the next block waits for it, and the first block arrives
    intact."""
    from baseband_tasks_tpu_torch.models.runner import _PinnedRing
    ring = _PinnedRing(dev, 1)
    compute = torch.cuda.current_stream(dev)
    a = np.arange(1 << 20, dtype=np.int32)
    b = -a
    with torch.cuda.stream(ring.stream):
        torch.cuda._sleep(1 << 28)       # ~0.1-0.2 s before the copy
    da, ea = ring.ship(a, compute)
    assert not ea.query()                # still queued behind the sleep
    db, eb = ring.ship(b, compute)       # the same slot: waits for a's copy
    assert ea.query()
    compute.wait_event(eb)
    torch.cuda.synchronize()
    assert np.array_equal(da.cpu().numpy(), a)
    assert np.array_equal(db.cpu().numpy(), b)
    pair = (a.reshape(1024, 1024) > 3, np.ones((8, 2), np.float32))
    dp, _ = ring.ship(pair, compute)
    torch.cuda.synchronize()
    assert dp[0].dtype == torch.bool and torch.equal(
        dp[0].cpu(), torch.from_numpy(pair[0]))


def test_config4_kernels_16_lanes(dev):
    """k1_window, k2, k3_trim and k1_stream at config 4's shapes (a 2^17
    window of 16 lanes, pads 512/512: N1 = 256, N2 = 512) against their
    plain versions."""
    n, L, pad = 1 << 17, 16, 512
    n1, n2 = dd.split_n(n)
    x = randn(dev, (n, L), 41)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(device=dev
                                                           ).manual_seed(42),
                    device=dev) * 6.283
    g = (torch.cos(ph), torch.sin(ph))
    dd.reset_launch_counts()
    y = ff.k1_window(*x)
    assert_planes(y, ff.k1_window_ref(*x))
    yk = dd.stage_b(*(t.clone() for t in y), *g)
    yr = dd.stage_b_ref(*(t.clone() for t in y), *g)
    assert_planes(yk, yr)
    assert_planes(ff.k3_trim(*yr, pad_start=pad, pad_end=pad),
                  ff.k3_trim_ref(*yr, pad_start=pad, pad_end=pad))
    c = randn(dev, (2 * pad, L), 43)
    blk = randn(dev, (n - 2 * pad, L), 44)
    assert_planes(ff.k1_stream(*c, *blk), ff.k1_stream_ref(*c, *blk))
    assert {k: v for k, v in dd.launch_counts.items() if v} == {
        "k1_window": 1, "k2": 1, "k3_trim": 1, "k1_stream": 1}


# -- the analysis slice beyond the reference (smoke phases (v1), (v4)) ------

def frb_power(device, n=1 << 18):
    """Smoke (v1)'s FRB chain at a small size: seeded complex noise with a
    burst, 16 MHz around 800 MHz -> Disperse(2.0, 'pallas') ->
    Channelize(64) -> Square.  Returns (Disperse node, tail)."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    rng = np.random.default_rng(42)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    x[20000:20006] += 40.0
    src = bt.StreamGenerator(lambda sh: x[sh.tell():sh.tell() + 8192],
                             shape=(n,), start_time=bt.Time.from_mjd(58000.0),
                             sample_rate=16 * u.MHz, samples_per_frame=8192,
                             dtype=np.complex64, device=device)
    ded = bt.Disperse(bt.SetAttribute(src, frequency=800 * u.MHz,
                                      sideband=1), 2.0, engine="pallas",
                      samples_per_frame=1 << 15)
    return ded, bt.Square(bt.Channelize(ded, 64))


def test_frb_chain_on_card(dev):
    """The FRB path: 'pallas' Disperse on one lane launches k1_window, k2
    and k3_trim once a frame; the filterbank and the DM-trial search map
    equal the plain versions on the card (1e-4 of the peak) and the
    search on the CPU (1e-5 of the peak)."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.models import DMTrialSearch
    ded, power = frb_power(dev)
    frames = -(-ded.shape[0] // ded.samples_per_frame)
    assert ded.engine == "pallas"
    dd.reset_launch_counts()
    got = power.read()
    torch.cuda.synchronize()
    assert {k: v for k, v in dd.launch_counts.items() if v} == \
        {k: frames for k in ("k1_window", "k2", "k3_trim")}
    with dd.plain_versions():
        want = frb_power(dev)[1].read()
    assert float((got - want).abs().max()) <= \
        FFT_TOL * float(want.abs().max())
    freq = np.asarray(power.frequency.to_value(bt.units.MHz)).reshape(-1)
    search = {d: DMTrialSearch(freq * bt.units.MHz, power.sample_rate,
                               np.linspace(0, 4, 9), 1024, device=d)
              for d in (dev, "cpu")}
    maps = {d: s.search(got[:1024]) for d, s in search.items()}
    assert maps[dev].device == dev
    ref = maps["cpu"]
    assert float((maps[dev].cpu() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())
    with dd.plain_versions():
        plain_map = search[dev].search(want[:1024])
    assert float((maps[dev] - plain_map).abs().max()) <= \
        FFT_TOL * float(plain_map.abs().max())


def test_defaraday_planes_chain_on_card(dev, monkeypatch):
    """Smoke (v4) at a small size: DeFaraday behind a 'pallas' Dedisperse
    in a compiled planes chain takes its planes form (task_planes once a
    block) while k1_stream, k2 and k3_trim launch once a block, and
    equals the complex step and the plain versions (1e-4 of the peak)."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.models.compiled import CompiledPipeline
    u = bt.units

    def chain():
        src = bt.NoiseGenerator(shape=(1 << 16, 8, 2),
                                start_time=bt.Time.from_mjd(58000.0),
                                sample_rate=250 * u.kHz,
                                samples_per_frame=4096, seed=5, device=dev)
        freq = (1400 + 0.25 * (np.arange(8) - 4))[:, None] * u.MHz
        src = bt.SetAttribute(src, frequency=freq, sideband=1,
                              polarization=np.array(["X", "Y"]))
        ded = bt.Dedisperse(src, 20.0, engine="pallas",
                            samples_per_frame=1 << 13)
        far = bt.DeFaraday(ded, 100.0, basis="linear")
        return far, CompiledPipeline(bt.Square(far))

    far, cp = chain()
    calls = []
    orig = far.task_planes
    monkeypatch.setattr(far, "task_planes",
                        lambda pair: calls.append(1) or orig(pair))
    blocks = cp.read_source_blocks(2)

    def planes(pipe):
        step, carry = pipe.planes_step(), pipe.init_carry(planes=True)
        out = []
        for b in blocks:
            carry, (yr, yi) = step(carry, b)
            out.append(yr)
        return torch.cat(out)

    dd.reset_launch_counts()
    got = planes(cp)
    torch.cuda.synchronize()
    assert {k: v for k, v in dd.launch_counts.items() if v} == \
        {k: 2 for k in ("k1_stream", "k2", "k3_trim")}
    assert len(calls) == 2
    want = cp.run_blocks(blocks)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= FFT_TOL * peak
    with dd.plain_versions():
        plain = planes(chain()[1])
    assert float((got - plain).abs().max()) <= FFT_TOL * peak


def test_analysis_tasks_on_card(dev):
    """The tasks and models beyond the reference on CUDA tensors equal
    the same calls on the CPU: Faraday (both forms), polarization, SK
    flags (exact), RM synthesis and the secondary spectrum (1e-5 of the
    peak)."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import rfi
    from baseband_tasks_tpu_torch.models import RMSynthesis, secondary_spectrum
    u = bt.units
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4096, 16, 2))
         + 1j * rng.standard_normal((4096, 16, 2))).astype(np.complex64)
    x[:, 3] += 10.0

    def tasks(device):
        src = bt.StreamGenerator(lambda sh: x[sh.tell():sh.tell() + 1024],
                                 shape=x.shape,
                                 start_time=bt.Time.from_mjd(58000.0),
                                 sample_rate=1 * u.MHz,
                                 samples_per_frame=1024, dtype=np.complex64,
                                 device=device)
        src = bt.SetAttribute(src, frequency=(400 + np.arange(16))[:, None]
                              * u.MHz, sideband=1,
                              polarization=np.array(["X", "Y"]))
        far = bt.FaradayRotate(src, 3.0)
        jones = bt.ApplyJones(bt.ConvertPolarization(far, "circular"),
                              np.array([[1.1, 0.1j], [0.05, 0.9]]))
        return far, bt.ExciseSpectralKurtosis(jones, 64)

    (fc, ec), (fg, eg) = tasks("cpu"), tasks(dev)
    close = lambda a, b: float((a.cpu() - b).abs().max()) <= \
        1e-5 * float(b.abs().max())  # noqa: E731
    assert close(fg.read(), fc.read())
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    pr, pi = fg.task_planes((xr.to(dev), xi.to(dev)))
    cr, ci = fc.task_planes((xr, xi))
    assert close(pr, cr) and close(pi, ci)
    got, want = eg.read(), ec.read()
    assert torch.equal(got.cpu() == 0, want == 0)
    assert close(got, want)
    power = torch.from_numpy(np.abs(x[..., 0]) ** 2)
    assert torch.equal(rfi.spectral_kurtosis(power.to(dev), 64).cpu() > 1.5,
                       rfi.spectral_kurtosis(power, 64) > 1.5)
    freq = (1200 + np.arange(64)) * u.MHz
    q, uu = rng.standard_normal((2, 32, 64)).astype(np.float32)
    fdf = {d: RMSynthesis(freq, np.linspace(-50, 50, 101), device=d).fdf(
        q, uu) for d in (dev, "cpu")}
    assert fdf[dev].device == dev and close(fdf[dev], fdf["cpu"])
    d = rng.standard_normal((128, 96)).astype(np.float32) + 10
    S = {k: secondary_spectrum(torch.from_numpy(d).to(k))[0]
         for k in (dev, "cpu")}
    assert S[dev].device == dev and close(S[dev], S["cpu"])


def test_analysis_numpy_input_on_card(dev):
    """Numpy given to the analysis entry points with no device comes
    back on the card, equal to the same call on a CPU tensor (Stokes
    exact; SK and the transforms to 1e-5 of the peak, float32
    roundoff)."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch import rfi
    from baseband_tasks_tpu_torch.models import (DMTrialSearch,
                                                 RMSynthesis,
                                                 secondary_spectrum)
    u = bt.units
    rng = np.random.default_rng(11)
    cpu = torch.device("cpu")

    def same(got, want, tol=0.0):
        assert got.device == dev
        assert float((got.cpu() - want).abs().max()) <= \
            tol * float(want.abs().max())

    power = rng.standard_normal((1024, 8)).astype(np.float32) ** 2
    same(rfi.spectral_kurtosis(power, 64),
         rfi.spectral_kurtosis(torch.from_numpy(power), 64), 1e-5)
    stokes = rng.standard_normal((16, 32, 4)).astype(np.float32)
    for a, b in zip(RMSynthesis.stokes_qu(stokes),
                    RMSynthesis.stokes_qu(torch.from_numpy(stokes))):
        same(a, b)
    dyn = rng.standard_normal((128, 96)).astype(np.float32) + 10
    same(secondary_spectrum(dyn)[0],
         secondary_spectrum(torch.from_numpy(dyn))[0], 1e-5)
    freq = (1200 + np.arange(32)) * u.MHz
    q, uu = rng.standard_normal((2, 8, 32)).astype(np.float32)
    rm = {d: RMSynthesis(freq, np.linspace(-50, 50, 101), device=d)
          for d in (None, cpu)}
    same(rm[None].fdf(q, uu), rm[cpu].fdf(q, uu), 1e-5)
    block = rng.standard_normal((1024, 32)).astype(np.float32) ** 2
    dm = {d: DMTrialSearch(freq, 10 * u.kHz, np.linspace(0, 2, 5), 1024,
                           device=d) for d in (None, cpu)}
    same(dm[None].search(block), dm[cpu].search(block), 1e-5)


def config2_small(device, n=9 * 7424 + 3712, spf=4096):
    """A small config-2 chain (Dechannelize of a 'pallas' Dedisperse, 8
    channels of 125 kHz: an 8192 window, blocks of 7424) on ``device``,
    9.5 blocks long."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    freq = (1400 + (np.arange(8) - 4) * 0.125) * u.MHz
    src = bt.SetAttribute(bt.NoiseGenerator(
        shape=(n, 8), start_time=bt.Time.from_mjd(58000.0),
        sample_rate=125 * u.kHz, samples_per_frame=2048, seed=1,
        device=device), frequency=freq, sideband=1)
    return bt.Dechannelize(bt.Dedisperse(src, 29.7, samples_per_frame=spf,
                                         engine="pallas"))


def test_sharded_config2_step_on_card(dev):
    """Smoke (w1) at a small size: ``ShardedPipeline`` on four virtual
    shards of the card launches what the one-device complex step launches
    (k1_window, k2, k3_trim, lane_mix once a block) and gives its output
    bit for bit, each shard's block on its shard's device; the view of
    ``compile(mesh=)`` equals the one-device view where both compile."""
    from baseband_tasks_tpu_torch.models import (CompiledPipeline,
                                                 ShardedPipeline)
    from baseband_tasks_tpu_torch.parallel import make_mesh
    cp = CompiledPipeline(config2_small(dev))
    mesh = make_mesh(time=4, devices=[dev] * 4)
    sp = ShardedPipeline(cp, mesh)
    blocks = cp.read_source_blocks(8)
    dd.reset_launch_counts()
    got = sp.run_blocks(blocks)
    torch.cuda.synchronize()
    counts = {k: v for k, v in dd.launch_counts.items() if v}
    dd.reset_launch_counts()
    ref = cp.run_blocks(blocks)
    torch.cuda.synchronize()
    assert counts == {k: v for k, v in dd.launch_counts.items() if v} == \
        {k: 8 for k in ("k1_window", "k2", "k3_trim", "lane_mix")}
    assert torch.equal(got, ref)
    carry, ys = sp.sharded_step()(cp.init_carry(),
                                  [blocks[i] for i in range(4)])
    assert [y.device for y in ys] == [dev] * 4
    assert all(c.device == dev for c in carry)
    view = config2_small(dev).compile(mesh=mesh)
    single = config2_small(dev).compile()
    a, b = view.read(), single.read()
    hi = view._max_blocks * cp.tail_block - int(cp.delay)
    assert view._S == 4 and a.device == dev
    assert torch.equal(a[:hi], b[:hi])


def filterbank_template(rng):
    """A (4096, 16) detected filterbank and a stream template of it."""
    import baseband_tasks_tpu_torch as bt
    u = bt.units
    power = (rng.standard_normal((4096, 16)) ** 2).astype(np.float32)

    def frames(sh):
        return power[sh.tell():sh.tell() + sh.samples_per_frame]
    gen = bt.SetAttribute(bt.StreamGenerator(
        frames, power.shape, bt.Time.from_mjd(58000.0), 1 * u.kHz,
        samples_per_frame=1024, dtype=np.float32, device="cpu"),
        frequency=(800 + np.arange(16)) * u.MHz, sideband=1)
    return power, gen


def test_stored_file_readers_on_card(dev, tmp_path):
    """PSRFITS (fold and search mode) readers hand out CUDA tensors equal
    to their host reads; the HDF5 bit-packed decoder on the card equals
    the host decode bit for bit (no file: the card's machine may lack
    h5py)."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.io import hdf5, psrfits
    from baseband_tasks_tpu_torch.ops import unpack as up
    u = bt.units
    rng = np.random.default_rng(5)
    power, gen = filterbank_template(rng)
    path = str(tmp_path / "s.fits")
    with psrfits.open(path, "w", obs_mode="search", template=gen,
                      nsblk=1024, nbits=8) as fw:
        fw.write(power)
    with bt.open(path, device=dev) as fh:
        got = fh.read()
        assert got.device == dev
        assert torch.equal(got.cpu(), torch.from_numpy(
            fh.read_host(0, fh.shape[0])))
    prof = rng.standard_normal((2, 32, 16, 1)).astype(np.float32)
    fold = bt.SetAttribute(bt.EmptyStreamGenerator(
        shape=prof.shape, start_time=bt.Time.from_mjd(58000.0),
        sample_rate=0.1 * u.Hz, samples_per_frame=1, dtype=np.float32,
        device="cpu"), frequency=(800 + np.arange(16))[:, None] * u.MHz,
        sideband=1)
    path = str(tmp_path / "f.fits")
    with psrfits.open(path, "w", template=fold) as fw:
        fw.write(torch.from_numpy(prof).to(dev))
    with bt.open(path, device=dev) as fh:
        got = fh.read()
        assert got.device == dev
        assert float((got.cpu() - torch.from_numpy(prof)).abs().max()) <= \
            float(np.ptp(prof)) / 65534
    x = rng.standard_normal((4096, 4, 2)).astype(np.float32)
    data = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    for bps in (8, 4, 2):
        scale = {8: 32.0, 4: 2.5, 2: 1.0}[bps] / float(np.std(x))
        raw = hdf5._encode(data * scale, "bps", bps)
        host = hdf5.host_decode(raw, bps, data.dtype, data.shape, scale)
        dec = hdf5.packed_decoder(bps, (4,), True, scale)(
            torch.from_numpy(up.words_from_bytes(raw)).to(dev))
        assert dec.device == dev and torch.equal(dec.cpu(),
                                                 torch.from_numpy(host))


def test_hdf5_file_on_card(dev, tmp_path):
    """An HDF5 file's reader hands out CUDA tensors, and its packed words
    decode on the card to them bit for bit (skips without h5py)."""
    pytest.importorskip("h5py")
    import baseband_tasks_tpu_torch as bt
    power, gen = filterbank_template(np.random.default_rng(5))
    path = str(tmp_path / "b.h5")
    with bt.open(path, "w", format="hdf5", template=gen, bps=8) as fw:
        fw.write(power)
    with bt.open(path, device=dev) as fh:
        got = fh.read()
        assert got.device == dev
        words = torch.from_numpy(fh.read_packed(0, 4096)).to(dev)
        assert torch.equal(fh.packed_decode_fn()(words), got)


def test_two_processes_on_one_card(dev, tmp_path):
    """Two processes on the one card through the transport (gloo, CUDA
    tensors staged through pinned host slots): the halo exchange, the
    corner turn and the channelizers, the flagship step's reduction, bit
    for bit against one process, and a run of transfers into a receiver
    whose stream is held busy (a slot refilled before its copy completed
    would hand out the next transfer's bytes)."""
    import os
    import subprocess
    import sys
    from baseband_tasks_tpu_torch.tools import multihost_check as mc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "out.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "baseband_tasks_tpu_torch.tools."
         "multihost_check", str(r), "2", f"file://{tmp_path}/rdv", out,
         "transport", "cuda:0,cuda:0", "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for r in range(2)]
    try:
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0 and "MULTIHOST_OK" in text, text
    for rank in (0, 1):
        got = np.load(mc.rank_file(out, rank))
        cases = [k[:-len("/one")] for k in got.files if k.endswith("/one")]
        assert cases
        for case in cases:
            assert np.array_equal(got[f"{case}/multi"], got[f"{case}/one"]), \
                f"rank {rank}: {case}"
    assert "refill/one" in np.load(mc.rank_file(out, 1)).files


def _remote_workers(tmp_path, devices):
    """Two ``multihost_check`` workers in the ``remote`` mode, rank r on
    ``devices[r]`` (gloo for the setup's handshake and the profiles'
    gather): both must exit 0; each rank's arrays."""
    import os
    import subprocess
    import sys
    from baseband_tasks_tpu_torch.tools import multihost_check as mc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "remote.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "baseband_tasks_tpu_torch.tools."
         "multihost_check", str(r), "2", f"file://{tmp_path}/rdv", out,
         "remote", devices[r], "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for r in range(2)]
    try:
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0 and "MULTIHOST_OK" in text, text
    return [dict(np.load(mc.rank_file(out, r))) for r in range(2)]


def _assert_remote(results):
    """The ``remote`` mode's results: the primitives (front, end and
    window on (4, 1), (2, 2), chan across and mixed meshes, open and
    periodic) bit for bit against 'ppermute' and one process; the float
    ``run_fn``'s edges bit for bit, its profiles to the fold's atomic
    order, counts exact, 12 halo_remote launches a process (3 steps x 2
    planes x push and copy out) and no edge bytes through the transport;
    ``step_fn`` on both paths bit for bit, 2 launches; the stress run."""
    for rank, z in enumerate(results):
        cases = [k[:-len("/ppermute")] for k in z if k.endswith("/ppermute")]
        assert len(cases) >= 10
        for case in cases:
            assert np.array_equal(z[f"{case}/multi"], z[f"{case}/ppermute"]), \
                f"rank {rank}: {case}"
            if f"{case}/one" in z:
                assert np.array_equal(z[f"{case}/multi"], z[f"{case}/one"])
        assert z["remote_open_line/launches"] == 4         # 2 calls x 2
        assert z["remote_open_chan/launches"] == 2         # pull, rings whole
        assert z["run/edges_same"] == 1
        assert z["run/launches"] == 3 * 2 * 2
        assert z["run/bytes"] == z["run/profile_bytes"]
        assert np.array_equal(z["run/cnt"], z["run/pp_cnt"])
        torch.testing.assert_close(torch.from_numpy(z["run/prof"]),
                                   torch.from_numpy(z["run/pp_prof"]),
                                   rtol=PROFILE_RTOL, atol=0.0)
        for case in ("step_plain", "step_kernels"):
            assert z[f"{case}/launches"] == 2
        assert z["stress/bad"] == 0 and z["stress/calls"] == 64


def test_two_processes_remote_halo(dev, tmp_path):
    """halo='remote' across two processes on the one card: each
    process's ``halo_remote`` push form writes its edges into the other's
    memory through CUDA IPC and the streams wait on flags, with no host
    call in the step (see :func:`_assert_remote`); the stress run makes
    64 exchanges while the receiver's stream is held busy, so a mailbox
    slot reused before it was copied out would show; both workers exit
    0 after closing their mappings before any mailbox is freed."""
    _assert_remote(_remote_workers(tmp_path, ["cuda:0,cuda:0"] * 2))


def test_two_processes_remote_halo_two_cards(tmp_path):
    """The same across two processes with a card each (the mailboxes
    mapped over peer access).  Needs two cards with peer access; skips
    otherwise."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    if not torch.cuda.can_device_access_peer(0, 1):
        pytest.skip("cuda:0 cannot reach cuda:1")
    _assert_remote(_remote_workers(tmp_path, ["cuda:0,cuda:0",
                                              "cuda:1,cuda:1"]))


def test_push_form_kernel(dev):
    """``bbt_halo_push`` alone, in one process: moves of front and end
    sizes from blocks, and zeros, into local buffers, bit for bit, at the
    16-, 4- and 1-byte widths; a move table it cannot take is refused."""
    import ctypes
    from baseband_tasks_tpu_torch.ops._build import launch
    arr = ctypes.c_longlong * 4
    for dtype, cols in ((torch.float32, 32), (torch.float32, 5),
                        (torch.int8, 7)):
        src = (torch.randn((64, cols), device=dev) * 50).to(dtype)
        dst = torch.full((4, 64, cols), 3, dtype=dtype, device=dev)
        row = src.element_size() * cols
        moves = [(src[40:].data_ptr(), dst[0].data_ptr()),   # front: 24 rows
                 (0, dst[1].data_ptr()),                      # front zeros
                 (src.data_ptr(), dst[2].data_ptr()),         # end: 9 rows
                 (0, dst[3].data_ptr())]                      # end zeros
        dd.reset_launch_counts()
        launch("halo_remote", "bbt_halo_push", dev,
               arr(*(m[0] for m in moves)), arr(*(m[1] for m in moves)), 4,
               2, 24 * row, 9 * row)
        torch.cuda.synchronize()
        assert dd.launch_counts["halo_remote"] == 1
        assert torch.equal(dst[0, :24], src[40:])
        assert not dst[1, :24].any() and torch.equal(dst[2, :9], src[:9])
        assert not dst[3, :9].any()
        assert bool((dst[0, 24:] == 3).all() and (dst[2, 9:] == 3).all())
    with pytest.raises(RuntimeError, match="bbt_halo_push"):
        launch("halo_remote", "bbt_halo_push", dev, arr(0, 0, 0, 0),
               arr(0, 0, 0, 0), 4, 2, 16, 16)     # no destination


# -- the LOFAR HBA correlator node: the compiled FX path -------------------

def _lofar(**sizes):
    """(configuration, system, reference) of the benchmark's LOFAR node,
    ``sizes`` replacing the deployment's."""
    from benchmark import harness
    cfg = harness.config_of(harness.load_spec(), "lofar_hba_cobalt")
    cfg.update(sizes)
    return (cfg, harness.module("systems", "lofar_hba_cobalt"),
            harness.module("reference", "lofar_hba_cobalt"))


def test_lofar_correlator_one_dump(dev):
    """62 stations x 2 subbands x 2 pol, 64 channels, one dump of 3072
    spectra: the compiled correlator (the four polarization products,
    the fringe stopped at each subband's sky frequency) on the card
    against the benchmark's float64 reference, computed on the card, under
    its limits; the dump counts 3072."""
    from benchmark import harness
    cfg, system, ref = _lofar(n_subband=2)
    traffic = dict(harness.traffic_of("dump_1s"), pool=1)
    feed = system.make_feed(cfg, traffic, 2 ** 31 + 5, dev, harness.Spans())
    sums, counts = feed.unit(0)
    assert sums.shape == (1, 1953, 64, 2, 4) and list(counts) == [3072]
    want = ref.expected(cfg, traffic, feed.reference_data(), [0], dev)[0]
    nums = ref.compare((sums, counts), want)
    assert all(nums[k] <= ref.LIMITS[k] for k in nums), nums
    feed.release()
    feed.close()


@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
def test_lofar_correlator_spans(dev):
    """A traced run of the compiled correlator holds one
    ``compiled.call``, a ``compiled.block`` a block and a ``correlator.x``
    inside each block; the profiler links to each X span (by ``External
    id``) the one fused ``xcorr`` kernel its operator launched (16
    stations x 128 cells, wide enough for the fused X stage)."""
    from benchmark import harness
    from benchmark.trace import traced
    cfg, system, _ = _lofar(n_station=16, n_subband=2, n_chan=64, n_avg=64,
                            block_samples=1024, max_delay_samples=16)
    traffic = dict(harness.traffic_of("dump_1s"), pool=1, steps_per_call=4)
    feed = system.make_feed(cfg, traffic, 11, dev, harness.Spans())
    assert feed.cp.x_form == "fused"
    n_blocks = system.dump_blocks(cfg)[1]
    _, tr = traced(lambda: feed.unit(0), dev)
    spans = {}
    for e in tr.host:
        if e.get("cat") == "user_annotation":
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    assert len(spans["compiled.call"]) == 1
    assert len(spans["compiled.block"]) == len(spans["correlator.x"]) \
        == n_blocks
    (c0, c1), = spans["compiled.call"]
    for (a, b), (xa, xb) in zip(sorted(spans["compiled.block"]),
                                sorted(spans["correlator.x"])):
        assert c0 <= a <= xa <= xb <= b <= c1
    reader = harness.module("metrics", "correlator.x_roofline")
    secs, n = reader.launched_inside(tr, "correlator.x")
    assert n == n_blocks and secs > 0
    names = {e["name"] for e in tr.kernels}
    assert any("xcorr_kernel" in k for k in names), names
    assert not any("indexFuncLargeIndex" in k for k in names
                   if "complex" in k), names
    feed.release()
    feed.close()


def test_lofar_run_fn_one_xcorr_a_block(dev):
    """The compiled correlator at the deployment's 62 stations (2
    subbands) takes the fused X stage: one ``xcorr`` launch a block of
    ``run_fn``, and the sums of the plain versions' run (the products and
    their ``index_add_``) to float32 roundoff."""
    from benchmark import harness
    cfg, system, _ = _lofar(n_subband=2)
    traffic = dict(harness.traffic_of("dump_1s"), pool=1)
    feed = system.make_feed(cfg, traffic, 2 ** 31 + 9, dev, harness.Spans())
    n_blocks = system.dump_blocks(cfg)[1]
    assert feed.cp.x_form == "fused"
    dd.reset_launch_counts()
    sums, counts = feed.cp.run_fn(n_blocks)(feed.blocks[0])
    torch.cuda.synchronize()
    assert dd.launch_counts["xcorr"] == n_blocks
    products = system.compiled(cfg, feed.d, dev)._run_fn(n_blocks,
                                                          "products")
    want, wcounts = products(feed.blocks[0])
    assert torch.equal(counts, wcounts)
    assert _vis_gap(sums, want) <= 1e-5
    feed.release()
    feed.close()


def _vis_gap(got, want):
    """The largest gap of a visibility (``(n_seg, n_baseline, ..., 4)``
    full-polarization sums) over sqrt(V_ii^pp V_jj^qq) of its cell, the
    LOFAR cell's measure."""
    nb = want.shape[1]
    n = int(round((np.sqrt(8 * nb + 1) - 1) / 2))
    i, j = np.triu_indices(n)
    auto = np.cumsum([0] + [n - k for k in range(n - 1)])
    power = want[:, auto].abs()[..., [0, 3]]          # (S, n, ..., 2)
    pi = power[:, i].repeat_interleave(2, dim=-1)      # p of XX XY YX YY
    pj = power[:, j].repeat(*(1,) * (power.ndim - 1), 2)
    bound = (pi * pj).sqrt()
    return float(((got - want).abs() / bound).max())


# (stations, cells (channel, subband, ...; the elementwise products' pol
# axis among them), products, segment ids of the block; trash id 2)
XCORR_CASES = {
    "lofar_lead_block": (62, (64, 2), "full", [2] + [0] * 63),
    "lofar_tail_block": (62, (64, 2), "full", [0] + [2] * 63),
    "lofar_dump_boundary": (62, (64, 2), "full", [0] * 40 + [1] * 24),
    "odd_stations_ragged": (33, (13,), "full", [0] * 17 + [1] * 20),
    "one_station": (1, (9,), "full", [2, 0, 0, 1, 1, 1, 2]),
    "five_stations": (5, (3, 7), "full", [1, 0] * 11),
    "elementwise": (5, (3, 7, 2), "elementwise", [0] * 30 + [1] * 9 + [2]),
    "elementwise_lofar": (62, (64, 2, 2), "elementwise", [0] * 64),
}


@pytest.mark.parametrize("case", sorted(XCORR_CASES))
def test_xcorr_kernel_matches_plain(dev, case):
    """The fused X stage (``xcorr``) against its plain version: the LOFAR
    node's widths at 2 subbands (62 stations x 2 pol, the lead block, the
    tail block, a dump boundary inside a block) under the cell's limit of
    4e-5, and odd station counts, ragged cells and the elementwise
    products; the trash row untouched, bit for bit from call to call."""
    from baseband_tasks_tpu_torch.ops.xcorr import xcorr_accumulate
    n, cells, products, ids = XCORR_CASES[case]
    full = products == "full"
    g = torch.Generator(device=dev)
    g.manual_seed(len(ids) + n)
    x = torch.randn((len(ids), n) + cells + ((2,) if full else ()),
                    dtype=torch.complex64, generator=g, device=dev)
    seg = torch.tensor(ids, device=dev)
    out = cells + (4,) if full else cells
    start = torch.randn((3, n * (n + 1) // 2) + out, dtype=torch.complex64,
                        generator=g, device=dev)
    dd.reset_launch_counts()
    got = xcorr_accumulate(x, seg, start.clone(), full=full)
    again = xcorr_accumulate(x, seg, start.clone(), full=full)
    torch.cuda.synchronize()
    assert dd.launch_counts["xcorr"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got[2], start[2])
    with dd.plain_versions():
        want = xcorr_accumulate(x, seg, start.clone(), full=full)
    assert dd.launch_counts["xcorr"] == 2
    if full:
        rows = sorted(set(ids) - {2})
        assert _vis_gap((got - start)[rows], (want - start)[rows]) <= 4e-5
    peak = float((want - start).abs().max())
    assert float((got - want).abs().max()) <= 2e-6 * peak


def test_xcorr_kernel_on_the_stacks_layout(dev):
    """The correlator's stack holds each station's channels contiguous
    and its subbands and polarizations outside the stations: the kernel
    reads it at its strides and gives the bits it gives on a contiguous
    copy, and the plain version's sums."""
    from baseband_tasks_tpu_torch.ops.xcorr import xcorr_accumulate
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((64, 3, 2, 62, 64), dtype=torch.complex64, generator=g,
                    device=dev).permute(0, 3, 4, 1, 2)
    assert not x.is_contiguous()
    seg = torch.tensor([1] + [0] * 63, device=dev)
    sums = torch.zeros((2, 1953, 64, 3, 4), dtype=torch.complex64,
                       device=dev)
    got = xcorr_accumulate(x, seg, sums.clone(), full=True)
    dense = xcorr_accumulate(x.contiguous(), seg, sums.clone(), full=True)
    assert torch.equal(got, dense)
    with dd.plain_versions():
        want = xcorr_accumulate(x, seg, sums.clone(), full=True)
    assert _vis_gap(got[:1], want[:1]) <= 4e-5
    sums = torch.zeros((2, 1953, 64, 3, 2), dtype=torch.complex64,
                       device=dev)
    got = xcorr_accumulate(x, seg, sums.clone(), full=False)
    dense = xcorr_accumulate(x.contiguous(), seg, sums.clone(), full=False)
    assert torch.equal(got, dense)


# -- the LOTAAS tied-array beamformer: TABs on the compiled path ------------

def _lotaas(**sizes):
    """(configuration, system, reference) of the benchmark's LOTAAS node,
    ``sizes`` replacing the deployment's."""
    from benchmark import harness
    cfg = harness.config_of(harness.load_spec(), "lofar_lotaas_tabs")
    cfg.update(sizes)
    return (cfg, harness.module("systems", "lofar_lotaas_tabs"),
            harness.module("reference", "lofar_lotaas_tabs"))


def _lotaas_block(dev, monkeypatch, product=None):
    """One block at the cell's widths (12 fields x 61 subbands x 2 pol, 16
    channels, 73 TABs, 256 Stokes rows) run in a process that allows
    TF32: (the comparison's numbers, its limits, the process's TF32 flag
    during each TAB product, the flag after the run).  ``product``
    replaces the beamformer's product where given."""
    from baseband_tasks_tpu_torch.models import beamform
    from benchmark import harness
    cfg, system, ref = _lotaas(cobalt_block_samples=24576)
    traffic = dict(harness.traffic_of("stokes_1s"), pool=1,
                   steps_per_call=1)
    flags = []
    matmul = torch.matmul

    def spy(*args):
        flags.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    if product is not None:
        monkeypatch.setattr(beamform, "_tab_products", product)
    feed = system.make_feed(cfg, traffic, 2 ** 31 + 29, dev,
                            harness.Spans())
    sums, counts = feed.unit(0)
    allowed = torch.backends.cuda.matmul.allow_tf32
    assert feed.cp.bf_form == "products"
    assert sums.shape == (256, 73, 16, 61) and (counts == 6).all()
    want = ref.expected(cfg, traffic, feed.reference_data(), [0], dev)[0]
    nums = ref.compare((sums, counts), want)
    feed.release()
    feed.close()
    return nums, ref.LIMITS, flags, allowed


def test_lotaas_tabs_one_block(dev, monkeypatch):
    """One block of the LOTAAS cell's widths: the compiled beamformer's
    Stokes I sums against the benchmark's float64 reference, computed on
    the card, at least 10x under the cell's limit, in a process that
    allows TF32: every TAB product ran with TF32 off, and the process's
    setting is as it was after it."""
    nums, limits, flags, allowed = _lotaas_block(dev, monkeypatch)
    assert nums["count_err"] == 0
    assert nums["stokes_rel_err"] <= limits["stokes_rel_err"] / 10, nums
    assert flags and not any(flags)
    assert allowed is True


def _tf32(t):
    """``t`` (complex64) with each float rounded to TF32's 10 mantissa
    bits (round to nearest even), as the tensor cores take it."""
    i = torch.view_as_real(t).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.view_as_complex(i.view(torch.float32))


def test_lotaas_tabs_tf32_fails_the_limit(dev, monkeypatch):
    """The same block with the TAB product's inputs rounded to TF32 fails
    the cell's limit: a product in TF32 is seen."""
    nums, limits, _, _ = _lotaas_block(
        dev, monkeypatch,
        product=lambda w, x: torch.matmul(_tf32(w), _tf32(x)))
    assert nums["stokes_rel_err"] > 10 * limits["stokes_rel_err"], nums


@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
def test_lotaas_tabs_spans(dev):
    """A traced run of the compiled beamformer holds one ``compiled.call``,
    a ``compiled.block`` a block and a ``beamformer.bf`` inside each
    block; the kernels launched inside the TAB spans are found, the
    complex matrix product among them, and hold most of the kernel time
    (``beamformer.bf_share``)."""
    from benchmark import harness
    from benchmark.trace import traced
    cfg, system, _ = _lotaas(n_subband=8, cobalt_block_samples=49152)
    traffic = dict(harness.traffic_of("stokes_1s"), pool=1,
                   steps_per_call=2)
    feed = system.make_feed(cfg, traffic, 13, dev, harness.Spans())
    n_blocks = system.unit_blocks(cfg)[1]
    _, tr = traced(lambda: feed.unit(0), dev)
    spans = {}
    for e in tr.host:
        if e.get("cat") == "user_annotation":
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    assert len(spans["compiled.call"]) == 1
    assert len(spans["compiled.block"]) == len(spans["beamformer.bf"]) \
        == n_blocks
    (c0, c1), = spans["compiled.call"]
    for (a, b), (xa, xb) in zip(sorted(spans["compiled.block"]),
                                sorted(spans["beamformer.bf"])):
        assert c0 <= a <= xa <= xb <= b <= c1
    reader = harness.module("metrics", "correlator.x_roofline")
    secs, n = reader.launched_inside(tr, "beamformer.bf")
    assert n >= 2 * n_blocks and secs > 0
    run = SimpleNamespace(trace=tr, spans={}, work=tuple(
        w * 1 for w in feed.work_per_unit()))
    share = harness.module("metrics", "beamformer.bf_share").read(run)
    assert 50 < share <= 100, share
    roof = harness.module("metrics", "beamformer.bf_roofline").read(run)
    assert 0 < roof <= 100, roof
    feed.release()
    feed.close()
