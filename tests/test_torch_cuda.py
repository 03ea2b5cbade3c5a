"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; without a device they skip.
On a GPU machine (which need not have jax) run them with

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \
        --noconftest -o filterwarnings=error

They cover what the smoke (``chip_smoke.py``) does not: every bit
depth, the float32 twin, small and lopsided windows, a fold whose
partial profile does not fit shared memory (the global-atomic branch),
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
CUDA tensors against the CPU.
Tolerances as in ``chip_smoke.py``: planes
to 1e-4 of their largest element (float32 FFT roundoff is ~1e-6 of it),
profiles elementwise to rtol 2e-4 (atomic summation order), counts
exact.
"""

import contextlib

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
    the global-atomic branch at n_phase 2^15."""
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
    edge and from lane L-1 to lane 0; the global-atomic path at n_phase
    2^15; counts exact, the power plane within PROFILE_RTOL, the cross
    planes within FFT_TOL of their peak."""
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
    assert {k: v for k, v in dd.launch_counts.items() if v} == {name: 1}
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
