"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; without a device they skip.
On a GPU machine (which need not have jax) run them with

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \
        --noconftest -o filterwarnings=error

They cover what the flagship smoke (``chip_smoke.py``) does not: every
bit depth, the float32 twin, small and lopsided windows, a fold whose
partial profile does not fit shared memory (the global-atomic branch),
and the wrappers' refusals.  Tolerances as in ``chip_smoke.py``: planes
to 1e-4 of their largest element (float32 FFT roundoff is ~1e-6 of it),
profiles elementwise to rtol 2e-4 (atomic summation order), counts
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
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


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_k1_packed(dev, bits):
    # the main rows must divide by 32/bits: a 4096-window, 64 x 64
    t_main, p0, p1, L = 2048, 1024, 1024, 32
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


@pytest.mark.parametrize("geom", GEOMS)
def test_k1_float_and_k2(dev, geom):
    t_main, p0, p1, L = geom
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
    assert dd.launch_counts == {"k1_packed": 1, "k1_float": 0, "k2": 1,
                                "k3_fold": 1}
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
    plain = bt.WidebandPulsarPipeline(use_kernels=False, **kw)
    for bits in (8, None):
        prof, cnt = kern.run_fn(3, ingest_bits=bits)(seed=1)
        rprof, rcnt = plain.run_fn(3, ingest_bits=bits)(seed=1)
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
