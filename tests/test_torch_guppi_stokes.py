"""The GUPPI full-Stokes path of the port's flagship entry on the CPU
(the plain versions of its kernels): ``guppi_repack`` against a numpy
decode of a GUPPI file's bytes, ``WidebandPulsarPipeline(...,
ingest_layout='guppi', detect='stokes').run_fn`` against the benchmark's
plain reference of that deployment (``benchmark/reference/
guppi_b1937_stokes.py``, float64) at a small size, the words of a GUPPI
file fed to ``run_fn``, and the plane-packed ingest left as it was."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baseband_tasks_tpu_torch as bt  # noqa: E402
from baseband_tasks_tpu_torch.io import guppi as pguppi  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops.unpack import decode_planes  # noqa: E402
from baseband_tasks_tpu_torch.utils import profiling  # noqa: E402
from benchmark import harness  # noqa: E402

u = bt.units
SPEC = harness.load_spec()
SYSTEM = harness.module("systems", "guppi_b1937_stokes")
REF = harness.module("reference", "guppi_b1937_stokes")


def small_cfg():
    """The deployment at 4 channels, DM 30, a 4096-sample window; its
    2048 bins hold 1.19 samples each a pulse period, as published."""
    cfg = harness.config_of(SPEC, "guppi_b1937_stokes")
    cfg.update(n_chan=4, dm=30.0, block_samples=2048,
               window={"n_fft": 4096, "pad_start": 896, "pad_end": 896,
                       "valid_samples": 2304})
    return cfg


def guppi_words(n_chan, t, seed):
    """(n_chan, t) int32 GUPPI words of uniform signed bytes."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n_chan, t, 4), generator=g,
                         dtype=torch.uint8).view(torch.int32).reshape(
        n_chan, t)


def write_guppi(path, data, rate_hz=1_562_500):
    """``data`` (T, n_chan, 2) complex64 as one GUPPI block of T samples
    (the writer's scale 32: each part becomes round(32 x), clipped)."""
    t = data.shape[0]
    src = bt.StreamGenerator(lambda sh: data[sh.tell():sh.tell() + t],
                             data.shape, bt.Time.from_mjd(58000.0),
                             rate_hz * u.Hz, samples_per_frame=t,
                             dtype=np.complex64, device="cpu")
    with pguppi.open(str(path), "w", template=src,
                     samples_per_block=t) as fw:
        fw.write(data)


def test_guppi_repack_decodes_a_written_file(tmp_path):
    """X and Y, both signs, -128 and 127: the repacked planes decoded with
    offset 128 are the file's signed bytes, lane 2c + p, sample k T/4 + r
    in byte k of row r."""
    n_chan, t = 3, 64
    rng = np.random.default_rng(4)
    parts = rng.integers(-128, 128, (t, n_chan, 2, 2)).astype(np.float32)
    parts[0] = -128.0                 # the extremes in every component
    parts[1] = 127.0
    data = ((parts[..., 0] + 1j * parts[..., 1]) / 32).astype(np.complex64)
    write_guppi(tmp_path / "x.raw", data)
    with pguppi.open(str(tmp_path / "x.raw"), device="cpu") as fr:
        words = fr.read_packed(0, t)[0].reshape(n_chan, t)
        host = fr.read_host(0, t)
    raw = words.view(np.int8).reshape(n_chan, t, 2, 2)   # the file's bytes
    assert raw.min() == -128 and raw.max() == 127
    for comp in np.moveaxis(raw, (2, 3), (0, 1)).reshape(4, -1):
        assert {-128, 127} <= set(comp.tolist())
        assert (comp < 0).any() and (comp > 0).any()
    np.testing.assert_array_equal(
        raw[..., 0] + 1j * raw[..., 1], host.transpose(1, 0, 2))
    re, im = dd.guppi_repack(torch.from_numpy(words))
    assert re.shape == im.shape == (t // 4, 2 * n_chan)
    for plane, k in ((re, 0), (im, 1)):
        got = decode_planes(plane, 8, offset=128.0).numpy()
        want = raw[..., k].transpose(1, 0, 2).reshape(t, 2 * n_chan)
        np.testing.assert_array_equal(got, want)
    assert torch.equal(torch.stack([re, im]),
                       torch.stack(dd.guppi_repack_ref(torch.from_numpy(
                           words))))


def test_guppi_repack_refuses_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 4"):
        dd.guppi_repack(torch.zeros((4, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="n_chan, T"):
        dd.guppi_repack(torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 5])
def test_guppi_stokes_matches_the_reference(seed):
    """16 steps on one block, from stream offset 3 T: every number of the
    benchmark's comparison within its limit, and the reference computed
    in bfloat16 (the control) outside one."""
    cfg = small_cfg()
    pipe = SYSTEM.pipeline(cfg, "cpu")
    t, n = pipe.block_samples, 16
    words = guppi_words(cfg["n_chan"], t, seed)
    prof, cnt = pipe.run_fn(n, offset0=3 * t, ingest_bits=8)(blocks=words)
    assert prof.shape == (cfg["n_phase"], cfg["n_chan"], 4)
    key = tuple((0, (3 + k) * t) for k in range(n))
    data = {"pool": [words]}
    ref = REF.expected(cfg, {}, data, [key], "cpu")[key]
    nums = REF.compare((prof.numpy(), cnt.numpy()), ref)
    assert set(nums) == set(REF.LIMITS)
    assert all(nums[k] <= REF.LIMITS[k] for k in nums), nums
    assert cnt.sum() == n * t
    low = REF.expected(cfg, {}, data, [key], "cpu", precision="bfloat16")
    ctl = REF.compare(low[key], ref)
    assert any(ctl[k] > REF.LIMITS[k] for k in ctl), ctl


def test_file_words_fold_as_the_resident_words(tmp_path):
    """A block written by ``GUPPIStreamWriter`` and read back by
    ``read_packed`` folds exactly as the same bytes held in memory."""
    cfg = small_cfg()
    pipe = SYSTEM.pipeline(cfg, "cpu")
    t = pipe.block_samples
    words = guppi_words(cfg["n_chan"], t, 11)
    raw = words.numpy().view(np.int8).reshape(cfg["n_chan"], t, 2, 2)
    data = ((raw[..., 0] + 1j * raw[..., 1]).astype(np.complex64) / 32
            ).transpose(1, 0, 2)
    write_guppi(tmp_path / "b.raw", np.ascontiguousarray(data))
    with pguppi.open(str(tmp_path / "b.raw"), device="cpu") as fr:
        read = fr.read_packed(0, t)[0].reshape(cfg["n_chan"], t)
    assert np.array_equal(read, words.numpy())
    run = pipe.run_fn(2, offset0=t, ingest_bits=8)
    got, want = run(blocks=read), run(blocks=words)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _pipe(**kw):
    args = dict(n_chan=4, n_pol=2, dm=30.0, freq_center=1150 * u.MHz,
                chan_rate=1562.5 * u.kHz, period_samples=(2434, 1),
                n_phase=64, block_samples=2048, device="cpu",
                use_kernels=True, detect="stokes")
    args.update(kw)
    return bt.WidebandPulsarPipeline(**args)


def _spans(run, blocks, path):
    run(blocks=blocks)
    with profiling.trace(str(path)):
        out = run(blocks=blocks)
    with open(path / "trace.json") as fh:
        names = sorted(e["name"] for e in json.load(fh)["traceEvents"]
                       if e.get("cat") == "user_annotation")
    return out, names


def test_planes_ingest_unchanged(tmp_path):
    """The default layout is 'planes': bit for bit the same profile, the
    same spans (no ``wideband.repack``); the GUPPI call adds that one
    span inside ``wideband.call``."""
    t = _pipe().block_samples
    g = torch.Generator().manual_seed(3)
    planes = tuple(torch.randint(0, 256, (t // 4, 4, 2, 4), generator=g,
                                 dtype=torch.uint8).view(torch.int32)
                   .reshape(t // 4, 4, 2) for _ in range(2))
    outs = []
    for i, kw in enumerate(({}, {"ingest_layout": "planes"})):
        out, names = _spans(_pipe(**kw).run_fn(2, ingest_bits=8), planes,
                            tmp_path / f"p{i}")
        assert names == ["mesh.shard", "mesh.shard", "wideband.call",
                         "wideband.prep", "wideband.step", "wideband.step"]
        outs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _, names = _spans(_pipe(ingest_layout="guppi").run_fn(2, ingest_bits=8),
                      guppi_words(4, t, 1), tmp_path / "g")
    assert names == ["mesh.shard", "wideband.call", "wideband.prep",
                     "wideband.repack", "wideband.step", "wideband.step"]


def test_guppi_layout_refusals():
    with pytest.raises(ValueError, match="ingest_layout"):
        _pipe(ingest_layout="vdif")
    with pytest.raises(ValueError, match="n_pol=2"):
        _pipe(ingest_layout="guppi", n_pol=1, detect="power")
    with pytest.raises(ValueError, match="use_kernels"):
        _pipe(ingest_layout="guppi", use_kernels=False)
    pipe = _pipe(ingest_layout="guppi")
    with pytest.raises(ValueError, match="ingest_bits=8"):
        pipe.run_fn(1, ingest_bits=4)
    t = pipe.block_samples
    with pytest.raises(ValueError, match="block must be"):
        pipe.run_fn(1, ingest_bits=8)(blocks=guppi_words(4, t // 2, 0))


def test_guppi_words_on_a_mesh_fold_as_their_samples():
    """On a (2, 2) mesh of CPU shards each shard repacks its own words and
    the time shards' edges are decoded with the GUPPI offset: one step
    folds as ``step_fn`` folds the decoded samples, v / 64, of the same
    block."""
    from baseband_tasks_tpu_torch import parallel
    mesh = parallel.make_mesh(time=2, chan=2, devices=["cpu"] * 4)
    guppi = _pipe(mesh=mesh, device=None, ingest_layout="guppi")
    planes = _pipe(mesh=mesh, device=None)
    t = guppi.global_block
    words = guppi_words(4, t, 9)
    b = words.view(torch.int8).reshape(4, t, 2, 2).to(torch.float32) / 64
    prof, cnt = guppi.run_fn(1, ingest_bits=8)(blocks=words)
    rprof, rcnt = planes.step_fn()(b.permute(1, 0, 2, 3).contiguous(),
                                   torch.tensor(0.0))
    assert torch.equal(cnt, rcnt.to(cnt.dtype))
    assert float((prof - rprof).abs().max()) <= 1e-5 * float(
        rprof.abs().max())
