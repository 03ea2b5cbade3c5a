"""The sharded flagship of the PyTorch port against the JAX pipeline.

Both pipelines run on a (time, chan) mesh of eight shards, (4, 2) and
(8, 1): the JAX one on the eight virtual CPU devices under ``shard_map``
(Pallas in interpret mode), the port's with every shard on the CPU
(its plain versions).  The same numpy inputs go to both: ``step_fn`` on
both paths, ``step_bins_fn``, the planes step, and ``run_fn`` on float
planes, on plane-packed words (packed per time shard, as each shard
decodes its own words) and on the plain path, power and Stokes.

On a 2-D mesh the JAX interpreter answers ``halo='remote'`` with its
ppermute exchange, so the JAX side of every comparison is the ppermute
result; the port's 'remote' (the ``halo_remote`` wrapper's plain version
on CPU shards) must equal its 'ppermute' bit for bit.

Counts exact; profiles rtol 1e-5, atol 1e-3 (the bins hold ~1e3 detected
samples; tests/test_torch_wideband.py's bar).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P  # noqa: E402,E501

import baseband_tasks_tpu.models as jmodels  # noqa: E402
from baseband_tasks_tpu import phases as jphases  # noqa: E402
from baseband_tasks_tpu import utils as jutils  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jun  # noqa: E402

import baseband_tasks_tpu_torch as bt  # noqa: E402
from baseband_tasks_tpu_torch import parallel as par  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3
N_ITER = 2


def polyco_text(f0=641.928123):
    """bench.py's synthetic B1937+21-like polyco."""
    return ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")


def config(units, **extra):
    return {**dict(n_chan=8, n_pol=2, dm=0.5, freq_center=600 * units.MHz,
                   chan_rate=250 * units.kHz, period_samples=(512, 1),
                   n_phase=8, block_samples=1024), **extra}


def pipes(shape, kernels, *, halo="ppermute", detect="power", polyco=False,
          **extra):
    """(JAX pipeline, port pipeline) on a ``shape`` (time, chan) mesh."""
    jextra = pextra = {}
    if polyco:
        jextra = dict(phase_model=jphases.PolycoPhase(
            jphases.Polyco(polyco_text())),
            start_time=jutils.Time.from_mjd(58000.0))
        pextra = dict(phase_model=bt.PolycoPhase(bt.Polyco(polyco_text())),
                      start_time=bt.Time.from_mjd(58000.0))
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(shape),
                  ("time", "chan"))
    jp = jmodels.WidebandPulsarPipeline(
        mesh=jmesh, use_pallas=kernels, detect=detect, halo=halo,
        **config(jutils.units, **jextra, **extra))
    pp = bt.WidebandPulsarPipeline(
        mesh=par.make_mesh(*shape, devices=["cpu"] * 8), use_kernels=kernels,
        detect=detect, halo=halo, **config(bt.units, **pextra, **extra))
    return jp, pp


def sharded(pipe, x):
    return jax.device_put(x, NamedSharding(pipe.mesh, P("time", "chan")))


def voltages(pipe, seed):
    return np.random.default_rng(seed).standard_normal(
        (pipe.global_block, 8, 2, 2)).astype(np.float32)


def assert_same(got, want):
    prof, cnt = got
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[1]))
    assert prof.shape == np.asarray(want[0]).shape
    np.testing.assert_allclose(prof.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)


def assert_equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def jax_run(pipe, local, bases, n_iter, offset0=0):
    """The JAX pipeline's run_fn loop body on given blocks: a split step
    (bases (re, im), the chirp storage planes) or ``_local_step`` (bases
    (xf,), scaled per step, the natural-order chirp pairs)."""
    split = len(bases) == 2
    specs = ((P("time", "chan"),) * 2 + (P(None, None, "chan"),) * 2
             + (P(), P())) if split else (P("time", "chan"), P(None, "chan"),
                                          P())
    step = jax.jit(jax.shard_map(
        local, mesh=pipe.mesh, in_specs=specs,
        out_specs=(P(None, "chan"), P()), check_vma=not split))
    chirp = pipe._chirp_storage_np() if split else (pipe._chirp_np,)
    T = pipe.global_block
    table = (pipe.fold_model.table(offset0 + np.arange(n_iter) * T, T)
             if pipe.fold_model is not None else None)
    off = jnp.float32(float(offset0) % pipe._per_q)
    acc = cnt = 0
    for k in range(n_iter):
        foldv = (pipe._foldv_from_halves(jnp.asarray(table[k]))
                 if table is not None else pipe._fixed_foldv(off))
        if split:
            prof, c = step(*[sharded(pipe, b) for b in bases], *chirp, off,
                           foldv)
        else:
            prof, c = step(sharded(pipe, bases[0] * (1.0 + 1e-6 * off)),
                           *chirp, foldv)
        off = jnp.mod(off + T, float(pipe._per_q))
        acc, cnt = acc + prof, cnt + c
    return np.asarray(acc), np.asarray(cnt)


def packed_per_shard(pipe, bits, seed):
    """Two planes of random fields, each time shard's block packed on its
    own and the words concatenated: (port int32 words, JAX carriers)."""
    rng = np.random.default_rng(seed)
    Tl = pipe.block_samples
    out = []
    for _ in range(2):
        f = rng.integers(0, 1 << bits, (pipe.global_block, 16),
                         dtype=np.uint8)
        shards = [f[t * Tl:(t + 1) * Tl] for t in range(pipe.n_time_shards)]
        q = pipe.global_block * bits // 32
        out.append((torch.cat([unpack.pack_time_planes(s, bits)
                               for s in shards]).reshape(q, 8, 2),
                    np.concatenate([jun.pack_time_planes(s, bits)
                                    for s in shards]).reshape(q, 8, 2)))
    return out


# -- construction ------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_geometry_matches_jax(shape, kernels):
    jp, pp = pipes(shape, kernels)
    for name in ("pad_start", "pad_end", "_n_fft", "block_samples",
                 "global_block", "n_time_shards", "n_chan_shards"):
        assert getattr(pp, name) == getattr(jp, name), name
    assert pp.global_block == shape[0] * pp.block_samples
    assert pp.device == torch.device("cpu")


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_validation_matches_jax():
    jmesh = JMesh(np.asarray(jax.devices()[:6]).reshape(2, 3),
                  ("time", "chan"))
    pmesh = par.make_mesh(2, 3, devices=["cpu"] * 6)
    assert _raises(lambda: bt.WidebandPulsarPipeline(
        mesh=pmesh, **config(bt.units))) == _raises(
        lambda: jmodels.WidebandPulsarPipeline(
            mesh=jmesh, **config(jutils.units)))
    assert _raises(lambda: bt.WidebandPulsarPipeline(
        halo="nccl", **config(bt.units))) == _raises(
        lambda: jmodels.WidebandPulsarPipeline(
            halo="nccl", **config(jutils.units)))
    with pytest.raises(ValueError, match="not both"):
        bt.WidebandPulsarPipeline(mesh=par.make_mesh(devices=["cpu"]),
                                  device="cpu", **config(bt.units))
    with pytest.raises(ValueError, match="no axis"):
        bt.WidebandPulsarPipeline(mesh=par.Mesh(["cpu"], ("z",)),
                                  **config(bt.units))


# -- the steps on the caller's data ------------------------------------------

@pytest.mark.parametrize("shape, detect", [((4, 2), "power"),
                                           ((4, 2), "stokes"),
                                           ((8, 1), "power")])
@pytest.mark.parametrize("kernels", [False, True])
def test_step_fn_matches_jax(kernels, shape, detect):
    jp, pp = pipes(shape, kernels, detect=detect)
    xf = voltages(pp, 21)
    want = jp.step_fn()(sharded(jp, xf), jnp.float32(1234))
    got = pp.step_fn()(xf, 1234)
    assert int(got[1].sum()) == pp.global_block
    assert_same(got, want)
    remote = bt.WidebandPulsarPipeline(
        mesh=pp.mesh, use_kernels=kernels, detect=detect, halo="remote",
        **config(bt.units))
    assert_equal(remote.step_fn()(xf, 1234), got)


def test_step_fn_remote_matches_jax_remote():
    """JAX's halo='remote' on a 2-D mesh (its ppermute fallback in
    interpret mode) against the port's on the kernel path."""
    jp, pp = pipes((4, 2), True, halo="remote", polyco=True)
    xf = voltages(pp, 22)
    T = pp.global_block
    halves = jp.fold_model.foldv(5 * T, T)
    want = jp.step_fn()(sharded(jp, xf), jnp.asarray(halves))
    got = pp.step_fn()(xf, pp.fold_model.foldv(5 * T, T))
    assert_same(got, want)


@pytest.mark.parametrize("kernels", [False, True])
def test_step_bins_fn_matches_jax(kernels):
    jp, pp = pipes((4, 2), kernels)
    xf = voltages(pp, 23)
    bins = np.random.default_rng(23).uniform(-2, 10, pp.global_block).astype(
        np.float32)
    want = jp.step_bins_fn()(sharded(jp, xf), jax.device_put(
        bins, NamedSharding(jp.mesh, P("time"))))
    assert_same(pp.step_bins_fn()(xf, bins), want)


def test_planes_step_matches_jax():
    jp, pp = pipes((4, 2), True, detect="stokes")
    xf = voltages(pp, 24)
    off = jnp.float32(128)
    step = jax.jit(jax.shard_map(
        jp._local_step_pallas_planes, mesh=jp.mesh,
        in_specs=(P(None, "time", "chan"), P(None, None, "chan"),
                  P(None, None, "chan"), P(), P()),
        out_specs=(P(None, "chan"), P()), check_vma=False))
    csr, csi = jp._chirp_storage_np()
    x2 = np.ascontiguousarray(np.moveaxis(xf, -1, 0))
    want = step(jax.device_put(x2, NamedSharding(jp.mesh, P(
        None, "time", "chan"))), csr, csi, off, jax.jit(jp._fixed_foldv)(off))
    assert_same(pp.planes_step(x2, *pp._chirp_device(), 128, 128), want)
    theta = pp.planes_step(x2, pp._theta_device(), None, 128, 128)
    assert_same(theta, want)


def test_planes_step_remote_raises_like_jax():
    _, pp = pipes((4, 2), True, halo="remote")
    x2 = np.zeros((2, pp.global_block, 8, 2), np.float32)
    with pytest.raises(NotImplementedError, match="moves axis-0 halos"):
        pp.planes_step(x2, *pp._chirp_device(), 0, 0)


# -- the run loop -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_run_fn_float_matches_jax(shape):
    jp, pp = pipes(shape, True, polyco=True)
    rng = np.random.default_rng(25)
    xr, xi = (rng.standard_normal((pp.global_block, 8, 2)).astype(np.float32)
              for _ in range(2))
    want = jax_run(jp, jp._local_step_pallas_split, (xr, xi), N_ITER)
    got = pp.run_fn(N_ITER)(blocks=(xr, xi))
    assert int(got[1].sum()) == N_ITER * pp.global_block
    assert_same(got, want)
    remote = bt.WidebandPulsarPipeline.from_jax_state(
        dict(pad_start=jp.pad_start, pad_end=jp.pad_end, n_fft=jp._n_fft,
             chirp_storage=jp._chirp_storage_np()),
        mesh=pp.mesh, use_kernels=True, halo="remote",
        phase_model=bt.PolycoPhase(bt.Polyco(polyco_text())),
        start_time=bt.Time.from_mjd(58000.0), **config(bt.units))
    assert_equal(remote.run_fn(N_ITER)(blocks=(xr, xi)), got)


@pytest.mark.parametrize("shape, detect", [((4, 2), "power"),
                                           ((8, 1), "power"),
                                           ((4, 2), "stokes")])
def test_run_fn_packed_matches_jax(shape, detect):
    jp, pp = pipes(shape, True, detect=detect, polyco=True)
    (wr, cr), (wi, ci) = packed_per_shard(pp, 8, seed=26)
    want = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                         8), (cr, ci), N_ITER)
    got = pp.run_fn(N_ITER, ingest_bits=8)(blocks=(wr, wi))
    assert int(got[1].sum()) == N_ITER * pp.global_block
    assert_same(got, want)
    remote = bt.WidebandPulsarPipeline(
        mesh=pp.mesh, use_kernels=True, detect=detect, halo="remote",
        phase_model=bt.PolycoPhase(bt.Polyco(polyco_text())),
        start_time=bt.Time.from_mjd(58000.0), **config(bt.units))
    assert_equal(remote.run_fn(N_ITER, ingest_bits=8)(blocks=(wr, wi)), got)


def test_run_fn_packed_2bit_fixed_period_matches_jax():
    """2-bit words (16 planes a word), no phase model: the fold rows from
    the float32 offset carry."""
    jp, pp = pipes((4, 2), True, ingest_bits=2)
    (wr, cr), (wi, ci) = packed_per_shard(pp, 2, seed=27)
    want = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                         2), (cr, ci), N_ITER, offset0=1000)
    assert_same(pp.run_fn(N_ITER, offset0=1000, ingest_bits=2)(
        blocks=(wr, wi)), want)


def test_run_fn_plain_path_matches_jax():
    jp, pp = pipes((4, 2), False)
    xf = voltages(pp, 28)
    want = jax_run(jp, jp._local_step, (xf,), N_ITER, offset0=1000)
    assert_same(pp.run_fn(N_ITER, offset0=1000)(blocks=(xf,)), want)


def test_run_fn_seeded_on_the_mesh():
    _, pp = pipes((4, 2), True)
    dd.reset_launch_counts()
    prof, cnt = pp.run_fn(2, ingest_bits=8)(seed=3)
    assert prof.shape == (8, 8, 2) and int(cnt.sum()) == 2 * pp.global_block
    assert torch.isfinite(prof).all()
    assert not any(dd.launch_counts.values())


# -- properties of the sharded step ------------------------------------------

def test_dm0_matches_closed_form():
    """dm=0: the chirp is unity, every shard's FFT round trip is an
    identity to roundoff, and the profile is a direct numpy fold (the
    JAX test's rtol 2e-3, atol 0.05)."""
    _, pp = pipes((4, 2), False, dm=0.0, period_samples=(800, 1),
                  n_phase=16)
    xf = voltages(pp, 29)
    prof, cnt = pp.step_fn()(xf, 0)
    T = pp.global_block
    power = xf[..., 0] ** 2 + xf[..., 1] ** 2
    bins = (np.arange(T) % 800) * 16 // 800
    want = np.zeros((16, 8, 2), np.float32)
    np.add.at(want, bins, power)
    np.testing.assert_allclose(prof.numpy(), want, rtol=2e-3, atol=0.05)
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(bins,
                                                           minlength=16))


@pytest.mark.parametrize("kernels", [False, True])
def test_chan_resharding_is_invisible(kernels):
    """(4, 2) against (4, 1) at dm 5: the chan axis needs no
    communication (rtol 1e-6, atol 1e-3)."""
    kw = dict(dm=5.0, n_phase=16, period_samples=(800, 1))
    _, a = pipes((4, 2), kernels, **kw)
    b = bt.WidebandPulsarPipeline(
        mesh=par.make_mesh(4, 1, devices=["cpu"] * 4), use_kernels=kernels,
        **config(bt.units, **kw))
    xf = voltages(a, 30)
    pa, ca = a.step_fn()(xf, 77)
    pb, cb = b.step_fn()(xf, 77)
    assert torch.equal(ca, cb)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("shape, once", [((4, 2), False),
                                             ((1, 8), True)])
def test_run_fn_edges_by_time_shards(monkeypatch, shape, once):
    """A time-sharded mesh exchanges its edges every step; one time
    shard (over eight chan shards) makes its zero edges on a run's first
    call only.  Three calls of one run give the same bits."""
    pp = bt.WidebandPulsarPipeline(
        mesh=par.make_mesh(*shape, devices=["cpu"] * 8), use_kernels=True,
        **config(bt.units))
    made = []
    edges = pp._run_edges
    monkeypatch.setattr(pp, "_run_edges",
                        lambda *a: made.append(1) or edges(*a))
    run = pp.run_fn(N_ITER, ingest_bits=8)
    (wr, _), (wi, _) = packed_per_shard(pp, 8, seed=31)
    outs = [run(blocks=(wr, wi)) for _ in range(3)]
    assert len(made) == (1 if once else 3 * N_ITER)
    for out in outs[1:]:
        assert_equal(out, outs[0])
    assert int(outs[0][1].sum()) == N_ITER * pp.global_block
