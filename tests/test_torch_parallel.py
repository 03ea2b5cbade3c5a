"""The port's mesh layer against the JAX package's, on the CPU.

The JAX side runs on the eight virtual CPU devices of ``conftest.py``
under ``shard_map`` (Pallas in interpret mode); the port's shards all live
on the CPU (``make_mesh(..., devices=['cpu'] * 8)``), where the
``halo_remote`` wrapper takes its plain version.  The same numpy inputs go
to both.  Halo edges, windows, the corner turn's moves and mesh ids are
exact; FFT results agree to float32 roundoff (rtol 1e-5, atol 1e-5 of
unit-variance data); the sharded acceleration search meets the JAX one at
``tests/test_torch_accel.py``'s engine bounds and the port's unsharded
search at 1e-4 (the shards' bank products sum in another order); the
sharded FFA meets the JAX one at its test's rtol 1e-4, atol 1e-4, and the
port's unsharded ``snr`` at 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P  # noqa: E402,E501

from baseband_tasks_tpu import parallel as jpar  # noqa: E402
from baseband_tasks_tpu.models import accelsearch as jacc  # noqa: E402
from baseband_tasks_tpu.models import ffa as jffa  # noqa: E402
from baseband_tasks_tpu.ops import dft_matmul as jdm  # noqa: E402
from baseband_tasks_tpu.parallel import halo_pallas as jhp  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

from baseband_tasks_tpu_torch import parallel as par  # noqa: E402
from baseband_tasks_tpu_torch.models import accelsearch as pacc  # noqa: E402
from baseband_tasks_tpu_torch.models import ffa as pffa  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

CPUS = ["cpu"] * 8
PADS = [(6, 4), (5, 0), (0, 3)]


def time_mesh(n=8):
    return JMesh(np.array(jax.devices()[:n]), ("time",))


def jax_sharded(fn, mesh, x):
    return np.asarray(jax.shard_map(fn, mesh=mesh, in_specs=P("time"),
                                    out_specs=P("time"),
                                    check_vma=False)(jnp.asarray(x)))


def port_blocks(x, n=8):
    return list(torch.from_numpy(x).chunk(n))


def joined(front, end):
    return np.concatenate([torch.cat([f, e]).numpy()
                           for f, e in zip(front, end)])


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# -- meshes ------------------------------------------------------------------

def test_make_mesh_shapes():
    mesh = par.make_mesh(time=4, chan=2, devices=CPUS)
    assert mesh.shape == {"time": 4, "chan": 2}
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert par.make_mesh(time=-1, chan=2, devices=CPUS).shape["time"] == 4
    assert par.make_mesh(time=2, chan=-1, devices=CPUS).shape["chan"] == 4
    # without devices: the CPU here (every CUDA device where there is one)
    assert par.make_mesh().devices.tolist() == [[torch.device("cpu")]]


@pytest.mark.parametrize("kw", [dict(time=16, chan=2),
                                dict(time=-1, chan=-1),
                                dict(time=0, chan=2), dict(time=2, chan=-3)])
def test_make_mesh_errors_match_jax(kw):
    assert _raises(lambda: par.make_mesh(devices=CPUS, **kw)) == _raises(
        lambda: jpar.make_mesh(**kw))


def test_shard_and_unshard_round_trip():
    mesh = par.make_mesh(time=4, chan=2, devices=CPUS)
    x = torch.arange(8 * 6 * 3, dtype=torch.float32).reshape(8, 6, 3)
    blocks = par.shard(x, mesh, ("time", "chan"))
    assert blocks[1, 1].shape == (2, 3, 3)
    assert torch.equal(blocks[1, 1], x[2:4, 3:6])
    assert torch.equal(par.unshard(blocks, mesh, ("time", "chan")), x)
    per_chan = par.shard(x[0], mesh, ("chan",))
    assert torch.equal(per_chan[3, 1], x[0, 3:])      # replicated in time
    assert torch.equal(par.unshard(per_chan, mesh, ("chan",)), x[0])
    with pytest.raises(ValueError, match="does not divide"):
        par.shard(x[:6], mesh, ("time", "chan"))


# -- halo exchange -----------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pads", PADS)
def test_halo_edges_match_jax(pads, periodic):
    ps, pe = pads
    x = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8 * 16, 3)

    def local(xl):
        f, e = jpar.halo_edges(xl, ps, pe, periodic=periodic)
        return jnp.concatenate([f, e])

    want = jax_sharded(local, time_mesh(), x)
    front, end = par.halo_edges(port_blocks(x), ps, pe, periodic=periodic)
    np.testing.assert_array_equal(joined(front, end), want)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pads", PADS)
def test_halo_exchange_matches_jax(pads, periodic):
    ps, pe = pads
    x = np.random.default_rng(1).standard_normal((8 * 16, 4)).astype(
        np.float32)
    want = jax_sharded(lambda xl: jpar.halo_exchange(xl, ps, pe,
                                                     periodic=periodic),
                       time_mesh(), x)
    got = par.halo_exchange(port_blocks(x), ps, pe, periodic=periodic)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_halo_along_axis_1_matches_jax():
    """The planes-first layout: time on axis 1."""
    x = np.random.default_rng(2).standard_normal((2, 8 * 16, 3)).astype(
        np.float32)

    def local(xl):
        f, e = jpar.halo_edges(xl, 5, 3, axis=1)
        return jnp.concatenate([f, e], axis=1)

    want = np.asarray(jax.shard_map(
        local, mesh=time_mesh(), in_specs=P(None, "time"),
        out_specs=P(None, "time"), check_vma=False)(jnp.asarray(x)))
    front, end = par.halo_edges(list(torch.from_numpy(x).chunk(8, dim=1)),
                                5, 3, axis=1)
    got = torch.cat([torch.cat([f, e], dim=1) for f, e in zip(front, end)],
                    dim=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("periodic", [False, True])
def test_single_shard(periodic):
    """One shard: zeros, or its own edges wrapped (JAX :45-53, :100-105);
    a lone non-periodic shard takes any pad."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    want = jax_sharded(lambda xl: jnp.concatenate(
        jpar.halo_edges(xl, 3, 2, periodic=periodic)), time_mesh(1), x)
    front, end = par.halo_edges([torch.from_numpy(x)], 3, 2,
                                periodic=periodic)
    np.testing.assert_array_equal(joined(front, end), want)
    window = par.halo_exchange([torch.from_numpy(x)], 3, 2,
                               periodic=periodic)[0]
    np.testing.assert_array_equal(window.numpy(), jax_sharded(
        lambda xl: jpar.halo_exchange(xl, 3, 2, periodic=periodic),
        time_mesh(1), x))
    if not periodic:
        front, end = par.halo_edges([torch.from_numpy(x)], 12, 9)
        assert front[0].shape == (12, 3) and not end[0].any()


def test_exceeding_pads_rejected_like_jax():
    x = np.zeros((40, 1), np.float32)
    want = _raises(lambda: jax_sharded(
        lambda xl: jpar.halo_edges(xl, 13, 2)[0], JMesh(np.array(
            jax.devices()[:4]), ("time",)), x))
    for fn in (par.halo_edges, par.halo_exchange, par.halo_edges_remote):
        assert _raises(lambda: fn(port_blocks(x, 4), 13, 2)) == want
    with pytest.raises(ValueError, match="exceeds local block"):
        par.halo_edges([torch.zeros(8, 1)], 9, 0, periodic=True)


def test_ppermute_moves_and_zero_fills():
    bufs = [torch.full((2,), float(i)) for i in range(4)]
    got = par.ppermute(bufs, [(0, 2), (3, 1)])
    assert [g.tolist() for g in got] == [[0, 0], [3, 3], [0, 0], [0, 0]]
    assert got[2].data_ptr() != bufs[0].data_ptr()      # a copy


# -- the remote (kernel) halo ------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pads", PADS)
def test_halo_edges_remote_matches_jax_kernel(pads, periodic):
    """The port's halo_remote (its plain version on CPU shards) against
    the JAX remote-DMA kernel in interpret mode on a 1-D mesh: exact."""
    ps, pe = pads
    x = np.arange(8 * 16 * 8, dtype=np.float32).reshape(8 * 16, 8)

    def local(xl):
        f, e = jhp.halo_edges_remote(xl, ps, pe, periodic=periodic,
                                     interpret=True)
        return jnp.concatenate([f, e])

    want = jax_sharded(local, time_mesh(), x)
    dd.reset_launch_counts()
    front, end = par.halo_edges_remote(port_blocks(x), ps, pe,
                                       periodic=periodic)
    np.testing.assert_array_equal(joined(front, end), want)
    assert dd.launch_counts["halo_remote"] == 0     # CPU: the plain copies
    window = par.halo_exchange_remote(port_blocks(x), ps, pe,
                                      periodic=periodic)
    np.testing.assert_array_equal(
        torch.cat(window).numpy(),
        torch.cat(par.halo_exchange(port_blocks(x), ps, pe,
                                    periodic=periodic)).numpy())


@pytest.mark.parametrize("dtype", [np.complex64, np.int32])
def test_halo_edges_remote_grid_of_rings(dtype):
    """A (time, chan) grid of blocks: each column is its own ring, in one
    call, with any dtype."""
    mesh = par.make_mesh(time=4, chan=2, devices=CPUS)
    x = np.arange(8 * 6 * 4).reshape(8, 6, 4).astype(dtype)
    if dtype == np.complex64:
        x = x + 1j * x[::-1]
    grid = par.shard(x, mesh, ("time", "chan"))
    front, end = par.halo_edges_remote(grid, 1, 2, periodic=True)
    assert front.shape == (4, 2)
    for c in range(2):
        col = [grid[t, c] for t in range(4)]
        f, e = par.halo_edges(col, 1, 2, periodic=True)
        for t in range(4):
            assert torch.equal(front[t, c], f[t])
            assert torch.equal(end[t, c], e[t])


def test_halo_remote_refuses_mixed_and_strided_blocks():
    meta = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        par.halo_edges_remote([torch.zeros(8, 2), meta], 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        par.halo_edges_remote([torch.zeros(2, 8).T] * 2, 1, 1)
    with pytest.raises(ValueError, match="one shape"):
        par.halo_edges_remote([torch.zeros(8, 2), torch.zeros(8, 3)], 1, 1)


def test_mesh_logical_id_matches_jax():
    """Row-major flattening of (time, chan) coordinates, as JAX's MESH
    addressing targets it, on a 2 x 4 mesh."""
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("time", "chan"))
    order = (("time", 2), ("chan", 4))

    def local(xl):
        t = jax.lax.axis_index("time")
        ids = jnp.stack([jhp.mesh_logical_id(order, "time", t),
                         jhp.mesh_logical_id(order, "time", (t + 1) % 2)])
        return xl * 0 + ids.astype(jnp.float32)[:, None]

    out = np.asarray(jax.shard_map(
        local, mesh=mesh, in_specs=P("time", "chan"),
        out_specs=P("time", "chan"), check_vma=False)(
            jnp.zeros((4, 8), jnp.float32)))
    for t in range(2):
        for c in range(4):
            blk = out[2 * t:2 * t + 2, 2 * c:2 * c + 2]
            coords = {"time": t, "chan": c}
            assert blk[0, 0] == par.mesh_logical_id(order, "time", t, coords)
            assert blk[1, 0] == par.mesh_logical_id(order, "time",
                                                    (t + 1) % 2, coords)


# -- sharded ops -------------------------------------------------------------

def test_sharded_overlap_save_matches_jax():
    x = np.random.default_rng(0).standard_normal((256, 2)).astype(np.float32)

    def fn(window):
        return window[:-2] + window[1:-1] + window[2:]

    want = np.asarray(jpar.sharded_overlap_save(
        fn, jpar.make_mesh(time=4, chan=2), 1, 1)(jnp.asarray(x)))
    got = par.sharded_overlap_save(
        fn, par.make_mesh(time=4, chan=2, devices=CPUS), 1, 1)(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    periodic = par.sharded_overlap_save(
        fn, par.make_mesh(time=4, chan=1, devices=CPUS), 1, 1,
        periodic=True)(x[:, :1])
    xp = np.concatenate([x[-1:, :1], x[:, :1], x[:1, :1]])
    np.testing.assert_allclose(periodic.numpy(),
                               xp[:-2] + xp[1:-1] + xp[2:], rtol=1e-6,
                               atol=1e-6)


def test_sharded_channelize_matches_jax():
    n, t_total = 32, 8 * 256
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((t_total, 2))
         + 1j * rng.standard_normal((t_total, 2))).astype(np.complex64)
    jmesh = time_mesh()
    want = np.asarray(jpar.sharded_channelize(jmesh, n)(
        jax.device_put(x, NamedSharding(jmesh, P("time")))))
    mesh = par.Mesh(CPUS, ("time",))
    got = par.sharded_channelize(mesh, n)(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    back = par.sharded_dechannelize(mesh)(got)
    want_back = np.asarray(jpar.sharded_dechannelize(jmesh)(
        jax.device_put(want, NamedSharding(jmesh, P(None, "time")))))
    np.testing.assert_allclose(back.numpy(), want_back, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        par.sharded_channelize(mesh, 12)


def test_corner_turn_moves():
    """Shard j receives piece j of every shard's channel axis, stacked
    in shard order along time."""
    blocks = [torch.arange(8.).reshape(2, 4) + 10 * i for i in range(2)]
    got = par.corner_turn(blocks)
    assert got[0].tolist() == [[0, 1], [4, 5], [10, 11], [14, 15]]
    assert got[1].tolist() == [[2, 3], [6, 7], [12, 13], [16, 17]]


# -- sharded searches --------------------------------------------------------

# engine tolerances of tests/test_torch_accel.py (the JAX side's sharded
# 'pallas' runs its FFT engine, so the port's bank correlation meets it
# at the pallas bound)
TOL = {"auto": 2e-4, "mx": 2e-4, "pallas": 2e-3}


def accel_pair(engine):
    kw = dict(z_max=32.0, z_step=2.0, seg_len=512)
    n = 1 << 12
    return (jacc.FourierDomainAccelSearch(n, 1 * ju.kHz, engine=engine, **kw),
            pacc.FourierDomainAccelSearch(n, 1 * pu.kHz, engine=engine,
                                          device="cpu", **kw))


def drifting_tone(n, seed=5):
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * (700 * t + 0.5 * 12.0 * t ** 2))
            + np.random.default_rng(seed).standard_normal(n) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("n_shards", [8, 3])
@pytest.mark.parametrize("engine", ["auto", "pallas", "mx"])
def test_search_sharded_matches_jax(engine, n_shards):
    """33 templates: padded over 8 shards, and over 3 (11 each)."""
    js, ps = accel_pair(engine)
    assert len(ps.z_values) == 33
    x = drifting_tone(ps.n_time)
    jmesh = JMesh(np.asarray(jax.devices()[:n_shards]), ("z",))
    with jdm.set_matmul_precision("highest"):
        want = np.asarray(js.search_sharded(x, jmesh))
    mesh = par.Mesh(["cpu"] * n_shards, ("z",))
    dd.reset_launch_counts()
    got = ps.search_sharded(x, mesh)
    assert got.shape == want.shape
    tol = TOL[engine]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), ps.search(x).numpy(),
                               rtol=1e-4, atol=1e-4)
    i, j = np.unravel_index(np.argmax(got.numpy()), got.shape)
    assert ps.z_values[j] == 12.0
    again = ps.search_sharded(torch.from_numpy(x), mesh)
    assert torch.equal(again, got) and len(ps._sharded_cache) == 1
    assert not any(dd.launch_counts.values())
    with pytest.raises(ValueError) as port_err:
        ps.search_sharded(x, mesh, axis_name="bogus")
    with pytest.raises(ValueError) as jax_err:
        js.search_sharded(x, jmesh, axis_name="bogus")
    assert str(port_err.value) == str(jax_err.value)


def test_snr_sharded_matches_jax():
    """12 rows over 8 shards (zero-padded) and over 4."""
    n, p = 4096, 20
    rng = np.random.default_rng(11)
    x = rng.standard_normal((12, n)).astype(np.float32) * 0.1
    x[5, ::p] += 5.0
    jf, pf = jffa.FastFoldingSearch(p, n), pffa.FastFoldingSearch(
        p, n, device="cpu")
    want = np.asarray(jf.snr_sharded(
        x, JMesh(np.asarray(jax.devices()[:8]), ("batch",))))
    for k in (8, 4):
        got = pf.snr_sharded(x, par.Mesh(["cpu"] * k, ("batch",)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), pf.snr(x).numpy(),
                                   rtol=1e-6, atol=1e-6)
    i, j = np.unravel_index(np.argmax(got.numpy()), got.shape)
    assert i == 5 and pf.trial_periods[j] == p
    with pytest.raises(ValueError, match="no axis"):
        pf.snr_sharded(x, par.Mesh(["cpu"] * 2, ("z",)))
    with pytest.raises(ValueError, match="stack of series"):
        pf.snr_sharded(x[0], par.Mesh(["cpu"] * 2, ("batch",)))
