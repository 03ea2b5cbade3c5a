"""The flagship slice of the PyTorch port against the JAX pipeline.

The port's ``run_fn`` is fed the same packed (or float32) blocks as the
JAX pipeline's own step, composed the way ``run_fn`` composes it: a
``shard_map`` of ``_local_step_pallas_split_packed`` (or
``_local_step_pallas_split``) on a (1, 1) mesh with the same chirp
storage, the same polyco fold table and the same float32 ``off`` carry.
The JAX side runs its Pallas kernels in interpret mode, the port its
plain versions on the CPU.

Counts must be identical.  Profiles sum ~700 detected samples per bin
and lane over three steps of two different float32 FFT algorithms:
rtol 1e-5, atol 1e-3 (the bins hold ~1e3).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import baseband_tasks_tpu.models as jmodels  # noqa: E402
from baseband_tasks_tpu import phases as jphases  # noqa: E402
from baseband_tasks_tpu import utils as jutils  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jun  # noqa: E402

import baseband_tasks_tpu_torch as bt  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3
N_ITER = 3


def polyco_text(f0=641.928123):
    """bench.py's synthetic B1937+21-like polyco."""
    return ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")


def config(units, bits=8):
    return dict(n_chan=8, n_pol=2, dm=0.5, freq_center=600 * units.MHz,
                chan_rate=250 * units.kHz, period_samples=(512, 1),
                n_phase=8, block_samples=1024, ingest_bits=bits)


def jax_pipe(polyco=True, bits=8):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("time", "chan"))
    extra = dict(phase_model=jphases.PolycoPhase(
        jphases.Polyco(polyco_text())),
        start_time=jutils.Time.from_mjd(58000.0)) if polyco else {}
    return jmodels.WidebandPulsarPipeline(
        mesh=mesh, use_pallas=True, **config(jutils.units, bits), **extra)


def port_kwargs(polyco=True, bits=8):
    extra = dict(phase_model=bt.PolycoPhase(bt.Polyco(polyco_text())),
                 start_time=bt.Time.from_mjd(58000.0)) if polyco else {}
    return dict(device="cpu", use_kernels=True, **config(bt.units, bits),
                **extra)


def jax_state(pipe, n_iter):
    T = pipe.global_block
    state = dict(pad_start=pipe.pad_start, pad_end=pipe.pad_end,
                 n_fft=pipe._n_fft, chirp_storage=pipe._chirp_storage_np())
    if pipe.fold_model is not None:
        h = pipe.fold_model.table(np.arange(n_iter) * T, T).astype(np.int64)
        state["fold_table"] = np.stack([(h[:, 0] << 16) | h[:, 1],
                                        (h[:, 2] << 16) | h[:, 3],
                                        np.zeros(len(h), np.int64)], 1)
    return state


def jax_run(pipe, local, cr, ci, n_iter, offset0=0):
    """The JAX pipeline's run_fn loop body, on given blocks."""
    sharded = jax.jit(jax.shard_map(
        local, mesh=pipe.mesh,
        in_specs=(P("time", "chan"), P("time", "chan"),
                  P(None, None, "chan"), P(None, None, "chan"), P(), P()),
        out_specs=(P(None, "chan"), P()), check_vma=False))
    csr, csi = pipe._chirp_storage_np()
    T = pipe.global_block
    table = (pipe.fold_model.table(offset0 + np.arange(n_iter) * T, T)
             if pipe.fold_model is not None else None)
    off = jnp.float32(float(offset0) % pipe._per_q)
    acc = cnt = 0
    for k in range(n_iter):
        foldv = (pipe._foldv_from_halves(jnp.asarray(table[k]))
                 if table is not None else pipe._fixed_foldv(off))
        prof, c = sharded(cr, ci, csr, csi, off, foldv)
        off = jnp.mod(off + T, float(pipe._per_q))
        acc, cnt = acc + prof, cnt + c
    return np.asarray(acc), np.asarray(cnt)


def packed_blocks(T, bits, seed):
    """Random fields packed for both: port int32 words, JAX carriers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        f = rng.integers(0, 1 << bits, (T, 16), dtype=np.uint8)
        q = T * bits // 32
        out.append((unpack.pack_time_planes(f, bits).reshape(q, 8, 2),
                    jnp.asarray(jun.pack_time_planes(f, bits)
                                .reshape(q, 8, 2))))
    return out


def assert_same(port, ref):
    prof, cnt = port
    np.testing.assert_array_equal(cnt.numpy(), ref[1])
    np.testing.assert_allclose(prof.numpy(), ref[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 2])
def test_constructor_state_matches_jax(bits):
    jp = jax_pipe(bits=bits)
    pp = bt.WidebandPulsarPipeline(**port_kwargs(bits=bits))
    for name in ("pad_start", "pad_end", "_n_fft", "block_samples",
                 "global_block", "_p_fx"):
        assert getattr(pp, name) == getattr(jp, name), name
    for a, b in zip(pp._chirp_storage_np(), jp._chirp_storage_np()):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    T = pp.global_block
    np.testing.assert_array_equal(
        pp.fold_model.table(np.arange(4) * T, T), jax_state(jp, 4)[
            "fold_table"])


def test_slice_packed_matches_jax():
    jp = jax_pipe()
    T = jp.global_block
    (wr, cr), (wi, ci) = packed_blocks(T, 8, seed=1)
    ref = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                        8), cr, ci, N_ITER)
    pp = bt.WidebandPulsarPipeline.from_jax_state(jax_state(jp, N_ITER),
                                                  **port_kwargs())
    run = pp.run_fn(N_ITER, ingest_bits=8)
    got = run(blocks=(wr, wi))
    assert int(got[1].sum()) == N_ITER * T
    assert_same(got, ref)
    # the port's own constructor computes from the same state
    own = bt.WidebandPulsarPipeline(**port_kwargs()).run_fn(
        N_ITER, ingest_bits=8)(blocks=(wr.numpy().view(np.uint32),
                                        wi.numpy().view(np.uint32)))
    assert_same(own, ref)


def test_slice_float_matches_jax():
    jp = jax_pipe()
    T = jp.global_block
    rng = np.random.default_rng(2)
    xr, xi = (rng.standard_normal((T, 8, 2)).astype(np.float32)
              for _ in range(2))
    ref = jax_run(jp, jp._local_step_pallas_split, jnp.asarray(xr),
                  jnp.asarray(xi), N_ITER)
    pp = bt.WidebandPulsarPipeline(**port_kwargs())
    assert_same(pp.run_fn(N_ITER)(blocks=(xr, xi)), ref)


def test_slice_fixed_period_matches_jax():
    """No phase model: the fold row comes from the float32 offset carry
    and the exact rational period, as in the JAX run loop."""
    jp = jax_pipe(polyco=False)
    T = jp.global_block
    (wr, cr), (wi, ci) = packed_blocks(T, 8, seed=3)
    ref = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                        8), cr, ci, N_ITER, offset0=1000)
    pp = bt.WidebandPulsarPipeline(**port_kwargs(polyco=False))
    assert_same(pp.run_fn(N_ITER, offset0=1000, ingest_bits=8)(
        blocks=(wr, wi)), ref)


@pytest.mark.parametrize("bits", [8, 2])
def test_run_fn_seeded_smoke(bits):
    pp = bt.WidebandPulsarPipeline(**port_kwargs(bits=bits))
    run = pp.run_fn(2, ingest_bits=bits)
    prof, cnt = run(seed=3)
    assert prof.shape == (8, 8, 2) and cnt.dtype == torch.float32
    assert int(cnt.sum()) == 2 * pp.global_block
    assert torch.isfinite(prof).all()
    again = run(seed=3)                       # the cached block is reused
    assert torch.equal(prof, again[0])
    # the test-only switch runs the kernel path on the plain versions
    # (on the CPU the wrappers take them anyway: the same numbers)
    with dd.plain_versions():
        plain = bt.WidebandPulsarPipeline(**port_kwargs(bits=bits))
        assert torch.equal(plain.run_fn(2, ingest_bits=bits)(seed=3)[0],
                           prof)


def test_rejects_unported_options():
    # Stokes pairs the (X, Y) lanes of a channel: dual polarization only
    with pytest.raises(ValueError, match="dual polarization"):
        bt.WidebandPulsarPipeline(**dict(port_kwargs(), n_pol=4,
                                         detect="stokes"))
    # bf16 intermediates are a mode of the split ops, Stokes or not (the
    # pipeline has no such option, in either package)
    rng = np.random.default_rng(5)
    prof, cnt = dd.dedisperse_fold_split(
        *(torch.tensor(rng.standard_normal(shape).astype(np.float32))
          for shape in ((896, 16),) * 2 + ((32, 16),) * 2 + ((96, 16),) * 2),
        *(torch.ones((32, 32, 16)), torch.zeros((32, 32, 16))),
        torch.as_tensor(dd.fold_phase_vector(0.0, 0.01)),
        torch.tensor([1.0]), n_phase=8, pad_start=32, n_valid=896,
        stokes=True, inter_dtype="bfloat16")
    assert prof.shape == (9, 48) and bool(torch.isfinite(prof).all())
    assert cnt.tolist()[-1] == 128 and int(cnt.sum()) == 1024
    pp = bt.WidebandPulsarPipeline(**port_kwargs())
    with pytest.raises(ValueError, match="ingest_bits"):
        pp.run_fn(1, ingest_bits=3)
    with pytest.raises(ValueError, match="block must be"):
        pp.run_fn(1, ingest_bits=8)(blocks=(np.zeros(4), np.zeros(4)))


# -- what run_fn makes once ---------------------------------------------------

def step_by_step(pipe, offset0, n_iter, bits):
    """Each step's float32 offset, (1,) kernel scale (1 + 1e-6·off)·norm
    and (3,) fixed-period fold row, from the offset carry advanced one
    step at a time as the JAX run loop does."""
    T, per_q = pipe.global_block, float(pipe._per_q)
    norm = {8: 1.0 / 64.0, 2: 1.0}.get(bits)
    off = torch.tensor(float(offset0) % per_q, dtype=torch.float32)
    out = []
    for _ in range(n_iter):
        scale = 1.0 + 1e-6 * off
        if norm is not None:
            scale = scale * norm
        out.append((off, scale.reshape(1), pipe._fixed_foldv(off)))
        off = torch.remainder(off + T, per_q)
    return out


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.is_floating_point() else a,
        b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("offset0", [0, 1000, 4099 - 300])
@pytest.mark.parametrize("bits", [8, 2, None])
def test_run_fn_tables_match_the_step_by_step_carry(bits, offset0):
    """The offsets, scales and fixed-period fold rows run_fn tabulates
    are, bit for bit, those of the carry advanced step by step; a period
    of 4099 samples makes it wrap every few steps (T is 1024 or 1792), and
    ``offset0`` starts it 300 samples short of the period.  ``bits``
    None is the plain path, which scales the block and folds on the row
    itself."""
    kw = dict(port_kwargs(polyco=False, bits=bits or 8),
              period_samples=(4099, 2), use_kernels=bits is not None)
    pp = bt.WidebandPulsarPipeline(**kw)
    n_iter = 12
    scales, rows = [], []
    if bits:
        step = pp._kernel_step

        def record(bits, bases, chirps, scale, folds, edges=None):
            scales.append(scale[0])
            rows.append(folds[0])
            return step(bits, bases, chirps, scale, folds, edges)
        pp._kernel_step = record
        blocks = [w for w, _ in packed_blocks(pp.global_block, bits, 8)]
    else:
        pairs, bins = pp._pairs_step, pp._shard_bins

        def record(grid, bins_of):
            scales.append(grid[0, 0].reshape(-1)[:1])
            return pairs(grid, bins_of)

        def record_bins(foldv):
            rows.append(foldv)
            return bins(foldv)
        pp._pairs_step, pp._shard_bins = record, record_bins
        blocks = [np.ones((pp.global_block, 8, 2, 2), np.float32)]
    pp.run_fn(n_iter, offset0=offset0, ingest_bits=bits)(blocks=blocks)
    want = step_by_step(pp, offset0, n_iter, bits)
    assert len(scales) == len(rows) == n_iter
    for scale, fold, (_, w_scale, w_fold) in zip(scales, rows, want):
        assert same_bits(scale, w_scale)
        if bits:
            w_fold = pp._shard_fold3(w_fold, 0).to(torch.int32)
        assert same_bits(fold, w_fold)
    offs = [float(off) for off, _, _ in want]
    assert sum(b < a for a, b in zip(offs, offs[1:])) >= 2


def test_run_fn_makes_edges_and_chirps_once(monkeypatch):
    """One time shard: the zero edges and the chirp planes are made on a
    run's first call and reused by the later ones (the outputs equal)."""
    pp = bt.WidebandPulsarPipeline(**port_kwargs())
    calls = []
    edges, chirp = pp._run_edges, pp._shard_chirp
    monkeypatch.setattr(pp, "_run_edges",
                        lambda *a: calls.append("edges") or edges(*a))
    monkeypatch.setattr(pp, "_shard_chirp",
                        lambda *a: calls.append("chirp") or chirp(*a))
    run = pp.run_fn(2, ingest_bits=8)
    (wr, _), (wi, _) = packed_blocks(pp.global_block, 8, seed=9)
    outs = [run(blocks=(wr, wi)) for _ in range(3)]
    assert calls == ["chirp", "edges"]
    for prof, cnt in outs[1:]:
        assert torch.equal(prof, outs[0][0]) and torch.equal(cnt, outs[0][1])


def test_run_fns_share_the_zero_edges(monkeypatch):
    """One time shard: the zero edges are the pipeline's, made by the
    first run_fn's first call and reused by every later run_fn (a run
    per stream offset, as a sub-integration's calls are)."""
    pp = bt.WidebandPulsarPipeline(**port_kwargs())
    calls = []
    edges = pp._run_edges
    monkeypatch.setattr(pp, "_run_edges",
                        lambda *a: calls.append("edges") or edges(*a))
    (wr, _), (wi, _) = packed_blocks(pp.global_block, 8, seed=9)
    runs = [pp.run_fn(1, offset0=k * pp.global_block, ingest_bits=8)
            for k in range(3)]
    outs = [run(blocks=(wr, wi)) for run in runs]
    assert calls == ["edges"]
    first = pp._dev[("zero edges", 8)]
    assert all(not t.any() for cell in first for t in cell)
    assert int(outs[2][1].sum()) == pp.global_block


@pytest.mark.parametrize("n_iter", [1, 3])
def test_run_fn_repeated_calls_match_jax(n_iter):
    """Calls on the same blocks give the same bits, a call's result is
    left untouched by later calls on other blocks (the sums start as a
    step's own output), and they match the JAX run loop, with one step
    and three."""
    jp = jax_pipe()
    T = jp.global_block
    (wr, cr), (wi, ci) = packed_blocks(T, 8, seed=10)
    other = [w for w, _ in packed_blocks(T, 8, seed=11)]
    ref = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                        8), cr, ci, n_iter, offset0=2 * T)
    pp = bt.WidebandPulsarPipeline.from_jax_state(jax_state(jp, n_iter + 2),
                                                  **port_kwargs())
    run = pp.run_fn(n_iter, offset0=2 * T, ingest_bits=8)
    first = run(blocks=(wr, wi))
    kept = [t.clone() for t in first]
    between = run(blocks=other)
    again = run(blocks=(wr, wi))
    assert not torch.equal(between[0], first[0])
    for a, b, c in zip(first, again, kept):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert first[1].dtype == torch.float32
    assert int(first[1].sum()) == n_iter * T
    assert_same(again, ref)
    with pytest.raises(ValueError, match="one step or more"):
        pp.run_fn(0)
