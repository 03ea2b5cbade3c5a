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
    # bf16 intermediates are not ported, Stokes or not
    with pytest.raises(NotImplementedError):
        dd.dedisperse_fold_split(
            *(np.zeros((896, 16), np.float32),) * 2,
            *(np.zeros((32, 16), np.float32),) * 2,
            *(np.zeros((96, 16), np.float32),) * 2,
            *(np.zeros((32, 32, 16), np.float32),) * 2,
            dd.fold_phase_vector(0.0, 0.01), np.float32([1.0]), n_phase=8,
            pad_start=32, n_valid=896, stokes=True, inter_dtype="bfloat16")
    pp = bt.WidebandPulsarPipeline(**port_kwargs())
    with pytest.raises(ValueError, match="ingest_bits"):
        pp.run_fn(1, ingest_bits=3)
    with pytest.raises(ValueError, match="block must be"):
        pp.run_fn(1, ingest_bits=8)(blocks=(np.zeros(4), np.zeros(4)))
