"""The flagship's variants in the PyTorch port against the JAX package.

Covers the public dedispersion ops beside the split ones
(``dedisperse_pow2``, ``dedisperse_pow2_planes``,
``dedisperse_fold_pow2``, ``dedisperse_fold_stream`` with cos/sin and
phase-plane chirps) and full-Stokes folding, and the pipeline's entry
points that take the caller's data: ``step_fn`` and ``step_bins_fn`` on
both paths (``use_kernels`` / ``use_pallas`` False and True), with
``phase_bins``, the planes step, ``run_fn`` with Stokes and on the plain
path, and the constructor's geometry for every (use_kernels, fft_pow2).

Inputs are made from numpy seeds and fed to both packages.  The JAX side
runs its Pallas kernels in interpret mode, the port its plain versions
on the CPU.  Tolerances: counts, bins, geometry and chirp storage exact;
voltage and power planes to 1e-5 of their peak (float32 FFT roundoff is
~1e-6 of it); profiles rtol 1e-5 plus atol 1e-6 of the profile's peak
(the Stokes cross terms cross zero).
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
from baseband_tasks_tpu.ops import dedisperse_pallas as jdp  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jun  # noqa: E402

import baseband_tasks_tpu_torch as bt  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

PLANE_TOL = 1e-5
PROF_RTOL, PROF_ATOL = 1e-5, 1e-6       # atol as a fraction of the peak
N_PHASE = 8


def assert_planes(got, want):
    got, want = np.atleast_3d(np.asarray(got)), np.atleast_3d(
        np.asarray(want))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PLANE_TOL * np.abs(want).max())


def assert_profile(got, want):
    """Counts exact, profiles to rtol 1e-5 + 1e-6 of the peak."""
    (prof, cnt), (wprof, wcnt) = got, want
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(wcnt))
    wprof = np.asarray(wprof)
    assert prof.shape == wprof.shape
    np.testing.assert_allclose(np.asarray(prof), wprof, rtol=PROF_RTOL,
                               atol=PROF_ATOL * np.abs(wprof).max())


# -- the public ops ---------------------------------------------------------

N, L, P0, P1 = 1024, 16, 128, 128           # N1 = N2 = 32; pads 4 rows each


def op_case(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = dd.split_n(N)
    x2 = rng.standard_normal((2, N, L)).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, (n2, n1, L)).astype(np.float32)
    chirp = [f(2 * np.pi * theta.astype(np.float64)).astype(np.float32)
             for f in (np.cos, np.sin)]
    edges = [rng.standard_normal((2, p, L)).astype(np.float32)
             for p in (P0, P1)]
    return dict(x2=x2, theta=theta, chirp=chirp, edges=edges,
                fold=dd.fold_phase_vector(0.3, 1.0 / 97.0),
                scale=np.float32([0.75]),
                kw=dict(n_phase=N_PHASE, pad_start=P0, n_valid=N - P0 - P1))


@pytest.mark.parametrize("power", [False, True])
def test_dedisperse_pow2(power):
    c = op_case(1)
    got = dd.dedisperse_pow2(*c["x2"], *c["chirp"], power=power)
    want = jdp.dedisperse_pow2(*c["x2"], *c["chirp"], power=power)
    if power:
        assert got.shape == (N, L)
        assert_planes(got, want)
    else:
        assert_planes(np.stack(got), np.stack(want))


@pytest.mark.parametrize("power", [False, True])
def test_dedisperse_pow2_planes(power):
    c = op_case(2)
    got = dd.dedisperse_pow2_planes(torch.from_numpy(c["x2"]), *c["chirp"],
                                    power=power)
    want = jdp.dedisperse_pow2_planes(c["x2"], *c["chirp"], power=power)
    assert_planes(torch.stack(got) if not power else got,
                  np.stack(want) if not power else want)


@pytest.mark.parametrize("stokes", [False, True])
def test_dedisperse_fold_pow2(stokes):
    c = op_case(3)
    got = dd.dedisperse_fold_pow2(c["x2"], *c["chirp"], c["fold"],
                                  stokes=stokes, **c["kw"])
    want = jdp.dedisperse_fold_pow2(c["x2"], *c["chirp"], c["fold"],
                                    stokes=stokes, **c["kw"])
    assert got[0].shape == (N_PHASE + 1, 3 * L if stokes else L)
    assert got[1].dtype == torch.float32
    assert_profile(got, want)


@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("theta", [False, True])
def test_dedisperse_fold_stream(theta, stokes):
    c = op_case(4)
    x2 = c["x2"][:, :N - P0 - P1]
    chirp = (c["theta"], None) if theta else c["chirp"]
    args = (x2, *c["edges"], *chirp, c["fold"], c["scale"])
    got = dd.dedisperse_fold_stream(*args, stokes=stokes, **c["kw"])
    want = jdp.dedisperse_fold_stream(*args, stokes=stokes, **c["kw"])
    assert_profile(got, want)
    # the phase plane and the cos/sin planes are the same chirp
    other = dd.dedisperse_fold_stream(
        x2, *c["edges"], *((c["chirp"]) if theta else (c["theta"], None)),
        c["fold"], c["scale"], stokes=stokes, **c["kw"])
    assert_profile(other, want)


def test_fold_stokes_pairs_every_lane():
    """The Stokes profile's cross planes pair lane l with (l+1) mod L at
    every lane, the odd lanes and the wrap included, as the JAX kernel's
    one-lane roll does; its power plane is the power fold's."""
    c = op_case(5)
    n1, n2 = dd.split_n(N)
    rng = np.random.default_rng(5)
    z = [rng.standard_normal((n2, n1, L)).astype(np.float32)
         for _ in range(2)]
    kw = c["kw"]
    prof, cnt = dd.detect_fold(*map(torch.from_numpy, z),
                               torch.from_numpy(c["fold"]), stokes=True, **kw)
    want = jdp._fold_pallas_call(
        *z, jnp.asarray(c["fold"]), n1=n1, n2=n2, block_b=8, stokes=True,
        params=None, interpret=True, **kw)
    assert_profile((prof, cnt), want)
    power, _ = dd.detect_fold(*map(torch.from_numpy, z),
                              torch.from_numpy(c["fold"]), **kw)
    np.testing.assert_array_equal(prof[:, :L].numpy(), power.numpy())
    x = dd._inverse_stage_a(*map(torch.from_numpy, z)).numpy()
    t = np.arange(N)
    bins = dd.fold_bins_ref(c["fold"], t, N_PHASE)
    bins = np.where((t >= P0) & (t < N - P1), bins, N_PHASE)
    cross = np.zeros((N_PHASE + 1, L), np.complex128)
    np.add.at(cross, bins, x * np.conj(np.roll(x, -1, axis=1)))
    assert_planes(prof[:, L:].numpy(), np.concatenate([cross.real,
                                                       cross.imag], 1))


def test_split_ops_stokes():
    c = op_case(6)
    t_main = N - P0 - P1
    rng = np.random.default_rng(6)
    fields = [rng.integers(0, 256, (t_main, L), dtype=np.uint8)
              for _ in range(2)]
    edges = (c["edges"][0][0], c["edges"][0][1], c["edges"][1][0],
             c["edges"][1][1])
    tail = (*edges, *c["chirp"], c["fold"], c["scale"])
    kw = dict(stokes=True, **c["kw"])
    got = dd.dedisperse_fold_split(*c["x2"][:, :t_main], *tail, **kw)
    want = jdp.dedisperse_fold_split(*c["x2"][:, :t_main], *tail, **kw)
    assert_profile(got, want)
    got = dd.dedisperse_fold_split_packed(
        *(unpack.pack_time_planes(f, 8) for f in fields), *tail, **kw)
    want = jdp.dedisperse_fold_split_packed(
        *(jnp.asarray(jun.pack_time_planes(f, 8)) for f in fields), *tail,
        **kw)
    assert_profile(got, want)


def test_plain_versions_switch():
    """The test-only switch: wrappers on CPU tensors take the plain
    versions either way; the switch is undone on leaving."""
    c = op_case(7)
    dd.reset_launch_counts()
    with dd.plain_versions():
        assert dd._plain.get()
        got = dd.dedisperse_pow2(*c["x2"], *c["chirp"], power=True)
    assert not dd._plain.get()
    assert not any(dd.launch_counts.values())
    assert_planes(got, dd.dedisperse_pow2(*c["x2"], *c["chirp"],
                                          power=True))


@pytest.mark.parametrize("kw, exc, match", [
    (dict(stokes=True, fold=np.zeros(4, np.int32)), ValueError, "(3,)"),
    (dict(front_rows=16), ValueError, "multiple of N2"),
    (dict(n_phase=1 << 16), ValueError, "n_phase")])
def test_stream_op_rejections(kw, exc, match):
    c = op_case(8)
    front = c["edges"][0][:, :kw.pop("front_rows", P0)]
    fold = kw.pop("fold", c["fold"])
    args = dict(c["kw"], pad_start=front.shape[1])
    args.update(kw)
    with pytest.raises(exc, match=match):
        dd.dedisperse_fold_stream(c["x2"][:, :N - front.shape[1] - P1],
                                  front,
                                  c["edges"][1], *c["chirp"], fold,
                                  c["scale"], **args)


# -- the pipeline ----------------------------------------------------------

def polyco_text(f0=641.928123):
    """bench.py's synthetic B1937+21-like polyco."""
    return ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")


def kw(units, **extra):
    """tests/test_parallel.py TestStokesDetection.KW."""
    return dict(n_chan=8, n_pol=2, dm=1.0, freq_center=600 * units.MHz,
                chan_rate=250 * units.kHz, period_samples=(800, 1),
                n_phase=16, block_samples=1024, **extra)


def mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("time", "chan"))


def pipes(kernels, detect="power", fft_pow2=False, polyco=False):
    """(JAX pipeline, port pipeline) with the same arguments."""
    jextra = pextra = {}
    if polyco:
        jextra = dict(phase_model=jphases.PolycoPhase(
            jphases.Polyco(polyco_text())),
            start_time=jutils.Time.from_mjd(58000.0))
        pextra = dict(phase_model=bt.PolycoPhase(bt.Polyco(polyco_text())),
                      start_time=bt.Time.from_mjd(58000.0))
    jp = jmodels.WidebandPulsarPipeline(
        mesh=mesh(), use_pallas=kernels, fft_pow2=fft_pow2,
        **kw(jutils.units, detect=detect, **jextra))
    pp = bt.WidebandPulsarPipeline(
        device="cpu", use_kernels=kernels, fft_pow2=fft_pow2,
        **kw(bt.units, detect=detect, **pextra))
    return jp, pp


def voltages(pipe, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (pipe.global_block, 8, 2, 2)).astype(np.float32)


@pytest.mark.parametrize("kernels, fft_pow2", [(False, False),
                                               (False, True), (True, False)])
def test_constructor_state_matches_jax(kernels, fft_pow2):
    jp, pp = pipes(kernels, fft_pow2=fft_pow2)
    for name in ("pad_start", "pad_end", "_n_fft", "block_samples",
                 "global_block"):
        assert getattr(pp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(np.stack(pp._chirp_np, -1),
                                  jp._chirp_np[:, :, 0])
    np.testing.assert_array_equal(pp._theta_np, jp._theta_np)
    pow2 = (pp._n_fft & (pp._n_fft - 1)) == 0
    assert pow2 == (kernels or fft_pow2)
    if pow2:
        for a, b in zip(pp._chirp_storage_np(), jp._chirp_storage_np()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pp._chirp_theta_storage_np(),
                                      jp._chirp_theta_storage_np())
    else:      # no four-step storage order for a 2/3/5-smooth window
        for fn in ("_chirp_storage_np", "_chirp_theta_storage_np"):
            with pytest.raises(ValueError):
                getattr(pp, fn)()
            with pytest.raises(ValueError):
                getattr(jp, fn)()


@pytest.mark.parametrize("fold", ["offset", "polyco"])
@pytest.mark.parametrize("detect", ["power", "stokes"])
@pytest.mark.parametrize("kernels", [False, True])
def test_step_fn_matches_jax(kernels, detect, fold):
    jp, pp = pipes(kernels, detect, polyco=fold == "polyco")
    xf = voltages(pp, 11)
    T = pp.global_block
    if fold == "polyco":
        halves = jp.fold_model.foldv(3 * T, T)
        row = pp.fold_model.foldv(3 * T, T)
        h = halves.astype(np.int64)
        np.testing.assert_array_equal(
            row, [(h[0] << 16) | h[1], (h[2] << 16) | h[3], 0])
        jarg, parg = jnp.asarray(halves), row
    else:
        jarg, parg = jnp.float32(1234), 1234
    want = jp.step_fn()(jnp.asarray(xf), jarg)
    got = pp.step_fn()(xf, parg)
    assert got[0].shape == (16, 8, 4 if detect == "stokes" else 2)
    assert got[1].dtype == torch.float32
    assert int(got[1].sum()) == T
    assert_profile(got, want)


@pytest.mark.parametrize("detect", ["power", "stokes"])
@pytest.mark.parametrize("kernels", [False, True])
def test_step_bins_fn_matches_jax(kernels, detect):
    jp, pp = pipes(kernels, detect)
    xf = voltages(pp, 12)
    T = pp.global_block
    rng = np.random.default_rng(12)
    # out-of-range and fractional bins are clipped / truncated alike
    bins = rng.uniform(-2, 18, T).astype(np.float32)
    want = jp.step_bins_fn()(jnp.asarray(xf), jnp.asarray(bins))
    got = pp.step_bins_fn()(torch.from_numpy(xf), bins)
    assert_profile(got, want)


@pytest.mark.parametrize("offset", [0, 123456789])
def test_phase_bins_bit_for_bit(offset):
    jp, pp = pipes(False)
    want = jp.phase_bins(jphases.PolycoPhase(jphases.Polyco(polyco_text())),
                         jutils.Time.from_mjd(58000.0), offset=offset)
    got = pp.phase_bins(bt.PolycoPhase(bt.Polyco(polyco_text())),
                        bt.Time.from_mjd(58000.0), offset=offset)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("detect", ["power", "stokes"])
@pytest.mark.parametrize("theta", [False, True])
def test_planes_step_matches_jax(theta, detect):
    """The planes step, as tests/test_parallel.py composes the JAX
    ``_local_step_pallas_planes`` (its chirp as cos/sin planes; the
    port's phase-plane variant is the same chirp)."""
    jp, pp = pipes(True, detect)
    xf = voltages(pp, 13)
    off = jnp.float32(128)
    sharded = jax.shard_map(
        jp._local_step_pallas_planes, mesh=jp.mesh,
        in_specs=(P(None, "time", "chan"), P(None, None, "chan"),
                  P(None, None, "chan"), P(), P()),
        out_specs=(P(None, "chan"), P()), check_vma=False)
    csr, csi = jp._chirp_storage_np()
    want = jax.jit(sharded)(jnp.moveaxis(jnp.asarray(xf), -1, 0),
                            jnp.asarray(csr), jnp.asarray(csi), off,
                            jax.jit(jp._fixed_foldv)(off))
    chirp = (pp._theta_device(), None) if theta else pp._chirp_device()
    dd.reset_launch_counts()
    got = pp.planes_step(np.moveaxis(xf, -1, 0), *chirp, 128, 128)
    assert not any(dd.launch_counts.values())
    assert_profile(got, want)


def jax_run(pipe, local, bases, chirp, n_iter, offset0=0):
    """The JAX pipeline's run_fn loop body on given blocks: ``local`` a
    split step (bases (re, im), chirp storage planes) or ``_local_step``
    (bases (xf,) scaled per step, the natural-order chirp pairs)."""
    split = len(bases) == 2
    specs = ((P("time", "chan"),) * 2 + (P(None, None, "chan"),) * 2 +
             (P(), P())) if split else (P("time", "chan"), P(None, "chan"),
                                        P())
    sharded = jax.jit(jax.shard_map(
        local, mesh=pipe.mesh, in_specs=specs,
        out_specs=(P(None, "chan"), P()), check_vma=not split))
    T = pipe.global_block
    table = (pipe.fold_model.table(offset0 + np.arange(n_iter) * T, T)
             if pipe.fold_model is not None else None)
    off = jnp.float32(float(offset0) % pipe._per_q)
    acc = cnt = 0
    for k in range(n_iter):
        foldv = (pipe._foldv_from_halves(jnp.asarray(table[k]))
                 if table is not None else pipe._fixed_foldv(off))
        if split:
            prof, c = sharded(*bases, *chirp, off, foldv)
        else:
            prof, c = sharded(bases[0] * (1.0 + 1e-6 * off), *chirp, foldv)
        off = jnp.mod(off + T, float(pipe._per_q))
        acc, cnt = acc + prof, cnt + c
    return np.asarray(acc), np.asarray(cnt)


def test_run_fn_stokes_matches_jax():
    jp, pp = pipes(True, "stokes", polyco=True)
    T = pp.global_block
    rng = np.random.default_rng(14)
    fields = [rng.integers(0, 256, (T, 16), dtype=np.uint8)
              for _ in range(2)]
    q = T // 4
    want = jax_run(jp, functools.partial(jp._local_step_pallas_split_packed,
                                         8),
                   [jnp.asarray(jun.pack_time_planes(f, 8).reshape(q, 8, 2))
                    for f in fields], jp._chirp_storage_np(), 3)
    got = pp.run_fn(3, ingest_bits=8)(blocks=[
        unpack.pack_time_planes(f, 8).reshape(q, 8, 2) for f in fields])
    assert got[0].shape == (16, 8, 4) and int(got[1].sum()) == 3 * T
    assert_profile(got, want)


@pytest.mark.parametrize("detect", ["power", "stokes"])
def test_run_fn_plain_path_matches_jax(detect):
    """use_kernels=False is the JAX ``_local_step`` loop, from the port's
    own constructor and resumed from the JAX state."""
    jp, pp = pipes(False, detect)
    xf = voltages(pp, 15)
    want = jax_run(jp, jp._local_step, [jnp.asarray(xf)],
                   [jnp.asarray(jp._chirp_np)], 3, offset0=1000)
    got = pp.run_fn(3, offset0=1000)(blocks=[xf])
    assert_profile(got, want)
    state = dict(pad_start=jp.pad_start, pad_end=jp.pad_end,
                 n_fft=jp._n_fft, chirp=jp._chirp_np, theta=jp._theta_np)
    resumed = bt.WidebandPulsarPipeline.from_jax_state(
        state, device="cpu", **kw(bt.units, detect=detect))
    assert resumed._n_fft == 1280
    assert_profile(resumed.run_fn(3, offset0=1000)(blocks=[xf]), want)
    with pytest.raises(ValueError, match="packed ingest requires"):
        pp.run_fn(1, ingest_bits=8)


def test_pipeline_rejections():
    with pytest.raises(ValueError, match="dual polarization"):
        bt.WidebandPulsarPipeline(device="cpu", **dict(
            kw(bt.units, detect="stokes"), n_pol=4))
    _, pp = pipes(True)
    xf = voltages(pp, 16)
    with pytest.raises(ValueError, match="halves"):
        pp.step_fn()(xf, np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="kernel path"):
        pipes(False)[1].planes_step(np.moveaxis(xf, -1, 0), *pp._chirp_device(),
                                    0, 0)
