"""The port's dedispersion kernels module against the JAX Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version (torch.fft);
the JAX side runs its Pallas kernels in interpret mode.  Inputs are made
from numpy seeds and fed to both.

Tolerances: the two sides run different float32 FFT algorithms
(pocketfft vs the Stockham radix-8/4/2 of the Pallas kernels), so signal
planes agree to float32 FFT roundoff, ~1e-6 of the largest element: the
planes are held to 1e-5 of it.  Folded profiles sum ~100 detected samples
per bin and lane: rtol 1e-5 with atol 1e-3 (the bins hold ~1e2..1e4).
Counts, bins and decoded samples are integers or exact table values and
must be identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from baseband_tasks_tpu.ops import dedisperse_pallas as jdp  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jun  # noqa: E402

from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

PLANE_TOL = 1e-5
PROF_RTOL, PROF_ATOL = 1e-5, 1e-3
PARAMS = pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024)

# (bits, t_main, pad_start, pad_end, scale): the windows of
# tests/test_unpack_device.py, 1024 samples over 128 lanes
CASES = {8: (896, 32, 96, 1 / 64.0), 4: (768, 128, 128, 0.25),
         2: (512, 256, 256, 0.5), 1: (2048, 1024, 1024, 1.0)}
L, N_PHASE = 128, 8


def make_case(bits, seed=0):
    t_main, p0, p1, scale = CASES[bits]
    rng = np.random.default_rng(seed)
    fr_, fi_ = (rng.integers(0, 1 << bits, (t_main, L), dtype=np.uint8)
                for _ in range(2))
    dec = [unpack.decode_planes(unpack.pack_time_planes(f, bits),
                                bits).numpy() for f in (fr_, fi_)]
    ph = rng.uniform(-0.5, 0.5, (t_main + p0 + p1, L))
    n1, n2 = dd.split_n(t_main + p0 + p1)
    chirp = [dd.permute_to_storage_order(
        f(2 * np.pi * ph).astype(np.float32), n1, n2)
        for f in (np.cos, np.sin)]
    return dict(
        bits=bits, fields=(fr_, fi_), dec=dec,
        edges=(dec[0][-p0:], dec[1][-p0:], dec[0][:p1], dec[1][:p1]),
        chirp=chirp, fold=dd.fold_phase_vector(0.1, 1.0 / 97.0),
        scale=np.float32(scale).reshape(1), pad_start=p0, n_valid=t_main,
        n1=n1, n2=n2)


def tensors(*arrays):
    """Copies as tensors (stage B works in place on its inputs)."""
    return [torch.tensor(np.asarray(a)) for a in arrays]


def assert_planes(got, want):
    peak = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=PLANE_TOL * peak)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_stage_a_packed_matches_pallas(bits):
    c = make_case(bits)
    words = [unpack.pack_time_planes(f, bits) for f in c["fields"]]
    got = dd.stage_a_packed(*words, *tensors(*c["edges"], c["scale"]),
                            bits=bits)
    want = jdp._stage_a_stream2_packed(
        *(jnp.asarray(jun.pack_time_planes(f, bits)) for f in c["fields"]),
        *c["edges"], c["scale"], bits=bits,
        offset=unpack.default_offset(bits),
        levels=unpack.default_levels(bits), n1=c["n1"], n2=c["n2"],
        block_b=8, interpret=True, params=PARAMS)
    assert got[0].shape == (c["n2"], c["n1"], L)
    assert_planes(got, want)


def test_stage_a_float_matches_pallas():
    c = make_case(8, seed=1)
    got = dd.stage_a(*tensors(*c["dec"], *c["edges"], c["scale"]))
    want = jdp._stage_a_stream2(*c["dec"], *c["edges"], c["scale"],
                                n1=c["n1"], n2=c["n2"], block_b=8,
                                interpret=True, params=PARAMS)
    assert_planes(got, want)


def test_stage_b_in_place_matches_pallas():
    c = make_case(8, seed=2)
    rng = np.random.default_rng(2)
    y = [rng.standard_normal((c["n2"], c["n1"], L)).astype(np.float32)
         for _ in range(2)]
    yt = tensors(*y)
    got = dd.stage_b(*yt, *tensors(*c["chirp"]))
    assert got[0] is yt[0] and got[1] is yt[1]       # in place
    want = jdp._stage_b(*y, *c["chirp"], n1=c["n1"], n2=c["n2"],
                        block_c=8, interpret=True, params=PARAMS)
    assert_planes(got, want)


@pytest.mark.parametrize("rate", [1.0 / 97.0, 1 - 1e-8])
def test_fold_matches_pallas(rate):
    c = make_case(8, seed=3)
    rng = np.random.default_rng(3)
    z = [rng.standard_normal((c["n2"], c["n1"], L)).astype(np.float32)
         for _ in range(2)]
    fold = dd.fold_phase_vector(0.7, rate)
    prof, cnt = dd.detect_fold(*tensors(*z), torch.from_numpy(fold),
                               n_phase=N_PHASE, pad_start=c["pad_start"],
                               n_valid=c["n_valid"])
    wprof, wcnt = jdp._fold_pallas_call(
        *z, jnp.asarray(fold), n1=c["n1"], n2=c["n2"], block_b=8,
        n_phase=N_PHASE, pad_start=c["pad_start"], n_valid=c["n_valid"],
        stokes=False, params=PARAMS, interpret=True)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    # the counts are the reference bin map's histogram, trash bin last
    n = c["n1"] * c["n2"]
    t = np.arange(n)
    bins = dd.fold_bins_ref(fold, t, N_PHASE)
    valid = (t >= c["pad_start"]) & (t < c["pad_start"] + c["n_valid"])
    np.testing.assert_array_equal(
        cnt.numpy(), np.bincount(np.where(valid, bins, N_PHASE),
                                 minlength=N_PHASE + 1))
    np.testing.assert_allclose(prof.numpy(), np.asarray(wprof),
                               rtol=PROF_RTOL, atol=PROF_ATOL)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dedisperse_fold_split_packed(bits):
    c = make_case(bits, seed=4)
    kw = dict(n_phase=N_PHASE, pad_start=c["pad_start"],
              n_valid=c["n_valid"], bits=bits)
    args = (*c["edges"], *c["chirp"], c["fold"], c["scale"])
    got = dd.dedisperse_fold_split_packed(
        *(unpack.pack_time_planes(f, bits) for f in c["fields"]), *args,
        **kw)
    want = jdp.dedisperse_fold_split_packed(
        *(jnp.asarray(jun.pack_time_planes(f, bits)) for f in c["fields"]),
        *args, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=PROF_RTOL, atol=PROF_ATOL)


def test_dedisperse_fold_split():
    c = make_case(8, seed=5)
    kw = dict(n_phase=N_PHASE, pad_start=c["pad_start"],
              n_valid=c["n_valid"])
    args = (*c["dec"], *c["edges"], *c["chirp"], c["fold"], c["scale"])
    got = dd.dedisperse_fold_split(*args, **kw)
    want = jdp.dedisperse_fold_split(*args, **kw)
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=PROF_RTOL, atol=PROF_ATOL)


def test_cpu_wrappers_count_no_launch():
    c = make_case(8, seed=6)
    dd.reset_launch_counts()
    dd.dedisperse_fold_split(*c["dec"], *c["edges"], *c["chirp"], c["fold"],
                             c["scale"], n_phase=N_PHASE,
                             pad_start=c["pad_start"], n_valid=c["n_valid"])
    assert all(v == 0 for v in dd.launch_counts.values())


def test_wrappers_reject_other_devices():
    meta = torch.empty((896, L), device="meta")
    edge = torch.empty((32, L), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dd.stage_a(meta, meta, edge, edge, edge, edge,
                   torch.empty(1, device="meta"))


@pytest.mark.parametrize("kw, exc", [
    # Stokes is ported; bf16 intermediates are not, in either detection
    (dict(stokes=True, inter_dtype="bfloat16"), NotImplementedError),
    (dict(inter_dtype="bfloat16"), NotImplementedError),
    (dict(n_phase=1 << 16), ValueError),
    (dict(pad_start=64), ValueError)])
def test_rejects_unported_modes(kw, exc):
    c = make_case(8, seed=7)
    args = dict(n_phase=N_PHASE, pad_start=c["pad_start"],
                n_valid=c["n_valid"])
    args.update(kw)
    with pytest.raises(exc):
        dd.dedisperse_fold_split(*c["dec"], *c["edges"], *c["chirp"],
                                 c["fold"], c["scale"], **args)


def test_fold_accumulate_matches_jax():
    from baseband_tasks_tpu.ops import fold_accumulate as jfold
    from baseband_tasks_tpu_torch.ops import fold_accumulate
    rng = np.random.default_rng(8)
    power = rng.standard_normal((300, 4, 2)).astype(np.float32) ** 2
    bins = rng.integers(0, 16, 300).astype(np.int32)
    prof, cnt = fold_accumulate(torch.from_numpy(power),
                                torch.from_numpy(bins), 16)
    wprof, wcnt = jfold(jnp.asarray(power), jnp.asarray(bins), 16)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    np.testing.assert_allclose(prof.numpy(), np.asarray(wprof), rtol=1e-6,
                               atol=1e-6)

