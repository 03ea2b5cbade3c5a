"""The split ops' bf16-intermediate mode against the JAX package.

``inter_dtype='bfloat16'`` stores the planes between the three passes (y
after stage A, z after stage B, in place) as bfloat16 and computes in
float32.  The JAX side runs its Pallas kernels in interpret mode, the port
its plain versions (which round y and z to bfloat16 where the kernels
store them).  The geometry is that of ``TestBF16Intermediates``
(tests/test_pallas_kernels.py): T 7168, L 8, pads 512/512, 32 phase bins.

Bars: counts exact; profiles within 1e-3 of the peak, against the JAX
package's bf16 path and against the port's float32 path (the profile bar
of ``TestBF16Intermediates``: bf16 planes carry ~2^-9 relative rounding
per sample, which the fold averages down).  Stage A's bf16 planes agree
within one bf16 ulp plus 1e-6 of the peak: the float32 values before
rounding differ by FFT roundoff, so a few roundings may land on the
neighbouring bf16 value.
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

T, L, PS, PE, N_PHASE = 7168, 8, 512, 512, 32
N = T + PS + PE
N1, N2 = dd.split_n(N)
PROFILE_TOL = 1e-3
PARAMS = pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024)


def make_case(seed, edges=False, t=T, ps=PS):
    """TestBF16Intermediates' inputs: complex noise, zero pads (random
    ones with ``edges``), a quadratic-phase chirp per lane in d-major
    order, and a fold vector; ``t`` block rows and ``ps`` front pad rows
    in the N-row window."""
    pe = N - t - ps
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, L))
         + 1j * rng.standard_normal((t, L))).astype(np.complex64)
    k = np.fft.fftfreq(N)
    chirp = np.exp(-2j * np.pi * np.outer(30.0 * N * k ** 2 / 2,
                                          1 + np.arange(L) / L) / N
                   ).astype(np.complex64)
    cs = dd.permute_to_storage_order(chirp, N1, N2)
    if edges:
        fr, fi, er, ei = (rng.standard_normal((n, L)).astype(np.float32)
                          for n in (ps, ps, pe, pe))
    else:
        fr = fi = np.zeros((ps, L), np.float32)
        er = ei = np.zeros((pe, L), np.float32)
    return dict(x=(np.ascontiguousarray(x.real), np.ascontiguousarray(
                x.imag)), edges=(fr, fi, er, ei),
                chirp=(np.ascontiguousarray(cs.real),
                       np.ascontiguousarray(cs.imag)),
                fold=np.asarray(dd.fold_phase_vector(0.2, 1 / 97.3)),
                scale=np.ones(1, np.float32), t=t, ps=ps)


def tensors(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def jax_chirp(c, bf16_chirp):
    dt = jnp.bfloat16 if bf16_chirp else jnp.float32
    return [jnp.asarray(p).astype(dt) for p in c["chirp"]]


def port_chirp(c, bf16_chirp):
    dt = torch.bfloat16 if bf16_chirp else torch.float32
    return [t.to(dt) for t in tensors(*c["chirp"])]


def jax_split(c, inter_dtype, bf16_chirp=False, stokes=False):
    prof, cnt = jdp.dedisperse_fold_split(
        *map(jnp.asarray, c["x"] + c["edges"]), *jax_chirp(c, bf16_chirp),
        jnp.asarray(c["fold"]), jnp.asarray(c["scale"]), n_phase=N_PHASE,
        pad_start=PS, n_valid=T, stokes=stokes, inter_dtype=inter_dtype,
        interpret=True)
    return np.asarray(prof), np.asarray(cnt)


def port_split(c, inter_dtype, bf16_chirp=False, stokes=False):
    prof, cnt = dd.dedisperse_fold_split(
        *tensors(*c["x"], *c["edges"]), *port_chirp(c, bf16_chirp),
        *tensors(c["fold"], c["scale"]), n_phase=N_PHASE, pad_start=PS,
        n_valid=T, stokes=stokes, inter_dtype=inter_dtype)
    return prof.numpy(), cnt.numpy()


def assert_profile(got, want):
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < PROFILE_TOL, f"profile error {rel:.2e} of the peak"


@pytest.mark.parametrize("bf16_chirp", [False, True])
@pytest.mark.parametrize("seed", [12, 13])
def test_split_bf16_matches_jax(seed, bf16_chirp):
    c = make_case(seed)
    jp, jc = jax_split(c, "bfloat16", bf16_chirp)
    pp, pc = port_split(c, "bfloat16", bf16_chirp)
    np.testing.assert_array_equal(pc, jc)
    assert pc[-1] == 1024 and pc[:-1].sum() == T
    assert_profile(pp, jp)
    # and against the port's own float32 intermediates
    assert_profile(pp, port_split(c, "float32")[0])


def test_bf16_chirp_rounds_to_the_same_bits():
    c = make_case(12)
    for plane, t in zip(c["chirp"], port_chirp(c, True)):
        jbits = np.asarray(jnp.asarray(plane).astype(jnp.bfloat16)).view(
            np.uint16)
        pbits = t.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(pbits, jbits)


@pytest.mark.parametrize("inter_dtype", ["bfloat16", torch.bfloat16])
def test_inter_dtype_as_string_or_dtype(inter_dtype):
    c = make_case(12)
    got = port_split(c, inter_dtype)
    want = port_split(c, "bfloat16")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_split_bf16_stokes_matches_jax():
    c = make_case(13)
    jp, jc = jax_split(c, "bfloat16", True, stokes=True)
    pp, pc = port_split(c, "bfloat16", True, stokes=True)
    assert pp.shape == (N_PHASE + 1, 3 * L)
    np.testing.assert_array_equal(pc, jc)
    assert_profile(pp, jp)
    assert_profile(pp, port_split(c, "float32", stokes=True)[0])


@pytest.mark.parametrize("bits", [8, 2])
def test_split_packed_bf16_matches_jax(bits):
    # 48 main rows of N2 = 128: whole 2-bit words of 16 fields
    rng = np.random.default_rng(20 + bits)
    c = make_case(14, edges=True, t=6144, ps=1024)
    t, ps = c["t"], c["ps"]
    fields = [rng.integers(0, 1 << bits, (t, L), dtype=np.uint8)
              for _ in range(2)]
    scale = np.float32(0.25).reshape(1)
    jp, jc = jdp.dedisperse_fold_split_packed(
        *(jnp.asarray(jun.pack_time_planes(f, bits)) for f in fields),
        *map(jnp.asarray, c["edges"]), *jax_chirp(c, True),
        jnp.asarray(c["fold"]), jnp.asarray(scale), n_phase=N_PHASE,
        pad_start=ps, n_valid=t, bits=bits, inter_dtype="bfloat16",
        interpret=True)
    words = [unpack.pack_time_planes(f, bits) for f in fields]

    def port(inter_dtype):
        prof, cnt = dd.dedisperse_fold_split_packed(
            *words, *tensors(*c["edges"]), *port_chirp(c, True),
            *tensors(c["fold"], scale), n_phase=N_PHASE, pad_start=ps,
            n_valid=t, bits=bits, inter_dtype=inter_dtype)
        return prof.numpy(), cnt.numpy()

    pp, pc = port("bfloat16")
    np.testing.assert_array_equal(pc, np.asarray(jc))
    assert pc[-1] == N - t
    assert_profile(pp, np.asarray(jp))
    assert_profile(pp, port("float32")[0])


def test_stage_a_bf16_planes_match_jax():
    c = make_case(15, edges=True)
    got = dd.stage_a(*tensors(*c["x"], *c["edges"], c["scale"]),
                     out_dtype=torch.bfloat16)
    want = jdp._stage_a_stream2(*c["x"], *c["edges"], c["scale"], n1=N1,
                                n2=N2, block_b=8, interpret=True,
                                params=PARAMS, out_dtype=jnp.bfloat16)
    want = [np.asarray(w).astype(np.float32) for w in want]
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert got[0].shape == (N2, N1, L)
    peak = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp + 1e-6 * peak).all()


def test_bf16_stage_b_rounds_in_place():
    """Stage B on bf16 planes: computes in float32 and stores bf16 into
    the same tensors, with a float32 or a bf16 chirp (the same numbers
    for a chirp that is bf16-exact)."""
    c = make_case(16)
    y = dd.stage_a(*tensors(*c["x"], *c["edges"], c["scale"]),
                   out_dtype=torch.bfloat16)
    chirp16 = port_chirp(c, True)
    a = [p.clone() for p in y]
    b = [p.clone() for p in y]
    za = dd.stage_b(*a, *chirp16)
    zb = dd.stage_b(*b, *(p.float() for p in chirp16))
    assert za[0] is a[0] and za[1] is a[1]
    assert za[0].dtype == torch.bfloat16
    assert torch.equal(za[0], zb[0]) and torch.equal(za[1], zb[1])
    # what the plain version stores is the float32 result, rounded
    ref = dd.stage_b_ref(*(p.float() for p in y), *chirp16)
    assert torch.equal(za[0], ref[0].to(torch.bfloat16))


def test_bf16_mode_refusals():
    c = make_case(12)
    y = dd.stage_a(*tensors(*c["x"], *c["edges"], c["scale"]),
                   out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share one dtype"):
        dd.stage_b(y[0], y[1].float(), *port_chirp(c, False))
    with pytest.raises(TypeError, match="share one dtype"):
        dd.detect_fold(y[0].float(), y[1], torch.as_tensor(c["fold"]),
                       n_phase=N_PHASE, pad_start=PS, n_valid=T)
    # float32 planes take a float32 chirp only
    with pytest.raises(TypeError, match="expected one of"):
        dd.stage_b(y[0].float(), y[1].float(), *port_chirp(c, True))
    with pytest.raises(TypeError, match="out_dtype"):
        dd.stage_a(*tensors(*c["x"], *c["edges"], c["scale"]),
                   out_dtype=torch.float16)
    with pytest.raises(ValueError, match="inter_dtype"):
        port_split(c, "float16")
