"""The acceleration search in the PyTorch port against the JAX package.

Covers ``ops/accel_correlate.py`` (``bank_matmul_power``,
``accel_correlate_bank``) and ``models/accelsearch.py``
(``FourierDomainAccelSearch`` on its three engines, ``accel_template``,
``harmonic_sum``, ``candidates``, ``from_jax_state``).

Inputs are made from numpy seeds and fed to both packages.  The JAX side
runs its Pallas kernels in interpret mode at 'highest' matmul precision,
the port its plain versions on the CPU.  Tolerances: the template, the
bank tables and the harmonic sum exact; maps at the JAX package's own
engine bounds (``tests/test_accelsearch.py``): rtol/atol 2e-4 for 'mx'
and 'xla', 2e-3 for 'pallas' (its inverse FFT is a Stockham in interpret
mode on the JAX side), the argmax (f, z) identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu.models import accelsearch as jacc  # noqa: E402
from baseband_tasks_tpu.ops import accel_correlate as jac  # noqa: E402
from baseband_tasks_tpu.ops import dft_matmul as jdm  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

from baseband_tasks_tpu_torch.models import accelsearch as pacc  # noqa: E402
from baseband_tasks_tpu_torch.ops import accel_correlate as pac  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

TOL = {"mx": 2e-4, "xla": 2e-4, "pallas": 2e-3}


def drifting_tone(n, f0, z, noise=0.3, seed=9, amp=1.0):
    t = np.arange(n) / n
    rng = np.random.default_rng(seed)
    return (amp * np.cos(2 * np.pi * (f0 * t + 0.5 * z * t ** 2))
            + rng.standard_normal(n) * noise).astype(np.float32)


def searches(n, engine, **kw):
    """The JAX search and the port's on the CPU, same arguments."""
    return (jacc.FourierDomainAccelSearch(n, 1 * ju.kHz, engine=engine, **kw),
            pacc.FourierDomainAccelSearch(n, 1 * pu.kHz, engine=engine,
                                          device="cpu", **kw))


def jax_search(search, x):
    with jdm.set_matmul_precision("highest"):
        return np.asarray(search.search(x))


SMALL = dict(z_max=24, z_step=2, seg_len=512)          # TestPallasEngine
WIDE = dict(z_max=160, z_step=2.0, seg_len=1024)       # 161 trials


@pytest.mark.parametrize("z,m", [(0.0, 64), (20.0, 128), (-37.5, 256)])
def test_template_bit_exact(z, m):
    np.testing.assert_array_equal(pacc.accel_template(z, m),
                                  jacc.accel_template(z, m))


@pytest.mark.parametrize("kw", [SMALL, WIDE], ids=["small", "wide"])
def test_bank_tables_bit_exact(kw):
    js, ps = searches(1 << 12, "xla", **kw)
    np.testing.assert_array_equal(ps.zs, js.zs)
    assert (ps.m, ps._valid, ps._n_seg) == (js.m, js._valid, js._n_seg)
    for name in ("_tf_r", "_tf_i", "_taps_r", "_taps_i"):
        np.testing.assert_array_equal(getattr(ps, name),
                                      np.asarray(getattr(js, name)))
    for (jt, jn), (pt, pn) in zip(js._lane_banks(), ps._lane_banks()):
        assert jn == pn
        for a, b in zip(jt, pt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_mx_planes_bit_exact():
    js, ps = searches(1 << 13, "mx", **SMALL)
    for a, b in zip(js._mx_planes(), ps._mx_planes()):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(js._mx_fused_planes(), ps._mx_fused_planes()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("engine", ["mx", "pallas", "xla"])
def test_engine_matches_jax(engine):
    n = 1 << 13
    x = drifting_tone(n, 700, 10.0)
    js, ps = searches(n, engine, **SMALL)
    ref = jax_search(js, x)
    got = ps.search(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == ref.shape == (n // 2 + 1, len(js.zs))
    tol = TOL[engine]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    i, j = np.unravel_index(np.argmax(got), got.shape)
    assert (i, j) == np.unravel_index(np.argmax(ref), ref.shape)
    assert i == 700 and ps.z_values[j] == 10.0


def test_mx_odd_bank_and_window():
    """An odd template count and a non-pow2 user window: the mx engine
    fixes its own L = 2m window (JAX ``test_mx_engine_matches_xla``)."""
    n = 1 << 13
    x = drifting_tone(n, 700, 10.0)
    js, ps = searches(n, "mx", z_max=30, z_step=4, seg_len=500)
    ref, got = jax_search(js, x), ps.search(x).numpy()
    assert got.shape == (n // 2 + 1, len(ps.zs))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_wide_bank_matches_jax(engine):
    """161 trials: two 128-lane chunks on the pallas engine."""
    n = 1 << 12
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    js, ps = searches(n, engine, **WIDE)
    assert len(ps.zs) == 161 and len(ps._lane_banks()) == 2
    np.testing.assert_allclose(ps.search(x).numpy(), jax_search(js, x),
                               rtol=TOL[engine], atol=TOL[engine])


def test_bank_matmul_power_op():
    rng = np.random.default_rng(5)
    fr, fi = (rng.standard_normal((256, 64)).astype(np.float32)
              for _ in range(2))
    ka, kb, kc = (rng.standard_normal((64, 512)).astype(np.float32)
                  for _ in range(3))
    with jdm.set_matmul_precision("highest"):
        ref = np.asarray(jac.bank_matmul_power(fr, fi, ka, kb, kc))
    got = pac.bank_matmul_power(*map(torch.as_tensor, (fr, fi, ka, kb, kc)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_accel_correlate_bank_op():
    rng = np.random.default_rng(6)
    segs = (rng.standard_normal((3, 256))
            + 1j * rng.standard_normal((3, 256))).astype(np.complex64)
    tr, ti = (rng.standard_normal((256, pac.LANES)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jac.accel_correlate_bank(segs, tr, ti, valid=200))
    got = pac.accel_correlate_bank(torch.as_tensor(segs),
                                   torch.as_tensor(tr), torch.as_tensor(ti),
                                   valid=200)
    assert got.shape == ref.shape == (3, 200, pac.LANES)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_harmonic_sum_exact():
    n = 1 << 13
    x = drifting_tone(n, 500, 8.0, noise=0.2, seed=2)
    js, ps = searches(n, "xla", z_max=40, z_step=2, seg_len=1024)
    zmap = jax_search(js, x)
    want = js.harmonic_sum(zmap, n_harm=4)
    np.testing.assert_array_equal(ps.harmonic_sum(zmap, n_harm=4), want)
    np.testing.assert_array_equal(
        ps.harmonic_sum(torch.tensor(zmap), n_harm=4), want)
    np.testing.assert_array_equal(ps.harmonic_sum(zmap, 1), zmap)


@pytest.mark.parametrize("engine", ["mx", "xla"])
def test_candidates_match_jax(engine):
    n = 1 << 14
    x = drifting_tone(n, 1234.0, 16.0, noise=0.5, seed=0, amp=2.0)
    js, ps = searches(n, engine, z_max=32, z_step=2, seg_len=1024)
    with jdm.set_matmul_precision("highest"):
        want = js.candidates(x, threshold=50.0)
    got = ps.candidates(x, threshold=50.0)
    assert got and len(got) == len(want)
    for (f, z, p), (wf, wz, wp) in zip(got, want):
        assert f.to_value(pu.Hz) == wf.to_value(ju.Hz) and z == wz
        assert p == pytest.approx(wp, rel=2e-4)
    f, z, _ = got[0]
    assert abs(f.to_value(pu.Hz) - 1234.0 / n * 1e3) < 2e3 / n
    assert abs(z - 16.0) <= 2.0


def test_from_jax_state():
    n = 1 << 13
    kw = dict(z_max=24, z_step=2, seg_len=512)
    js = jacc.FourierDomainAccelSearch(n, 1 * ju.kHz, engine="pallas", **kw)
    state = {k: np.asarray(getattr(js, k))
             for k in ("zs", "_tf_r", "_tf_i", "_taps_r", "_taps_i")}
    ps = pacc.FourierDomainAccelSearch.from_jax_state(
        state, n, 1 * pu.kHz, engine="pallas", device="cpu", **kw)
    own = pacc.FourierDomainAccelSearch(n, 1 * pu.kHz, engine="pallas",
                                        device="cpu", **kw)
    x = drifting_tone(n, 700, 10.0)
    assert torch.equal(ps.search(x), own.search(x))
    np.testing.assert_allclose(ps.search(x).numpy(), jax_search(js, x),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="trials"):
        pacc.FourierDomainAccelSearch.from_jax_state(
            state, n, 1 * pu.kHz, z_max=30, z_step=2, seg_len=512)


def test_engine_choice():
    kw = dict(seg_len=1024)
    auto = pacc.FourierDomainAccelSearch(1 << 12, 1 * pu.kHz, device="cpu",
                                         **kw)
    # 'auto' on the CPU is the FFT engine, neither mx nor pallas, as the
    # JAX package's rule is off a TPU
    assert not auto._use_mx()
    assert auto._engine() == "xla"
    # and on the card the fused bank correlation: the rule of the device
    # type, checked without a card
    assert pacc.auto_engine("cuda") == "pallas"
    assert pacc.auto_engine("cpu") == "xla"
    assert pacc.FourierDomainAccelSearch(
        1 << 12, 1 * pu.kHz, engine="mx", device="cpu", **kw)._use_mx()
    # the sharded search runs the engine of each shard's device: 'auto'
    # is 'xla' on CPU shards
    from baseband_tasks_tpu_torch.parallel import Mesh
    s = pacc.FourierDomainAccelSearch(1 << 12, 1 * pu.kHz, device="cpu",
                                      **kw)
    s.search_sharded(np.zeros(1 << 12, np.float32), Mesh(["cpu"] * 2, ("z",)))
    shards = next(iter(s._sharded_cache.values()))
    assert [sh._use_mx() for sh in shards] == [False, False]
    assert [len(sh.zs) for sh in shards] == [33, 33]


def test_default_device_is_the_card(monkeypatch):
    """With a card present the search runs there unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    s = pacc.FourierDomainAccelSearch(1 << 12, 1 * pu.kHz, seg_len=1024)
    assert s.device == torch.device("cuda")
    # where 'auto' runs the fused bank correlation
    assert s._engine() == "pallas" and not s._use_mx()


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


BAD = {
    "engine": lambda m, u: m.FourierDomainAccelSearch(1 << 12, 1 * u.kHz,
                                                      engine="cuda"),
    "span": lambda m, u: m.FourierDomainAccelSearch(1 << 12, 1 * u.kHz,
                                                    z_max=1000,
                                                    seg_len=1024),
    "pallas_seg": lambda m, u: m.FourierDomainAccelSearch(
        1 << 14, 1 * u.kHz, seg_len=8192, engine="pallas"),
    "pallas_pow2": lambda m, u: m.FourierDomainAccelSearch(
        1 << 14, 1 * u.kHz, seg_len=1000, engine="pallas"),
    "shape": lambda m, u: m.FourierDomainAccelSearch(
        1 << 12, 1 * u.kHz, seg_len=1024, engine="xla").search(
            np.zeros(100)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_search_validation_matches_jax(case):
    want = _raises(lambda: BAD[case](jacc, ju))
    got = _raises(lambda: BAD[case](pacc, pu))
    # the port words the pallas limit in shared memory, the TPU in VMEM
    assert got == want.replace("VMEM", "shared-memory")


OPS_BAD = {
    "not_pow2": (lambda o: o.accel_correlate_bank(
        np.zeros((2, 500), np.complex64), np.zeros((500, 128), np.float32),
        np.zeros((500, 128), np.float32), valid=100), "power of two"),
    "too_long": (lambda o: o.accel_correlate_bank(
        np.zeros((1, 8192), np.complex64), np.zeros((8192, 128), np.float32),
        np.zeros((8192, 128), np.float32), valid=100), "exceeds"),
    "bank_shape": (lambda o: o.accel_correlate_bank(
        np.zeros((1, 512), np.complex64), np.zeros((512, 64), np.float32),
        np.zeros((512, 64), np.float32), valid=100), "bank planes"),
    "valid": (lambda o: o.accel_correlate_bank(
        np.zeros((1, 512), np.complex64), np.zeros((512, 128), np.float32),
        np.zeros((512, 128), np.float32), valid=600), "out of range"),
    "tiles": (lambda o: o.bank_matmul_power(
        *(np.zeros((100, 64), np.float32),) * 2,
        *(np.zeros((64, 512), np.float32),) * 3), "must tile"),
    "operator": (lambda o: o.bank_matmul_power(
        *(np.zeros((256, 64), np.float32),) * 2,
        *(np.zeros((32, 512), np.float32),) * 3), "operator planes"),
}


@pytest.mark.parametrize("case", sorted(OPS_BAD))
def test_op_validation_matches_jax(case):
    fn, match = OPS_BAD[case]
    want, got = _raises(lambda: fn(jac)), _raises(lambda: fn(pac))
    assert match in got and match in want
    if case != "too_long":       # the port's limit is worded for the card
        assert got == want
