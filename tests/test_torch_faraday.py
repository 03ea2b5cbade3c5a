"""The port's Faraday rotation (``faraday.py``) against the JAX package.

Both packages get the same seeded numpy voltages through
``StreamGenerator`` (a channelized dual-pol stream, 32 channels around
100 MHz with frequency and polarization labels).  ``FaradayRotate`` and
``DeFaraday`` agree with the JAX package for every label order and basis
(X/Y, Y/X, H/V, L/R, R/L; explicit and inferred axes; with and without a
reference frequency) to float32 roundoff: rtol 1e-5, atol 1e-6 on data
of unit scale.  The planes form equals the port's complex form and the
JAX planes form to the same bound, and a compiled planes chain takes it
(its ``task_planes`` called once a block) and equals the complex step
and the JAX package's compiled chain.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.faraday import C_M_PER_S as J_C  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.faraday import C_M_PER_S  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N_CHAN = 32
RM = 3.0
START = "2022-02-02T00:00:00.0"
FREQ_MHZ = 100.0 + (np.arange(N_CHAN) - N_CHAN / 2) * (50.0 / N_CHAN)
PORT, JAX = (pb, pu, PTime), (jb, ju, JTime)


def voltages(n=1024, seed=5, x_only=False):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, N_CHAN, 2))
         + 1j * rng.standard_normal((n, N_CHAN, 2))).astype(np.complex64)
    if x_only:
        z[..., 1] = 0
    return z


def stream(side, data, pols=("X", "Y"), spf=256, freq=True):
    pkg, units, time = side

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    gen = pkg.StreamGenerator(frame, data.shape, time(START),
                              1.5625 * units.MHz, samples_per_frame=spf,
                              dtype=data.dtype, **kw)
    attrs = {"polarization": np.array(pols)}
    if freq:
        attrs.update(frequency=FREQ_MHZ[:, None] * units.MHz, sideband=1)
    return pkg.SetAttribute(gen, **attrs)


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def both(build):
    return build(PORT), build(JAX)


def check(p, j, n):
    got, want = host(p.read(n)), host(j.read(n))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize("pols", [("X", "Y"), ("Y", "X"), ("H", "V"),
                                  ("L", "R"), ("R", "L")])
@pytest.mark.parametrize("ref", [None, 100.0])
def test_rotate_matches_jax(pols, ref):
    data = voltages()

    def build(s):
        kw = {} if ref is None else {"reference_frequency": ref * s[1].MHz}
        return s[0].FaradayRotate(stream(s, data, pols), RM, **kw)
    p, j = both(build)
    assert (p.basis, p._pol_axis, p._order) == (j.basis, j._pol_axis,
                                                j._order)
    np.testing.assert_array_equal(p._psi, j._psi)
    assert p.polarization.tolist() == list(pols)
    check(p, j, 1024)


def test_rotation_angle_convention():
    """A pure-X input rotated by psi becomes (X cos psi, X sin psi) with
    psi = RM lambda^2, in the port as in the JAX package."""
    data = voltages(x_only=True)
    got = host(pb.FaradayRotate(stream(PORT, data), RM).read(256))
    psi = RM * (C_M_PER_S / (FREQ_MHZ * 1e6)) ** 2
    np.testing.assert_allclose(got[..., 0], data[:256, :, 0] * np.cos(psi),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[..., 1], data[:256, :, 0] * np.sin(psi),
                               rtol=1e-4, atol=1e-4)
    assert C_M_PER_S == J_C


@pytest.mark.parametrize("basis", ["linear", "circular"])
@pytest.mark.parametrize("pol_axis", [1, -1])
def test_explicit_axis_and_basis(basis, pol_axis):
    data = voltages(seed=7)
    p, j = both(lambda s: s[0].FaradayRotate(
        stream(s, data), RM, basis=basis, pol_axis=pol_axis))
    assert p._pol_axis == j._pol_axis == 1
    check(p, j, 512)


def test_defaraday_round_trip():
    data = voltages(seed=9)
    p, j = both(lambda s: s[0].DeFaraday(
        s[0].FaradayRotate(stream(s, data), RM), RM))
    assert float(p.rm.to_value(pu.rad / pu.m ** 2)) == \
        float(j.rm.to_value(ju.rad / ju.m ** 2)) == RM
    got = check(p, j, 512)
    np.testing.assert_allclose(got, data[:512], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pols", [("X", "Y"), ("Y", "X"), ("L", "R"),
                                  ("R", "L")])
def test_planes_form(pols):
    """task_planes against the port's task and the JAX task_planes."""
    data = voltages(64, seed=11)
    p, j = both(lambda s: s[0].FaradayRotate(stream(s, data, pols), RM))
    want = host(p.task(torch.from_numpy(data)))
    yr, yi = p.task_planes((torch.from_numpy(data.real.copy()),
                            torch.from_numpy(data.imag.copy())))
    np.testing.assert_allclose(host(yr) + 1j * host(yi), want,
                               rtol=RTOL, atol=ATOL)
    jr, ji = j.task_planes((jnp.asarray(data.real), jnp.asarray(data.imag)))
    np.testing.assert_allclose(host(yr), host(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(host(yi), host(ji), rtol=RTOL, atol=ATOL)
    assert p.task_planes((torch.from_numpy(data.real.copy()), None)) \
        is NotImplemented


def test_compiled_planes_chain(monkeypatch):
    """DeFaraday in a compiled planes chain: the planes step calls its
    task_planes once a block and equals the complex step, the eager
    stream and the JAX package's compiled chain."""
    data = voltages(2048, seed=13)
    pc, jc = both(lambda s: (PCompiled if s is PORT else JCompiled)(
        s[0].Square(s[0].DeFaraday(stream(s, data), RM)),
        block_samples=256))
    calls = []
    node = next(st.node for st in pc.stages
                if isinstance(st.node, pb.DeFaraday))
    orig = node.task_planes
    monkeypatch.setattr(node, "task_planes",
                        lambda pair: calls.append(1) or orig(pair))
    blocks = pc.read_source_blocks(4)
    step, carry = pc.planes_step(), pc.init_carry(planes=True)
    outs = []
    for b in blocks:
        carry, (yr, yi) = step(carry, b)
        assert yi is None
        outs.append(yr)
    assert len(calls) == 4
    got = torch.cat(outs).numpy()
    np.testing.assert_allclose(got, pc.run_blocks(blocks).numpy(),
                               rtol=RTOL, atol=ATOL)
    want = np.asarray(jc.run_blocks(jc.read_source_blocks(4)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    eager = host(pb.Square(pb.DeFaraday(stream(PORT, data), RM)).read(1024))
    np.testing.assert_allclose(got, eager, rtol=RTOL, atol=1e-5)


def test_validation_matches_jax():
    data = voltages(64)
    for side in (PORT, JAX):
        with pytest.raises(ValueError, match="frequency"):
            side[0].FaradayRotate(stream(side, data, freq=False), RM)
        with pytest.raises(ValueError, match="complex"):
            side[0].FaradayRotate(
                stream(side, np.abs(data).astype(np.float32)), RM)
        with pytest.raises(ValueError, match="basis"):
            side[0].FaradayRotate(stream(side, data, ("A", "B")), RM)
