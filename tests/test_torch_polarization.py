"""The port's polarization tasks (``polarization.py``) against the JAX
package.

Both packages get the same seeded numpy voltages through
``StreamGenerator``.  ``ConvertPolarization`` (both directions, every
label order, explicit axes) and ``ApplyJones`` (a full matrix, a
per-channel one, the inverse and ``inverse()``) agree with the JAX
package to float32 roundoff, rtol 1e-5 / atol 1e-6 on data of unit
scale, with the output labels and axes identical; the compiled chain of
the JAX package's ``tests/test_polarization.py`` (ConvertPolarization ->
Channelize -> Square, and ApplyJones with its inverse) equals its eager
stream and the JAX package's compiled chain, going through the complex
recombination of the planes step (neither task has a planes form), to
rtol 1e-5 / atol 1e-5 of data of unit scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.models.compiled import (  # noqa: E402
    CompiledPipeline as JCompiled)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline as PCompiled)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
START = "2020-01-01T00:00:00.0"
PORT, JAX = (pb, pu, PTime), (jb, ju, JTime)
JONES = np.array([[1.2, 0.1 + 0.05j], [-0.08j, 0.9]], np.complex64)


def voltages(shape=(4096, 2), seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def stream(side, data, pols=("X", "Y"), spf=1024):
    pkg, units, time = side

    def frame(sh):
        o = sh.tell()
        return data[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    gen = pkg.StreamGenerator(frame, data.shape, time(START),
                              1 * units.MHz, samples_per_frame=spf,
                              dtype=data.dtype, **kw)
    if pols is None:
        return gen
    return pkg.SetAttribute(gen, polarization=np.array(pols))


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def both(build):
    return build(PORT), build(JAX)


def check(p, j, n, atol=ATOL):
    got, want = host(p.read(n)), host(j.read(n))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    return got


@pytest.mark.parametrize("to, pols", [
    ("circular", ("X", "Y")), ("circular", ("Y", "X")),
    ("circular", ("H", "V")), ("linear", ("L", "R")),
    ("linear", ("R", "L"))])
def test_convert_matches_jax(to, pols):
    data = voltages()
    p, j = both(lambda s: s[0].ConvertPolarization(stream(s, data, pols),
                                                   to))
    np.testing.assert_array_equal(p.polarization, j.polarization)
    got = check(p, j, 4096)
    # unitary: total power conserved
    np.testing.assert_allclose((np.abs(got) ** 2).sum(1),
                               (np.abs(data) ** 2).sum(1), rtol=1e-5)


def test_convert_values_and_round_trip():
    data = voltages(seed=5)
    conv = pb.ConvertPolarization(stream(PORT, data), "circular")
    got = host(conv.read(256))
    np.testing.assert_allclose(
        got[:, 0], (data[:256, 0] - 1j * data[:256, 1]) / np.sqrt(2),
        rtol=1e-5, atol=1e-6)
    back = pb.ConvertPolarization(conv, "linear")
    back.seek(0)
    np.testing.assert_allclose(host(back.read(512)), data[:512],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(back.polarization, ["X", "Y"])


@pytest.mark.parametrize("pol_axis", [1, -1])
def test_convert_explicit_axis(pol_axis):
    """An explicit axis on a channelized sample shape (chan, pol)."""
    data = voltages((1024, 8, 2), seed=7)
    pols = np.array([["X", "Y"]] * 8)
    p, j = both(lambda s: s[0].ConvertPolarization(
        stream(s, data, pols), "circular", pol_axis=pol_axis))
    assert p._axis == j._axis
    np.testing.assert_array_equal(p.polarization, j.polarization)
    check(p, j, 1024)


@pytest.mark.parametrize("inverse", [False, True])
def test_jones_matches_jax(inverse):
    data = voltages(seed=11)
    p, j = both(lambda s: s[0].ApplyJones(stream(s, data), JONES,
                                          inverse=inverse))
    check(p, j, 4096)


def test_per_channel_jones_and_undo():
    data = voltages((2048, 16, 2), seed=13)
    rng = np.random.default_rng(0)
    jones = np.zeros((16, 2, 2), np.complex64)
    jones[:, 0, 0] = 1 + 0.1 * rng.standard_normal(16)
    jones[:, 1, 1] = 1 + 0.1 * rng.standard_normal(16)
    jones[:, 0, 1] = 0.05j * rng.standard_normal(16)
    p, j = both(lambda s: s[0].ApplyJones(stream(s, data), jones))
    got = check(p, j, 2048)
    np.testing.assert_allclose(got[..., 0], data[..., 0] * jones[:, 0, 0]
                               + data[..., 1] * jones[:, 0, 1],
                               rtol=1e-5, atol=1e-6)
    p.seek(0)
    undo = p.inverse()
    assert undo._inverse and undo._axis == p._axis
    np.testing.assert_allclose(host(undo.read(2048)), data, rtol=1e-4,
                               atol=1e-5)


def test_compiled_chain_matches_eager_and_jax():
    """The JAX package's test_compiled_chain, with ApplyJones and its
    inverse in the chain too."""
    data = voltages((1 << 14, 2), seed=19)

    def chain(s):
        sh = s[0].ConvertPolarization(stream(s, data), "circular")
        sh = s[0].ApplyJones(s[0].ApplyJones(sh, JONES), JONES,
                             inverse=True)
        return s[0].Square(s[0].Channelize(sh, 16))
    pt, jt = both(chain)
    ref = host(pt.read())
    np.testing.assert_allclose(ref, host(jt.read()), rtol=RTOL, atol=1e-5)
    pc, jc = PCompiled(chain(PORT)), JCompiled(chain(JAX))
    n = (1 << 14) // pc.block_samples
    blocks = pc.read_source_blocks(n)
    got = pc.run_fn(n)(blocks).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jc.run_fn(n)(np.asarray(jc.read_source_blocks(n)))),
        rtol=RTOL, atol=1e-5)
    step, carry = pc.planes_step(), pc.init_carry(planes=True)
    outs = []
    for b in blocks:
        carry, (yr, yi) = step(carry, b)
        outs.append(yr)
    np.testing.assert_allclose(torch.cat(outs).numpy(), got, rtol=RTOL,
                               atol=1e-5)


def test_validation_matches_jax():
    data = voltages((64, 2))
    for side in (PORT, JAX):
        pkg = side[0]
        with pytest.raises(ValueError, match="already"):
            pkg.ConvertPolarization(stream(side, data, ("L", "R")),
                                    "circular")
        with pytest.raises(ValueError, match="complex"):
            pkg.ConvertPolarization(stream(side, np.abs(data).astype(
                np.float32)), "circular")
        with pytest.raises(ValueError, match="labels"):
            pkg.ConvertPolarization(stream(side, data, None), "circular")
        with pytest.raises(ValueError, match=r"\(2, 2\)"):
            pkg.ApplyJones(stream(side, data), np.eye(3, dtype=np.complex64))
        with pytest.raises(ValueError, match="broadcast"):
            pkg.ApplyJones(stream(side, data),
                           np.zeros((7, 2, 2), np.complex64))
