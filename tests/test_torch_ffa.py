"""The fast folding algorithm in the PyTorch port against the JAX package.

``models/ffa.py``: ``ffa_fold``, ``FastFoldingSearch.fold`` / ``snr`` /
``candidates`` and ``ffa_survey`` on the same seeded numpy series in both
packages (the JAX side is plain XLA on the CPU; the port plain torch).
Tolerance rtol 1e-5 (float32 sums in another order; the S/N adds a
median, a MAD and a cumsum).  The medians are taken over ``p`` phase
bins, often an even count: ``jnp.median`` averages the two middle values
there, ``torch.median`` returns the lower one, so even ``p`` is tested.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu.models import ffa as jffa  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

from baseband_tasks_tpu_torch.models import ffa as pffa  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

RTOL = 1e-5


def pulse_train(n, period, width=3, amp=1.5, noise=1.0, seed=0):
    """Gaussian noise plus a boxcar pulse every ``period`` samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * noise
    t = np.arange(n)
    x[(t % period) < width] += amp
    return x.astype(np.float32)


def search(p, n, **kw):
    return (jffa.FastFoldingSearch(p, n, **kw),
            pffa.FastFoldingSearch(p, n, device="cpu", **kw))


@pytest.mark.parametrize("p,n", [(16, 32), (21, 21 * 16), (32, 32 * 13),
                                 (64, 64 * 64)])
def test_ffa_fold_matches_jax(p, n):
    x = np.random.default_rng(p).standard_normal(n).astype(np.float32)
    want = np.asarray(jffa.ffa_fold(x, p))
    got = pffa.ffa_fold(x, p)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


def test_ffa_fold_batch_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 16 * 8)).astype(
        np.float32)
    want = np.asarray(jffa.ffa_fold(x, 16))
    got = pffa.ffa_fold(torch.as_tensor(x), 16)
    assert got.shape == (3, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("p", [16, 21, 64, 100])
def test_snr_matches_jax(p):
    """Even and odd p: the medians over p bins must average the two
    middle values for even p, as ``jnp.median`` does."""
    n = p * 64 + 7
    x = pulse_train(n, p + 0.3 if p % 2 else p, seed=p)
    js, ps = search(p, n)
    want = np.asarray(js.snr(x))
    got = ps.snr(x)
    assert got.shape == (ps.m,) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    assert int(got.argmax()) == int(want.argmax())
    np.testing.assert_allclose(ps.fold(x).numpy(), np.asarray(js.fold(x)),
                               rtol=RTOL, atol=1e-5)


def test_median_even_length():
    a = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(pffa._median(a)) == 2.5 == float(np.median(a.numpy()))
    assert float(torch.median(a)) == 2.0        # the trap
    assert float(pffa._median(a[:, :3])) == 3.0


def test_snr_zero_mad_scores_zero():
    p, n = 16, 16 * 32
    x = np.zeros(n, np.float32)
    js, ps = search(p, n)
    np.testing.assert_array_equal(ps.snr(x).numpy(), np.asarray(js.snr(x)))
    assert not ps.snr(x).any()


def test_candidates_match_jax():
    p, n = 50, 50 * 128
    x = pulse_train(n, 50.25, width=2, amp=2.0, seed=1)
    js, ps = search(p, n, sample_rate=1 * ju.kHz)
    ps.sample_rate = 1 * pu.kHz
    want, got = js.candidates(x, 6.0), ps.candidates(x, 6.0)
    assert got and [c["trial"] for c in got] == [c["trial"] for c in want]
    for g, w in zip(got, want):
        assert g["snr"] == pytest.approx(w["snr"], rel=RTOL)
        assert g["period"].to_value(pu.s) == w["period"].to_value(ju.s)
    best = got[0]["trial"]
    assert abs(ps.trial_periods.to_value(pu.s)[best] - 0.05025) < 1e-5


def test_survey_matches_jax():
    n = 1 << 12
    x = pulse_train(n, 23, width=2, amp=2.0, seed=2)
    want = jffa.ffa_survey(x, 8, 40, threshold=6.0)
    got = pffa.ffa_survey(x, 8, 40, threshold=6.0)
    key = [(c["base_period"], c["octave"], c["trial"]) for c in got]
    assert key and key == [(c["base_period"], c["octave"], c["trial"])
                           for c in want]
    for g, w in zip(got, want):
        assert g["period"] == w["period"]
        assert g["snr"] == pytest.approx(w["snr"], rel=RTOL)


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


BAD = {
    "base": lambda m: m.FastFoldingSearch(1, 100),
    "short": lambda m: m.FastFoldingSearch(60, 100),
    "fold": lambda m: m.ffa_fold(np.zeros(10, np.float32), 8),
    "block": lambda m: m.FastFoldingSearch(16, 256).fold(
        np.zeros(200, np.float32)),
    "survey_range": lambda m: m.ffa_survey(np.zeros(256, np.float32), 9, 9),
    "survey_dims": lambda m: m.ffa_survey(np.zeros((2, 256), np.float32),
                                          8, 9),
    "candidates": lambda m: m.FastFoldingSearch(16, 256).candidates(
        np.zeros((2, 256), np.float32)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_errors_match_jax(case):
    assert _raises(lambda: BAD[case](pffa)) == _raises(
        lambda: BAD[case](jffa))


def test_sharded_not_ported():
    """Once not ported: ``snr_sharded`` over one shard is ``snr``, and a
    zero row scores 0 (tests/test_torch_parallel.py holds it against
    the JAX package)."""
    from baseband_tasks_tpu_torch.parallel import Mesh
    f = pffa.FastFoldingSearch(16, 256, device="cpu")
    x = np.zeros((2, 256), np.float32)
    x[1] = pulse_train(256, 16)
    got = f.snr_sharded(x, Mesh(["cpu"], ("batch",)))
    assert torch.equal(got, f.snr(x))
    assert not got[0].any()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pffa.FastFoldingSearch(16, 256).device == torch.device("cuda")


class _Stop(Exception):
    """Raised by a spy once it has seen where the data would go."""


def test_numpy_input_goes_to_the_card(monkeypatch):
    """ffa_fold and ffa_survey given numpy: the card when there is one
    (numpy is converted there; a spy stops the call at the conversion)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(data, dtype=None, device=None):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(torch, "as_tensor", spy)
    x = pulse_train(1 << 10, 23)
    with pytest.raises(_Stop):
        pffa.ffa_fold(x, 16)
    with pytest.raises(_Stop):
        pffa.ffa_survey(x, 8, 40)
    assert seen == [torch.device("cuda")] * 2


def test_input_dtype_and_device():
    """float64 folds in float32, as the JAX package's jnp.asarray makes it;
    a tensor keeps its device, and device='cpu' keeps numpy on the host."""
    x = pulse_train(1 << 10, 23).astype(np.float64)
    got = pffa.ffa_fold(x, 16, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jffa.ffa_fold(x, 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    again = pffa.ffa_fold(torch.from_numpy(x), 16)
    assert again.dtype == torch.float32 and torch.equal(again, got)
    cands = pffa.ffa_survey(torch.from_numpy(x), 8, 40, threshold=6.0)
    assert cands == pffa.ffa_survey(x, 8, 40, threshold=6.0, device="cpu")
