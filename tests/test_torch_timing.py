"""The port's TOA fitting (``timing.py``) and PINT phase providers
(``phases/core.py`` ``PintPhase``, ``phases/pint_toas.py`` ``PintToas``)
against the JAX package.

Both are host numpy in both packages, so they agree exactly: the fitted
shift, its error, scale, baseline and S/N are equal as floats for every
case of the JAX package's ``tests/test_timing.py`` (and on noisy
profiles), and the TOAs are the same two-double times.  The PINT
adapters run against the stub pint of ``tests/test_pint.py`` (pint
itself is not installed): the same single vectorized call with the same
two-double MJD pairs and forwarded settings as the JAX adapters, the
per-TOA path of old PINT versions, the same phases, and the same
ImportError when pint is missing.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_pint import calls, stub_pint  # noqa: E402,F401
from test_timing import gaussian_profile, shifted  # noqa: E402

from baseband_tasks_tpu import timing as jtiming  # noqa: E402
from baseband_tasks_tpu.phases import Phase as JPhase  # noqa: E402
from baseband_tasks_tpu.phases.core import PintPhase as JPint  # noqa: E402
from baseband_tasks_tpu.phases.pint_toas import (  # noqa: E402
    PintToas as JToas)
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch import timing as ptiming  # noqa: E402
from baseband_tasks_tpu_torch.phases import (  # noqa: E402
    Phase as PPhase, PintPhase as PPint, PintToas as PToas)
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402


@pytest.mark.parametrize("shift", [0.0, 1.0, -3.0, 2.34567, -7.891, 31.5])
@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_fit_phase_shift_matches_jax(shift, noise):
    rng = np.random.default_rng(5)
    t = gaussian_profile(64)
    p = 3.0 * shifted(t, shift) + 0.7 + noise * rng.standard_normal(64)
    got = ptiming.fit_phase_shift(torch.from_numpy(p), t)
    want = jtiming.fit_phase_shift(p, t)
    assert got == want
    if not noise:
        assert got[0] == pytest.approx((shift + 32) % 64 - 32, abs=1e-6)


def test_fit_validation():
    for mod in (ptiming, jtiming):
        with pytest.raises(ValueError, match="equal-length"):
            mod.fit_phase_shift(np.zeros(8), np.zeros(9))
        with pytest.raises(ValueError, match="4 phase bins"):
            mod.fit_phase_shift(np.zeros(2), np.zeros(2))
    with pytest.raises(ValueError, match="1-D"):
        ptiming.ProfileTemplate(np.zeros((2, 4)))


@pytest.mark.parametrize("folded", ["float", "phase"])
def test_toa_matches_jax(folded):
    n_bin = 128
    tmpl = gaussian_profile(n_bin)
    prof = shifted(tmpl, 0.123 * n_bin)
    start = "2020-01-01T12:00:00.000000000"
    kw = {"float": (0.4, 0.4), "phase": (PPhase(12345.0, 0.25),
                                         JPhase(12345.0, 0.25))}[folded]
    ptoa, perr, psnr = ptiming.ProfileTemplate(tmpl).toa(
        prof, time=PTime(start), folded_phase=kw[0],
        period=pu.Quantity(1.0 / 641.0, pu.s))
    jtoa, jerr, jsnr = jtiming.ProfileTemplate(tmpl).toa(
        prof, time=JTime(start), folded_phase=kw[1],
        period=ju.Quantity(1.0 / 641.0, ju.s))
    assert (ptoa.jd1, ptoa.jd2) == (jtoa.jd1, jtoa.jd2)
    assert perr.to_value(pu.s) == jerr.to_value(ju.s)
    assert psnr == jsnr
    assert pb.ProfileTemplate is ptiming.ProfileTemplate


def test_pint_toas_match_jax(stub_pint):
    t_port = PTime.from_mjd(58001.0) + pu.Quantity(
        np.arange(1000) * 1e-3, pu.s)
    t_jax = JTime.from_mjd(58001.0) + ju.Quantity(
        np.arange(1000) * 1e-3, ju.s)
    kw = dict(ephemeris="de436", include_bipm=False, custom_flag=7)
    got = PToas("ao", pu.Quantity(1400.0, pu.MHz), **kw)(t_port)
    want = JToas("ao", ju.Quantity(1400.0, ju.MHz), **kw)(t_jax)
    assert calls == [("array", (1000,))] * 2
    np.testing.assert_array_equal(got.day, want.day)
    np.testing.assert_array_equal(got.frac, want.frac)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.obs == want.obs and got.kwargs == want.kwargs


def test_pint_toas_old_api(stub_pint, monkeypatch):
    monkeypatch.delattr(stub_pint.toa, "get_TOAs_array")
    t = PTime.from_mjd(58001.0) + pu.Quantity(np.arange(16) * 1e-3, pu.s)
    got = PToas("ao", pu.Quantity(1400.0, pu.MHz))(t)
    assert calls == [("list", 16)]
    sec = ((np.asarray(got.day) - 58001.0) + np.asarray(got.frac)) * 86400.0
    np.testing.assert_allclose(sec, np.arange(16) * 1e-3, atol=1e-9)


def test_pint_phase_matches_jax(stub_pint):
    pp = PPint("fake.par", "ao", pu.Quantity(1400.0, pu.MHz))
    jp = JPint("fake.par", "ao", ju.Quantity(1400.0, ju.MHz))
    dt = np.arange(64) / 64.0
    got = pp(PTime.from_mjd(58000.0) + pu.Quantity(dt, pu.s))
    want = jp(JTime.from_mjd(58000.0) + ju.Quantity(dt, ju.s))
    assert isinstance(got, PPhase)
    np.testing.assert_array_equal(got.count, want.count)
    np.testing.assert_array_equal(got.fraction, want.fraction)
    f = pp.apparent_spin_freq(PTime.from_mjd(58000.0) + pu.Quantity(dt, pu.s))
    np.testing.assert_array_equal(f.to_value(pu.Hz), 641.928123)


def test_pint_missing_raises(monkeypatch):
    for name in list(sys.modules):
        if name == "pint" or name.startswith("pint."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pint", None)
    for cls, units in ((PPint, pu), (JPint, ju)):
        with pytest.raises(ImportError, match="pint-pulsar"):
            cls("fake.par", "ao", units.Quantity(1400.0, units.MHz))
