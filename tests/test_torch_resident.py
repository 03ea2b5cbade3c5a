"""The single-pass resident dedisperse → fold op in the PyTorch port
against the JAX package, and against the port's three-pass chain.

``ops/dedisperse_resident.dedisperse_fold_resident`` on both engines,
power and Stokes, at the JAX test's ``make_case`` sizes (T 6144, L 8,
window 2048, pads 256).  The JAX side runs its Pallas kernel in interpret
mode, the port its plain versions on the CPU ('stockham' the four-step FFT
form, 'mxu' the DFT-matmul form).  Tolerances: counts exact; profiles
within 2e-4 of the JAX output's peak (the JAX test's bound against its
float64 reference); the resident form against the three-pass chain at a
whole-block window within 5e-4 of the peak (the JAX test's bound).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from baseband_tasks_tpu.ops import dedisperse_resident as jres  # noqa: E402

from baseband_tasks_tpu_torch.ops import dedisperse as pdd  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse_resident as pres  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_dedisperse_resident import chirp_at, make_case  # noqa: E402

N_WINDOW, PS, PE = 2048, 256, 256


def planes(*arrays):
    """Real and imaginary float32 planes of complex arrays, in order."""
    out = []
    for a in arrays:
        out += [np.ascontiguousarray(a.real, np.float32),
                np.ascontiguousarray(a.imag, np.float32)]
    return out


def both(x, front, end, chirp, foldv, *, n_window=N_WINDOW, ps=PS, pe=PE,
         n_phase=16, stokes=False, engine="stockham"):
    """(JAX, port) profile and counts as numpy, on the same inputs."""
    hop, n1, n2 = pres.resident_geometry(n_window, ps, pe)
    stor = pdd.permute_to_storage_order(chirp.astype(np.complex64), n1, n2)
    args = planes(x, front, end, stor) + [np.asarray(foldv, np.int32),
                                          np.ones(1, np.float32)]
    kw = dict(n_window=n_window, n_phase=n_phase, pad_start=ps, pad_end=pe,
              stokes=stokes, engine=engine)
    jp, jc = jres.dedisperse_fold_resident(*map(jnp.asarray, args),
                                           interpret=True, **kw)
    pp, pc = pres.dedisperse_fold_resident(*args, **kw)
    assert pp.dtype == pc.dtype == torch.float32
    return (np.asarray(jp), np.asarray(jc)), (pp.numpy(), pc.numpy())


@pytest.mark.parametrize("engine", ["stockham", "mxu"])
@pytest.mark.parametrize("stokes", [False, True])
def test_matches_jax(stokes, engine):
    x, front, end, hc, ha = make_case()
    foldv = pdd.fold_phase_vector(0.123, 1.0 / 300.7)
    (jp, jc), (pp, pc) = both(x, front, end, chirp_at(N_WINDOW, hc, ha),
                              foldv, stokes=stokes, engine=engine)
    assert pp.shape == jp.shape == (17, 24 if stokes else 8)
    np.testing.assert_array_equal(pc, jc)
    assert pc[16] == (PS + PE) * (x.shape[0] // (N_WINDOW - PS - PE))
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-4 * np.abs(jp).max())


def test_window_4096_matches_jax():
    x, front, end, hc, ha = make_case(seed=5, T=3584 * 2)
    foldv = pdd.fold_phase_vector(0.7, 1.0 / 97.1)
    (jp, jc), (pp, pc) = both(x, front, end, chirp_at(4096, hc, ha), foldv,
                              n_window=4096, n_phase=32)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-4 * np.abs(jp).max())


def test_engines_agree():
    x, front, end, hc, ha = make_case(seed=11)
    hop, n1, n2 = pres.resident_geometry(N_WINDOW, PS, PE)
    stor = pdd.permute_to_storage_order(
        chirp_at(N_WINDOW, hc, ha).astype(np.complex64), n1, n2)
    args = planes(x, front, end, stor) + [
        pdd.fold_phase_vector(0.25, 1.0 / 211.9), np.ones(1, np.float32)]
    kw = dict(n_window=N_WINDOW, n_phase=8, pad_start=PS, pad_end=PE)
    ps_, cs = pres.dedisperse_fold_resident(*args, engine="stockham", **kw)
    pm, cm = pres.dedisperse_fold_resident(*args, engine="mxu", **kw)
    assert torch.equal(cs, cm)
    assert float((pm - ps_).abs().max()) <= 2e-4 * float(ps_.abs().max())


@pytest.mark.parametrize("stokes", [False, True])
def test_matches_three_pass_chain(stokes):
    """Same FIR, two window sizes, the port's two paths: the resident
    windows of 2048 against one 8192-row window of the three-pass chain
    (the JAX test's construction: halos zero-extended, i0 shifted in fixed
    point by the later start of the resident t = 0)."""
    n_phase = 8
    x, front, end, hc, ha = make_case(seed=3)
    T, L = x.shape
    foldv = np.asarray(pdd.fold_phase_vector(0.4, 1.0 / 173.3))
    hop, n1, n2 = pres.resident_geometry(N_WINDOW, PS, PE)
    stor = pdd.permute_to_storage_order(
        chirp_at(N_WINDOW, hc, ha).astype(np.complex64), n1, n2)
    prof_r, cnt_r = pres.dedisperse_fold_resident(
        *planes(x, front, end, stor), foldv, np.ones(1, np.float32),
        n_window=N_WINDOW, n_phase=n_phase, pad_start=PS, pad_end=PE,
        stokes=stokes)
    big = 8192
    PSB = PEB = (big - T) // 2
    bn1, bn2 = pdd.split_n(big)
    stor_big = pdd.permute_to_storage_order(
        chirp_at(big, hc, ha).astype(np.complex64), bn1, bn2)
    frb = np.zeros((PSB, L), np.complex64)
    frb[-PS:] = front
    erb = np.zeros((PEB, L), np.complex64)
    erb[:PE] = end
    i0 = np.int64(foldv[0]) - np.int64(PSB - PS) * np.int64(foldv[1])
    foldv_big = np.array([i0 & pdd._FX_MASK, foldv[1], 0], np.int64)
    prof_s, cnt_s = pdd.dedisperse_fold_split(
        *planes(x, frb, erb, stor_big), foldv_big.astype(np.int32),
        np.ones(1, np.float32), n_phase=n_phase, pad_start=PSB, n_valid=T,
        stokes=stokes)
    assert torch.equal(cnt_r[:n_phase], cnt_s[:n_phase])
    ref = prof_s[:n_phase].double()
    got = prof_r[:n_phase].double()
    assert float((got - ref).abs().max()) <= 5e-4 * float(ref.abs().max())


def _raises(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("args", [(3000, 256, 256), (2048, 300, 256),
                                  (2048, 256, 0), (512, 256, 256)])
def test_geometry_errors_match_jax(args):
    assert _raises(lambda: pres.resident_geometry(*args)) == _raises(
        lambda: jres.resident_geometry(*args))
    assert pres.resident_geometry(4096, 256, 256) == \
        jres.resident_geometry(4096, 256, 256) == (3584, 64, 64)


def _call(mod, T=1536, L=8, ps=PS, pe=PE, front=None, chirp=None,
          engine="stockham", n_phase=8):
    z = np.zeros
    hop, n1, n2 = pres.resident_geometry(N_WINDOW, ps, pe)
    chirp = chirp or (n2, n1, L)
    front = front or (ps, L)
    return mod.dedisperse_fold_resident(
        z((T, L), np.float32), z((T, L), np.float32),
        z(front, np.float32), z(front, np.float32), z((pe, L), np.float32),
        z((pe, L), np.float32), z(chirp, np.float32), z(chirp, np.float32),
        np.zeros(3, np.int32), np.ones(1, np.float32), n_window=N_WINDOW,
        n_phase=n_phase, pad_start=ps, pad_end=pe, engine=engine)


BAD = {"engine": dict(engine="vpu"), "block": dict(T=1000),
       "halo": dict(front=(128, 8)), "chirp": dict(chirp=(32, 64, 8)),
       "n_phase": dict(n_phase=1 << 16)}


@pytest.mark.parametrize("case", sorted(BAD))
def test_call_errors_match_jax(case):
    want = _raises(lambda: _call(jres, **BAD[case]))
    got = _raises(lambda: _call(pres, **BAD[case]))
    assert got.split()[0] == want.split()[0]
    if case != "n_phase":      # the port words its limit as the kernel's
        assert got == want


class _Stop(Exception):
    """Raised by a spy once it has seen where the data would go."""


def test_numpy_input_goes_to_the_card(monkeypatch):
    """dedisperse_fold_resident given numpy runs on the card when there is
    one (a spy stops the call where the inputs are moved)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(a, device, dtype):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(pres, "_as_device", spy)
    with pytest.raises(_Stop):
        _call(pres)
    assert seen == [torch.device("cuda")]
