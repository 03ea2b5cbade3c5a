"""Host modules of the PyTorch port against the JAX package, bit for bit.

Time, polyco phases, the fold table, the fixed-point phase encoders and
bin map, plane packing and edge decode, the FFT split and the chirp
storage planes are integer or float64 host bookkeeping: the port must
reproduce them exactly (assert_array_equal, no tolerance).
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from baseband_tasks_tpu import phases as jphases  # noqa: E402
from baseband_tasks_tpu import utils as jutils  # noqa: E402
from baseband_tasks_tpu.dm import DispersionMeasure as JDM  # noqa: E402
from baseband_tasks_tpu.models.foldmodel import FoldModel as JFoldModel  # noqa: E402,E501
from baseband_tasks_tpu.ops import dedisperse_pallas as jdp  # noqa: E402
from baseband_tasks_tpu.ops import unpack_device as jun  # noqa: E402

from baseband_tasks_tpu_torch import phases, utils  # noqa: E402
from baseband_tasks_tpu_torch.dm import DispersionMeasure  # noqa: E402
from baseband_tasks_tpu_torch.models.foldmodel import FoldModel  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import unpack  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def polyco_text(f0=641.928123):
    """bench.py's synthetic B1937+21-like polyco."""
    return ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")


def test_import_leaves_jax_out():
    code = ("import sys, baseband_tasks_tpu_torch as b; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'baseband_tasks_tpu' "
            "for m in sys.modules), 'JAX package imported'; "
            "print(sorted(b.__all__))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "WidebandPulsarPipeline" in out.stdout


def test_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package, at any level of any function."""
    root = pathlib.Path(REPO)
    files = sorted((root / "baseband_tasks_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "baseband_tasks_tpu"), \
                    f"{path.relative_to(root)} imports {name}"


def test_time_arithmetic():
    rng = np.random.default_rng(0)
    mjd = 58000 + rng.uniform(0, 1, 16)
    sec = rng.uniform(-1e5, 1e5, 16)
    got = []
    for mod in (jutils, utils):
        t = mod.Time.from_mjd(mjd)
        t2 = t + mod.TimeDelta.from_sec(sec, sec * 1e-17)
        d = t2 - t
        got.append([t2.jd1, t2.jd2, *d.sec_pair, t2.tai.jd1, t2.tai.jd2,
                    *mod.two_sum(mjd, sec)])
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("deriv", [0, 1])
def test_polyco_phase(deriv):
    times = 58000.0 + np.linspace(-0.4, 0.4, 33)
    out = []
    for ph, ut in ((jphases, jutils), (phases, utils)):
        pp = ph.PolycoPhase(ph.Polyco(polyco_text()))
        t = ut.Time.from_mjd(times)
        if deriv:
            out.append(np.asarray(pp.apparent_spin_freq(t).value))
        else:
            out.append(np.stack(pp(t).cycle_pair))
    np.testing.assert_array_equal(*out)


def test_fold_model_table():
    T = 253952
    offsets = 12345 + np.arange(6) * T
    tabs = []
    for ph, ut, FM in ((jphases, jutils, JFoldModel),
                       (phases, utils, FoldModel)):
        pp = ph.PolycoPhase(ph.Polyco(polyco_text()))
        fm = FM(pp, ut.Time.from_mjd(58000.0), 250 * ut.units.kHz, 64)
        tabs.append(fm.table(offsets, T))
    halves = tabs[0].astype(np.int64)
    jax_rows = np.stack([(halves[:, 0] << 16) | halves[:, 1],
                         (halves[:, 2] << 16) | halves[:, 3],
                         np.zeros(len(halves), np.int64)], axis=1)
    assert tabs[1].dtype == np.int64 and tabs[1].shape == (6, 3)
    np.testing.assert_array_equal(tabs[1], jax_rows)


def test_fold_phase_vector_and_bins():
    rng = np.random.default_rng(1)
    phase0 = np.concatenate([rng.uniform(-3, 3, 20), [0.0, 0.5, 1 - 1e-12]])
    # rates near 1 cycle/sample put p_fx near 2^31
    rate = np.concatenate([rng.uniform(0, 1, 20), [1 - 1e-8, 1 - 1e-9,
                                                  0.999999]])
    t = np.arange(0, 1 << 20, 997)
    for p0, r in zip(phase0, rate):
        fv = dd.fold_phase_vector(p0, r)
        np.testing.assert_array_equal(fv, jdp.fold_phase_vector(p0, r))
        assert fv.dtype == np.int32
        for n_phase in (1, 7, 64, 1000, 32768):
            np.testing.assert_array_equal(dd.fold_bins_ref(fv, t, n_phase),
                                          jdp.fold_bins_ref(fv, t, n_phase))
    assert dd.fold_phase_vector(0.3, 1 - 1e-8)[1] > (1 << 31) - 64


def _bins_uint32(fold, t, n_phase):
    """The CUDA fold kernel's bin arithmetic, in uint32 as it runs."""
    f = np.asarray(fold).astype(np.uint32)
    n = np.uint32(n_phase)
    with np.errstate(over="ignore"):
        num = (f[0] + t.astype(np.uint32) * f[1]) & np.uint32(0x7FFFFFFF)
    return ((num >> 16) * n + (((num & np.uint32(0xFFFF)) * n) >> 16)) >> 15


@pytest.mark.parametrize("rate", [1 / 97.0, 1 - 1e-8, 0.999999, 0.5])
def test_kernel_bin_arithmetic_matches_reference(rate):
    """The uint32 wraparound form of the CUDA kernel equals the int64
    reference, including p near 2^31 where t*p overflows 32 bits."""
    fv = dd.fold_phase_vector(0.37, rate)
    t = np.arange(1 << 18, dtype=np.int64)
    for n_phase in (8, 64, 32768):
        np.testing.assert_array_equal(_bins_uint32(fv, t, n_phase),
                                      jdp.fold_bins_ref(fv, t, n_phase))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_time_planes_words(bits):
    rng = np.random.default_rng(bits)
    fields = rng.integers(0, 1 << bits, (256, 16), dtype=np.uint8)
    words = unpack.pack_time_planes(fields, bits)
    assert words.dtype == torch.int32 and words.shape == (256 * bits // 32,
                                                         16)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(jun.pack_time_planes(fields, bits)).view(np.uint32))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_decode_planes(bits):
    rng = np.random.default_rng(10 + bits)
    fields = rng.integers(0, 1 << bits, (512, 8), dtype=np.uint8)
    got = unpack.decode_planes(unpack.pack_time_planes(fields, bits), bits)
    if bits == 2:
        want = jun.VDIF_2BIT_LEVELS[fields]
    elif bits == 1:
        want = np.where(fields == 0, -1.0, 1.0).astype(np.float32)
    else:
        want = fields.astype(np.float32) - (127.5 if bits == 8 else 7.5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plane_edges(bits):
    rng = np.random.default_rng(20 + bits)
    fields = rng.integers(0, 1 << bits, (512, 16), dtype=np.uint8)
    words = unpack.pack_time_planes(fields, bits)
    carriers = jnp.asarray(jun.pack_time_planes(fields, bits))
    for ps, pe in ((16, 48), (200, 300), (512, 512)):
        got = unpack.plane_edges(words, ps, pe, bits)
        want = jun.plane_edges_device(carriers, ps, pe, bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split_n_and_storage_order():
    for k in range(2, 27):
        assert dd.split_n(1 << k) == jdp.split_n(1 << k)
    arr = np.random.default_rng(3).standard_normal((1024, 4))
    np.testing.assert_array_equal(dd.permute_to_storage_order(arr, 32, 32),
                                  jdp.permute_to_storage_order(arr, 32, 32))


def test_dispersion_measure():
    f = np.linspace(400.0, 800.0, 17)
    a = JDM(56.7)
    b = DispersionMeasure(56.7)
    np.testing.assert_array_equal(
        a.time_delay(f * jutils.units.MHz, 600 * jutils.units.MHz).value,
        b.time_delay(f * utils.units.MHz, 600 * utils.units.MHz).value)
    np.testing.assert_array_equal(
        a.phase_delay(f * jutils.units.MHz, 600 * jutils.units.MHz).value,
        b.phase_delay(f * utils.units.MHz, 600 * utils.units.MHz).value)
