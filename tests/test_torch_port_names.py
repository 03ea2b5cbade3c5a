"""Public names of ported modules against the JAX package: the top-level
names both packages export (each from the same module, ``Stack`` the
join of ``combining.py`` in both), those of ``models``, ``phases`` and
``parallel`` (``multihost`` among them, with its ``initialize``,
``pod_mesh`` and ``host_local``), the fold model's ``best_rational``
(exact: the same convergents of the same float),
``base.META_ATTRIBUTES`` (the same tuple) and
``WidebandPulsarPipeline.example_inputs`` (the same numbers from the same
seed, laid out as the port's ``step_fn`` takes them, on one shard and on
a (2, 1) mesh of CPU shards)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import baseband_tasks_tpu as jb  # noqa: E402
import baseband_tasks_tpu.base as jbase  # noqa: E402
import baseband_tasks_tpu.combining as jcombining  # noqa: E402
import baseband_tasks_tpu.models as jmodels  # noqa: E402
import baseband_tasks_tpu.parallel as jparallel  # noqa: E402
from baseband_tasks_tpu import utils as jutils  # noqa: E402
import baseband_tasks_tpu.phases as jphases  # noqa: E402
from baseband_tasks_tpu.models.foldmodel import \
    best_rational as jbest_rational  # noqa: E402

import baseband_tasks_tpu_torch as bt  # noqa: E402
import baseband_tasks_tpu_torch.base as pbase  # noqa: E402
from baseband_tasks_tpu_torch import parallel as par  # noqa: E402
import baseband_tasks_tpu_torch.models as pmodels  # noqa: E402
import baseband_tasks_tpu_torch.phases as pphases  # noqa: E402
from baseband_tasks_tpu_torch.models import foldmodel as pfold  # noqa: E402

RATE = 250e3
SHARED = sorted(set(jb.__all__) & set(bt.__all__))
#: names both packages' models, phases and parallel subpackages export
SUBPACKAGES = [(j, p, name) for j, p in ((jmodels, pmodels),
                                         (jphases, pphases),
                                         (jparallel, par))
               for name in sorted(set(j.__all__) & set(p.__all__))]
#: the port's names of the JAX package's Pallas modules, where they differ
RENAMED = {"halo_pallas": "halo_remote"}


def module_name(obj):
    """The last component of the module ``obj`` is (a module) or comes
    from."""
    name = obj.__name__ if isinstance(obj, type(jb)) else obj.__module__
    return name.rsplit(".", 1)[-1]


@pytest.mark.parametrize("name", SHARED)
def test_top_level_names_from_the_same_module(name):
    """A name both packages export at the top level comes from the module
    of the same name in each."""
    j, p = getattr(jb, name), getattr(bt, name)
    if isinstance(j, type) or callable(j):
        assert p.__module__.rsplit(".", 1)[-1] == \
            j.__module__.rsplit(".", 1)[-1]
        assert p.__name__ == j.__name__


@pytest.mark.parametrize("jpkg, ppkg, name", SUBPACKAGES,
                         ids=[f"{j.__name__.rsplit('.', 1)[-1]}.{n}"
                              for j, _, n in SUBPACKAGES])
def test_subpackage_names_from_the_same_module(jpkg, ppkg, name):
    """A name both packages' ``models``, ``phases`` or ``parallel``
    export comes from the module of the same name in each (the search
    models, the PINT providers and ``multihost`` among them)."""
    j, p = getattr(jpkg, name), getattr(ppkg, name)
    want = module_name(j)
    assert module_name(p) == RENAMED.get(want, want)
    assert p.__name__.rsplit(".", 1)[-1] == j.__name__.rsplit(".", 1)[-1]


def test_parallel_names_all_ported():
    """Every name of the JAX package's ``parallel.__all__`` is in the
    port's, and ``multihost`` has the JAX module's three entry points."""
    assert set(jparallel.__all__) <= set(par.__all__)
    assert (jparallel, par, "multihost") in SUBPACKAGES
    for name in ("initialize", "pod_mesh", "host_local"):
        assert name in par.multihost.__all__
        assert callable(getattr(par.multihost, name))
        assert name in jparallel.multihost.__all__


def test_beyond_reference_names_exported():
    """The tasks and search models beyond the reference are exported
    where the JAX package exports them."""
    for name in ("FaradayRotate", "DeFaraday", "ConvertPolarization",
                 "ApplyJones", "SpectralKurtosis", "ExciseSpectralKurtosis",
                 "ProfileTemplate", "fit_phase_shift"):
        assert name in SHARED
    for name in ("DMTrialSearch", "RMSynthesis", "SecondarySpectrum",
                 "secondary_spectrum"):
        assert (jmodels, pmodels, name) in SUBPACKAGES
    for name in ("PintToas", "PintPhase"):
        assert (jphases, pphases, name) in SUBPACKAGES
    assert (jmodels, pmodels, "ShardedPipeline") in SUBPACKAGES


IO_MODULES = ["hdf5", "hdf5.interop", "psrfits", "psrfits.fitsio",
              "psrfits.search"]


@pytest.mark.parametrize("name", IO_MODULES)
def test_io_module_names_match_jax(name):
    """``io.hdf5`` and ``io.psrfits`` (and their submodules) export the
    JAX modules' names, each class or function of the same name."""
    import importlib
    jmod = importlib.import_module(f"baseband_tasks_tpu.io.{name}")
    pmod = importlib.import_module(f"baseband_tasks_tpu_torch.io.{name}")
    assert pmod.__all__ == jmod.__all__
    for attr in jmod.__all__:
        j, p = getattr(jmod, attr), getattr(pmod, attr)
        if callable(j):
            assert p.__name__ == j.__name__
            assert p.__module__.split(".", 1)[1] == \
                j.__module__.split(".", 1)[1]


def test_stack_is_the_join():
    """The top-level ``Stack`` is the join of streams in both packages;
    the deprecated ``PulseStack`` alias stays in ``integration``."""
    assert issubclass(jb.Stack, jcombining.CombineStreamsBase)
    assert issubclass(bt.Stack, bt.combining.CombineStreamsBase)
    assert "Stack" in SHARED and len(SHARED) >= 40
    for pkg in (jb, bt):
        with pytest.warns(DeprecationWarning, match="PulseStack"):
            with pytest.raises(TypeError):
                pkg.integration.Stack()


@pytest.mark.parametrize("x, kw", [
    (3 / 8, {}), (1 / 3, {}), (641.928123 / RATE, {}),
    (np.pi / 1e6, {"max_q": 10000}), (16000 / 3, {}), (np.e, {}),
    (1e-7, {}), (123456.789, {"max_pq": 1 << 24})])
def test_best_rational_matches_jax(x, kw):
    got = pfold.best_rational(x, **kw)
    assert got == jbest_rational(x, **kw)
    assert all(type(v) is int for v in got)


def test_best_rational_bounds_like_jax():
    # tests/test_foldmodel.py's properties, on the port's function
    assert pfold.best_rational(3 / 8) == (3, 8)
    assert pfold.best_rational(1 / 3) == (1, 3)
    x = 641.928123 / RATE
    p, q = pfold.best_rational(x)
    assert p * q < 1 << 31
    assert abs(x - p / q) < 1.0 / q ** 2
    assert abs(x - p / q) * (1 << 18) < 1e-5
    assert pfold.best_rational(np.pi / 1e6, max_q=10000)[1] <= 10000
    assert "best_rational" in pfold.__all__


@pytest.mark.parametrize("bad", [0.0, -1.0, float("inf"), float("nan")])
def test_best_rational_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jbest_rational(bad)
    with pytest.raises(ValueError):
        pfold.best_rational(bad)


def test_meta_attributes_match_jax():
    assert pbase.META_ATTRIBUTES == jbase.META_ATTRIBUTES
    assert type(pbase.META_ATTRIBUTES) is tuple


def _config(units):
    return dict(n_chan=8, n_pol=2, dm=0.5, freq_center=600 * units.MHz,
                chan_rate=250 * units.kHz, period_samples=(512, 1),
                n_phase=8, block_samples=1024)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
@pytest.mark.parametrize("seed", [0, 7])
def test_example_inputs_match_jax(shape, seed):
    jmesh = JMesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("time", "chan"))
    jp = jmodels.WidebandPulsarPipeline(mesh=jmesh, **_config(jutils.units))
    mesh = par.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    pp = bt.WidebandPulsarPipeline(mesh=mesh, **_config(bt.units))
    jx, joff = jp.example_inputs(seed)
    xf, off = pp.example_inputs(seed)
    assert torch.is_tensor(xf) and xf.device == pp.device
    assert xf.dtype == torch.float32
    assert tuple(xf.shape) == (pp.global_block, 8, 2, 2) == jx.shape
    np.testing.assert_array_equal(xf.numpy(), np.asarray(jx))
    assert off.dtype == torch.float32 and off.device == pp.device
    assert float(off) == float(joff) == 0.0
    # the step takes them as they come: a profile of the step's shape
    prof, cnt = pp.step_fn()(xf, off)
    assert tuple(prof.shape) == (8, 8, 2)
    assert torch.isfinite(prof).all()
    assert float(cnt.sum()) > 0
