"""The correlator's X stage fused with its dump sums (``ops/xcorr.py``)
on the CPU: the op's plain version against the unfused path it replaces
(``CrossMultiply.task`` then the absorbed ``Integrate``'s update), the
compiled executor's fused branch against its products branch and the
JAX package's ``CrossMultiply`` + ``Integrate``, and the executor's
choice of branch (``CompiledPipeline.x_form``, read only).  The kernel
itself runs only on a card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baseband_tasks_tpu as jb  # noqa: E402
import baseband_tasks_tpu.models as jmodels  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.models import (  # noqa: E402
    CrossMultiply, compiled, fx_correlate)
from baseband_tasks_tpu_torch.models.compiled import (  # noqa: E402
    CompiledPipeline, make_reduction_update)
from baseband_tasks_tpu_torch.ops.xcorr import (  # noqa: E402
    xcorr_accumulate, xcorr_accumulate_ref)
from benchmark import harness  # noqa: E402

pu = pb.units
START = "2018-01-01T00:00:00.000000000"
CUDA = torch.device("cuda")
SYSTEM = harness.module("systems", "lofar_hba_cobalt")

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def source(pkg, units, time, data, spf=16):
    return pkg.StreamGenerator(
        lambda sh: data[sh.tell():sh.tell() + sh.samples_per_frame],
        data.shape, time(START), 1 * units.MHz, samples_per_frame=spf,
        dtype=np.complex64)


def port_source(data, spf=16):
    return source(pb, pu, pb.Time, data, spf)


# segment ids of a 12-spectrum block over 3 dumps (trash segment 3)
IDS = {
    "trash_ends": [3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3],
    "boundary_inside": [3, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1],
    "dumps_and_trash": [0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3],
    "all_trash": [3] * 12,
    "one_spectrum_runs": [0, 1, 2, 3, 0, 1, 2, 3, 2, 1, 0, 3],
}


def unfused(x, seg, n_seg, full):
    """The path the fused op replaces: CrossMultiply's products, then the
    reduction's update, into fresh (n_seg + 1)-row sums."""
    cm = CrossMultiply(port_source(x.numpy()),
                       products="full" if full else "elementwise")
    red = pb.Integrate(cm, 4, average=False)
    y = cm.task(x)
    sums = torch.zeros((n_seg + 1,) + tuple(y.shape[1:]), dtype=y.dtype)
    counts = torch.zeros((n_seg + 1,), dtype=torch.int64)
    make_reduction_update(red)(sums, counts, y, seg)
    return sums


@pytest.mark.parametrize("ids", sorted(IDS))
@pytest.mark.parametrize("n_station", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("cells, full", [((3,), True), ((5, 3), True),
                                         ((1,), True), ((3, 2), False),
                                         ((7,), False)])
def test_plain_matches_the_unfused_path(ids, n_station, cells, full):
    """Every baseline i <= j of 1 to 5 stations, odd cell counts, the four
    products or the elementwise ones: the dump rows as the products and
    their ``index_add_`` give them, the trash row untouched."""
    seg = torch.tensor(IDS[ids])
    shape = (len(seg), n_station) + cells + ((2,) if full else ())
    x = torch.from_numpy(noise(shape, n_station + len(cells)))
    want = unfused(x, seg, 3, full)
    sums = torch.zeros_like(want)
    sums[-1] = 7.0
    assert xcorr_accumulate(x, seg, sums, full=full) is sums
    peak = float(want[:-1].abs().max()) or 1.0
    np.testing.assert_allclose(sums[:-1].numpy(), want[:-1].numpy(),
                               rtol=0, atol=1e-6 * peak)
    assert bool((sums[-1] == 7.0).all())


def test_plain_adds_into_what_is_there():
    """The sums are added to, not replaced: two halves of a block give
    the whole block."""
    x = torch.from_numpy(noise((12, 3, 5, 2), 1))
    seg = torch.tensor(IDS["boundary_inside"])
    whole = xcorr_accumulate_ref(x, seg, torch.zeros((4, 6, 5, 4),
                                                     dtype=torch.complex64),
                                 full=True)
    halves = torch.zeros_like(whole)
    for part in (slice(0, 5), slice(5, 12)):
        xcorr_accumulate_ref(x[part], seg[part], halves, full=True)
    np.testing.assert_allclose(halves.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6 * float(whole.abs().max()))


def test_refusals():
    x = torch.from_numpy(noise((4, 3, 5, 2), 2))
    seg = torch.zeros(4, dtype=torch.int64)
    ok = torch.zeros((2, 6, 5, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="do not take"):
        xcorr_accumulate(x, seg, ok[:, :5], full=True)
    with pytest.raises(ValueError, match="do not take"):
        xcorr_accumulate(x, seg, ok, full=False)
    with pytest.raises(ValueError, match="polarization axis of 2"):
        xcorr_accumulate(x[..., :1], seg, ok, full=True)
    with pytest.raises(ValueError, match="no station axis"):
        xcorr_accumulate(x[:, 0, 0], seg, ok, full=True)


# -- the executor --------------------------------------------------------

def small_cfg(n_station=4):
    """The LOFAR node at ``n_station`` stations, 2 subbands, 8 channels,
    dumps of 64 spectra in blocks of 16, delays of up to 16 samples."""
    cfg = harness.config_of(harness.load_spec(), "lofar_hba_cobalt")
    cfg.update(n_station=n_station, n_subband=2, n_chan=8, n_avg=64,
               block_samples=128, max_delay_samples=16)
    return cfg


def feed(cfg, seed):
    traffic = dict(harness.traffic_of("dump_1s"), pool=1, steps_per_call=4)
    return SYSTEM.make_feed(cfg, traffic, seed, torch.device("cpu"),
                            harness.Spans())


@pytest.mark.parametrize("n_station", [3, 4, 5])
@pytest.mark.parametrize("products", ["full", "elementwise"])
def test_run_fn_fused_branch_matches_products(n_station, products):
    """The LOFAR node's compiled chain (the lead spectrum and the tail in
    the trash segment, one dump) through ``run_fn``'s fused branch (on
    the CPU the op's plain version) and through its products branch: the
    same counts, the same sums to float32 roundoff."""
    cfg = small_cfg(n_station)
    cfg["products"] = products
    f = feed(cfg, 2 ** 31 + n_station)
    n_blocks = SYSTEM.dump_blocks(cfg)[1]
    blocks = f.blocks[0]
    cp = f.cp
    assert cp.x_form == "products"
    sums, counts = cp.run_fn(n_blocks)(blocks)
    fused = SYSTEM.compiled(cfg, f.d, "cpu")._run_fn(n_blocks, "fused")
    fsums, fcounts = fused(blocks)
    assert fsums.shape == sums.shape and list(fcounts) == list(counts)
    assert list(counts) == [64]
    np.testing.assert_allclose(fsums.numpy(), sums.numpy(), rtol=0,
                               atol=1e-6 * float(sums.abs().max()))
    f.close()


@pytest.mark.parametrize("n_avg, n_blocks", [(16, 6), (24, 5)])
def test_elementwise_matches_jax(n_avg, n_blocks):
    """CrossMultiply then Integrate in the JAX package, read eagerly,
    against the port's compiled fused branch (dumps that end inside a
    block, too)."""
    data = noise((512, 3, 5), 9)
    jtail = jb.Integrate(jmodels.CrossMultiply(
        source(jb, ju, JTime, data)), n_avg, average=False)
    ptail = pb.Integrate(CrossMultiply(port_source(data)), n_avg,
                         average=False)
    cp = CompiledPipeline(ptail, block_samples=16)
    sums, counts = cp._run_fn(n_blocks, "fused")(
        cp.read_source_blocks(n_blocks))
    n = n_blocks * 16 // n_avg
    want = np.asarray(jtail.read(n))
    jcounts = want["count"].reshape(n, -1)
    assert (jcounts == jcounts[:, :1]).all()
    np.testing.assert_array_equal(counts[:n].numpy(), jcounts[:, 0])
    np.testing.assert_allclose(sums[:n].numpy(), want["data"], rtol=0,
                               atol=1e-5 * float(np.abs(want["data"]).max()))


def chain(n_chan=4096, **kw):
    """Three stations of (time, subband, pol), correlated at ``n_chan``
    channels (4096: 6 baselines x 8192 cells, above
    ``MIN_BASELINE_CELLS`` with any 3 of the baselines)."""
    data = noise((32 * n_chan, 2, 2), 5)
    streams = [port_source(np.roll(data, 3 * k, axis=0), spf=4 * n_chan)
               for k in range(3)]
    return fx_correlate(streams, n_chan, 16, samples_per_frame=4 * n_chan,
                        average=False, **kw)


def form(tail, device=CUDA, n_chan=4096):
    cp = CompiledPipeline(tail, block_samples=4 * n_chan)
    return compiled._x_form(cp.stages[-1], cp.reduction, device)


def test_x_form_of_the_cells_graph():
    """The LOFAR node's graph at the deployment's widths takes the fused
    branch on a card, the products branch on the CPU; cut to 4 stations
    and 16 cells it keeps the products on a card too."""
    cfg = harness.config_of(harness.load_spec(), "lofar_hba_cobalt")
    cp = SYSTEM.compiled(cfg, SYSTEM.delays(cfg, 3), "cpu")
    assert cp.x_form == "products"
    assert compiled._x_form(cp.stages[-1], cp.reduction, CUDA) == "fused"
    assert compiled._x_form(cp.stages[-1], cp.reduction,
                            torch.device("cpu")) == "products"
    cp = SYSTEM.compiled(small_cfg(), SYSTEM.delays(small_cfg(), 3), "cpu")
    assert compiled._x_form(cp.stages[-1], cp.reduction, CUDA) == "products"


@pytest.mark.parametrize("products, n_chan, want", [
    ("full", 1024, "products"), ("full", 2048, "fused"),
    ("elementwise", 512, "products"), ("elementwise", 1024, "fused")])
def test_x_form_by_width(products, n_chan, want):
    """Fused from ``MIN_BASELINE_CELLS`` baselines x cells a spectrum (the
    elementwise products' polarization axis among the cells): 6 x 4096
    and 6 x 2048 x 2 are below it, twice those above."""
    assert form(chain(n_chan, products=products), n_chan=n_chan) == want


@pytest.mark.parametrize("case, want", [
    ("full", "fused"), ("elementwise", "fused"),
    ("baselines_subset", "products"), ("baselines_reordered", "products"),
    ("masked", "products"), ("fold", "products"), ("no_reduction", None)])
def test_x_form_by_graph(case, want):
    """Fused only for all baselines i <= j in their packed order into a
    plain, unmasked Integrate."""
    every = [(i, j) for i in range(3) for j in range(i, 3)]
    if case in ("full", "elementwise"):
        tail = chain(products=case)
    elif case == "baselines_subset":
        tail = chain(baselines=[(0, 1), (0, 2), (1, 2)])
    elif case == "baselines_reordered":
        tail = chain(baselines=every[::-1])
    else:
        prods = chain().ih
        if case == "masked":
            tail = pb.Integrate(prods, 16, masked=True, average=False)
        elif case == "fold":
            tail = pb.Fold(prods, 4, lambda t: 0.0 * pu.cycle, 16,
                           average=False)
        else:
            tail = prods
    if want is None:
        cp = CompiledPipeline(tail, block_samples=4 * 4096)
        assert cp.x_form == "products"
        with pytest.raises(AttributeError):
            cp.x_form = "fused"
    else:
        assert form(tail) == want
        assert form(tail, torch.device("cpu")) == "products"
