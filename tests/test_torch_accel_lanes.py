"""The acceleration search's used-lane correlation in the PyTorch port.

``ops/accel_correlate.py`` computes the 'pallas' engine's bank
correlation for the used lanes of a 128-lane chunk only
(``_accel_correlate_lanes``): the lanes past a chunk's templates hold
zero templates, whose power the JAX package computes and drops.  Here,
on the CPU (the plain versions), against the public
``accel_correlate_bank`` and against the JAX package's search (its Pallas
kernel in interpret mode): the entry's lane counts and refusals, the
lane-major bank the kernel reads (built once per bank), the padded row
width of the map on the card, and the 'pallas' search and
``search_sharded`` with chunks that are not full.  Tolerances: the
entry against the public op exact (the same plain arithmetic); maps at
the JAX package's 'pallas' bound, rtol/atol 2e-3 (``tests/
test_accelsearch.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu.models import accelsearch as jacc  # noqa: E402
from baseband_tasks_tpu.ops import dft_matmul as jdm  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

from baseband_tasks_tpu_torch import parallel as par  # noqa: E402
from baseband_tasks_tpu_torch.models import accelsearch as pacc  # noqa: E402
from baseband_tasks_tpu_torch.ops import accel_correlate as pac  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

PALLAS_TOL = 2e-3


def bank(seg_len, n_seg=3, seed=7):
    rng = np.random.default_rng(seed)
    segs = torch.complex(*(torch.as_tensor(rng.standard_normal(
        (n_seg, seg_len)).astype(np.float32)) for _ in range(2)))
    tr, ti = (torch.as_tensor(rng.standard_normal(
        (seg_len, pac.LANES)).astype(np.float32)) for _ in range(2))
    return segs, tr, ti


@pytest.mark.parametrize("n_used", [1, 17, 65, 128])
@pytest.mark.parametrize("seg_len,valid", [(8, 8), (64, 33), (256, 1)])
def test_lanes_entry_is_the_public_op_sliced(seg_len, valid, n_used):
    segs, tr, ti = bank(seg_len)
    got = pac._accel_correlate_lanes(segs, tr, ti, valid=valid,
                                     n_used=n_used)
    want = pac.accel_correlate_bank(segs, tr, ti, valid=valid)[..., :n_used]
    assert got.shape == (3, valid, n_used)
    assert torch.equal(got, want)
    assert torch.equal(
        pac._accel_correlate_lanes_ref(segs, tr, ti, valid=valid,
                                       n_used=n_used), want)


@pytest.mark.parametrize("n_used", [0, -1, pac.LANES + 1])
def test_lanes_entry_refuses_lane_counts(n_used):
    segs, tr, ti = bank(16)
    with pytest.raises(ValueError, match="n_used"):
        pac._accel_correlate_lanes(segs, tr, ti, valid=8, n_used=n_used)


def test_lanes_entry_keeps_the_public_refusals():
    segs, tr, ti = bank(16)
    with pytest.raises(ValueError, match="valid"):
        pac._accel_correlate_lanes(segs, tr, ti, valid=17, n_used=4)
    with pytest.raises(ValueError, match="bank planes"):
        pac._accel_correlate_lanes(segs, tr[:, :64], ti[:, :64], valid=8,
                                   n_used=4)
    with pytest.raises(ValueError, match="power of two"):
        pac._accel_correlate_lanes(segs[:, :12], tr[:12], ti[:12], valid=8,
                                   n_used=4)


@pytest.mark.parametrize("n_used,lanes", [(1, 8), (8, 8), (9, 16),
                                          (65, 72), (128, 128)])
def test_sector_lanes(n_used, lanes):
    """Rows of the stored map are whole 32-byte sectors of float32."""
    assert pac._sector_lanes(n_used) == lanes


def test_lane_major_bank_is_built_once_per_bank():
    _, tr, ti = bank(32)
    lm = pac._lane_major(tr, ti)
    assert lm.dtype == torch.complex64 and lm.shape == (pac.LANES, 32)
    assert lm.is_contiguous()
    assert torch.equal(lm, torch.complex(tr, ti).T)
    assert pac._lane_major(tr, ti) is lm
    tr.mul_(2.0)                    # an in-place change rebuilds it
    again = pac._lane_major(tr, ti)
    assert again is not lm and torch.equal(again.real, tr.T)


def searches(n, **kw):
    return (jacc.FourierDomainAccelSearch(n, 1 * ju.kHz, engine="pallas",
                                          **kw),
            pacc.FourierDomainAccelSearch(n, 1 * pu.kHz, engine="pallas",
                                          device="cpu", **kw))


def tone(n, seed=11):
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * (600 * t + 0.5 * 8.0 * t ** 2))
            + np.random.default_rng(seed).standard_normal(n) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("z_max", [2.0, 12.0])
def test_pallas_search_used_lanes_match_jax(z_max):
    """Chunks of 3 and 13 templates: the map of the used lanes only."""
    n = 1 << 12
    js, ps = searches(n, z_max=z_max, z_step=2.0, seg_len=512)
    (_, n_here), = ps._lane_banks()
    assert n_here == len(ps.zs) < pac.LANES
    x = tone(n)
    with jdm.set_matmul_precision("highest"):
        want = np.asarray(js.search(x))
    got = ps.search(x)
    assert got.shape == want.shape == (n // 2 + 1, n_here)
    np.testing.assert_allclose(got.numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)


def test_pallas_search_sharded_partial_chunks_match_jax():
    """13 templates over 4 shards: chunks of 4 lanes (the last padded
    with zero templates by the sharding), each computed for its own."""
    n = 1 << 12
    js, ps = searches(n, z_max=12.0, z_step=2.0, seg_len=512)
    x = tone(n, seed=12)
    with jdm.set_matmul_precision("highest"):
        want = np.asarray(js.search(x))
    mesh = par.Mesh(["cpu"] * 4, ("z",))
    dd.reset_launch_counts()
    got = ps.search_sharded(x, mesh)
    assert not any(dd.launch_counts.values())
    assert [s._lane_banks()[0][1] for s in ps._sharded_cache[
        next(iter(ps._sharded_cache))]] == [4, 4, 4, 4]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    np.testing.assert_allclose(got.numpy(), ps.search(x).numpy(),
                               rtol=1e-5, atol=1e-5)
