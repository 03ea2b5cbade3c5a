"""The port's multi-process layer on the CPU: two worker processes
(``baseband_tasks_tpu_torch.tools.multihost_check``, which imports no
jax) join over gloo through a ``file://`` rendezvous, with CPU shards,
and run every sharded entry point across the process boundary.

One pair of workers runs for the whole module.  Each case is held bit
for bit against the same call on a one-process mesh of the same shape
(the workers compute both): the (time, chan) flagship's ``step_fn`` at
``tests/test_multihost.py``'s small configuration (through
``host_local``) and at its production shapes, with each process owning
time rows and with the chan axis across the processes; ``run_fn``
packed, float, Stokes and plain, ``step_bins_fn`` and ``planes_step``;
the halo exchange, ``sharded_overlap_save``, the corner turn, the
channelizers and ``unshard``; ``ShardedPipeline`` with and without an
absorbed Integrate and on a two-source graph; the four sharded
searches; ``halo='remote'`` on time rings that cross the processes
(``halo_edges_remote`` / ``halo_exchange_remote`` with ``owners``,
non-periodic and periodic, on (4, 1) and (2, 2) meshes, with the chan
axis across the processes and beside a ring held whole, and the
pipeline's steps and float ``run_fn``), held against one process and
against ``'ppermute'`` too (on CPU shards the remote halo takes its
plain version, the copies of ``'ppermute'``; on the card its push form
writes through CUDA IPC, ``tests/test_torch_cuda.py``).  The small step,
with either halo, is also held to the JAX package's single-process step
on four virtual devices, counts exact and profiles within rtol 1e-5
(``tests/test_multihost.py``'s bar).  The refusals (``halo='remote'``
on a ring across two hosts, ``compile(mesh=)``, NCCL where it cannot
serve) are checked too.

A worker that fails or times out fails the tests with its output; only a
process group that cannot initialize here (``INIT_FAIL``) skips.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P  # noqa: E402,E501

import baseband_tasks_tpu_torch.parallel as par  # noqa: E402
from baseband_tasks_tpu_torch.parallel import multihost  # noqa: E402
from baseband_tasks_tpu_torch.tools import multihost_check as mc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

#: halo='remote' across processes (the workers' remote_cases), on the
#: meshes of both worker sets
REMOTE = [f"remote_{p}_{m}" for m in ("line", "grid", "chan")
          for p in ("open", "periodic")]
#: halo='remote' on rings across the two processes: the pipeline's steps
#: and float run_fn, the primitive, and one ring held whole beside one
#: across them
REMOTE_TWO = ["remote_across", "remote_step_kernels", "remote_run_float",
              "halo_remote_across", "remote_open_mixed",
              "remote_periodic_mixed"]
#: cases the workers hold bit for bit against one process
ONE_PROCESS = [
    "small", "small_chan", "production", "run_packed", "run_float",
    "run_stokes", "run_plain", "step_bins", "planes_step",
    "halo_open_front", "halo_open_end", "halo_open_window",
    "halo_periodic_front", "halo_periodic_end", "halo_periodic_window",
    "unshard", "overlap_save", "corner_turn", "channelize", "dechannelize",
    "sharded", "sharded_integrate", "sharded_fold", "sharded_joined",
    "search_accel", "search_ffa", "search_dm", "search_rm"] \
    + REMOTE_TWO + REMOTE
#: cases the three workers hold bit for bit against one process
THREE_PROCESSES = [
    "halo_open_front", "halo_open_end", "halo_open_window",
    "halo_periodic_front", "halo_periodic_end", "halo_periodic_window",
    "unshard", "overlap_save", "corner_turn", "channelize", "dechannelize",
    "sharded", "sharded_integrate", "sharded_fold"] + REMOTE
#: calls that must raise, and do with the message the worker looks for
REFUSALS = ["remote_hosts", "compile_mesh"]


def _run_workers(tmp, world, mode, devices):
    """Start ``world`` workers running the check set ``mode`` over gloo
    and wait for them; rank 0's arrays."""
    rdv = "file://" + str(tmp / "rendezvous")
    out = str(tmp / "out.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "RANK", "WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "baseband_tasks_tpu_torch.tools."
         "multihost_check", str(r), str(world), rdv, out, mode, devices],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        got = [p.communicate()[0] for p in procs]
        pytest.fail(f"workers timed out after {TIMEOUT} s:\n"
                    + "\n".join(got))
    codes = [p.returncode for p in procs]
    for code, text in zip(codes, outs):
        if code == 2 and "INIT_FAIL" in text:
            pytest.skip("no process group here: "
                        + text.strip().splitlines()[-1])
    for code, text in zip(codes, outs):
        assert code == 0 and "MULTIHOST_OK" in text, \
            f"worker exited {code}:\n{text}"
    return dict(np.load(mc.rank_file(out, 0)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Run the pair of workers once; rank 0's arrays."""
    return _run_workers(tmp_path_factory.mktemp("multihost"), 2, "cpu",
                        "cpu,cpu")


@pytest.fixture(scope="module")
def results3(tmp_path_factory):
    """Run three workers, two CPU shards each, once; rank 0's arrays."""
    return _run_workers(tmp_path_factory.mktemp("multihost3"), 3, "cpu3",
                        "cpu,cpu")


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_two_processes_equal_one(results, case):
    multi, one = results[f"{case}/multi"], results[f"{case}/one"]
    assert multi.shape == one.shape and multi.dtype == one.dtype
    assert np.array_equal(multi, one)


@pytest.mark.parametrize("case", THREE_PROCESSES)
def test_three_processes_equal_one(results3, case):
    """Over three processes each exchange has a process that is neither
    of its ends; it takes part and the results are one process's."""
    multi, one = results3[f"{case}/multi"], results3[f"{case}/one"]
    assert multi.shape == one.shape and multi.dtype == one.dtype
    assert np.array_equal(multi, one)


@pytest.mark.parametrize("case", REMOTE_TWO + REMOTE)
def test_remote_equals_ppermute(results, case):
    """``halo='remote'`` across the two processes gives what
    ``'ppermute'`` gives, bit for bit."""
    multi, pp = results[f"{case}/multi"], results[f"{case}/ppermute"]
    assert multi.shape == pp.shape and np.array_equal(multi, pp)


@pytest.mark.parametrize("case", REMOTE)
def test_three_processes_remote_equals_ppermute(results3, case):
    multi, pp = results3[f"{case}/multi"], results3[f"{case}/ppermute"]
    assert multi.shape == pp.shape and np.array_equal(multi, pp)


@pytest.mark.parametrize("case", REFUSALS)
def test_refused_across_processes(results, case):
    assert results[f"{case}/raised"] == 1


def test_three_processes_refuse_across_hosts(results3):
    assert results3["remote_hosts/raised"] == 1


def test_remote_on_rings_held_whole(results):
    """With the chan axis across the processes each time ring is one
    process's: ``halo='remote'`` serves it, equal to 'ppermute'."""
    assert np.array_equal(results["remote_chan/multi"],
                          results["small_chan/multi"])


def _split(results, case):
    shape = tuple(results[f"{case}/shape"])
    flat = results[f"{case}/multi"]
    n = int(np.prod(shape))
    return flat[:n].reshape(shape), flat[n:]


def _jax_single_process_step(n_time, cfg):
    """``tests/test_multihost.py``'s ``_single_process_reference``: the
    same sharded configuration on a one-process JAX mesh of this session's
    virtual CPU devices."""
    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.utils import units as u
    mesh = JMesh(np.asarray(jax.devices()[:n_time * 2]).reshape(n_time, 2),
                 ("time", "chan"))
    pipe = WidebandPulsarPipeline(freq_center=600 * u.MHz,
                                  chan_rate=250 * u.kHz, mesh=mesh, **cfg)
    T = pipe.global_block
    # the numbers of rng(0).standard_normal((T, ...)), drawn in chunks
    xf = jax.device_put(mc.normal_pairs(T, cfg),
                        NamedSharding(mesh, P("time", "chan")))
    prof, cnt = pipe.step_fn()(xf, np.float32(17))
    return np.asarray(prof), np.asarray(cnt), T


@pytest.mark.parametrize("case, n_time, cfg", [
    ("small", 2, mc.SMALL), ("small_chan", 2, mc.SMALL),
    ("remote_across", 2, mc.SMALL), ("production", 4, mc.PRODUCTION)])
def test_step_matches_jax(results, case, n_time, cfg):
    """The two-process step against the JAX package's single-process
    step on ``2 * n_time`` virtual devices: the small (2, 2) mesh with
    each process handing over its own rows (``host_local``), with
    ``'ppermute'`` and with ``halo='remote'`` across the processes, or
    owning a chan column, and the production shapes on (4, 2); counts exact,
    profiles rtol 1e-5 (atol 1e-5 of the peak)."""
    prof_ref, cnt_ref, T = _jax_single_process_step(n_time, cfg)
    prof, cnt = _split(results, case)
    assert int(results[f"{case}/samples"]) == T
    assert np.array_equal(cnt, cnt_ref) and cnt.sum() == T
    np.testing.assert_allclose(prof, prof_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(prof_ref).max())


def test_production_counts(results):
    """The production-shape step (n_chan 128, n_phase 64, four time
    shards of at least 2^16 samples) folds every sample of its block
    once."""
    prof, cnt = _split(results, "production")
    T = int(results["production/samples"])
    assert prof.shape == (64, 128, 2) and np.isfinite(prof).all()
    assert T >= 4 * (1 << 16) and cnt.sum() == T


def test_workers_moved_data(results):
    """The transport counted its calls and bytes; a second
    ``initialize`` was a no-op."""
    calls, nbytes = results["transfers/multi"]
    assert calls > 0 and nbytes > 0
    assert results["initialize_twice/multi"] == 2


# -- one process, no workers ----------------------------------------------

def test_initialize_without_a_group_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    multihost.initialize("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1


def test_nccl_refused_where_unavailable(tmp_path):
    """``backend='nccl'`` where this torch has no NCCL raises before any
    rendezvous; it is never swapped for gloo."""
    if torch.distributed.is_nccl_available():
        pytest.skip("this torch has NCCL")
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize(f"file://{tmp_path}/rdv", 2, 0,
                             backend="nccl")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_two_ranks_on_one_card_refused(tmp_path, monkeypatch, backend):
    """Two local ranks and one card: NCCL refuses duplicate GPUs, so
    ``initialize`` raises, whether NCCL was asked for or would have been
    chosen, and names gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: True)
    with pytest.raises(RuntimeError, match="share a card.*gloo"):
        multihost.initialize(f"file://{tmp_path}/rdv", 2, 0,
                             backend=backend)
    assert not torch.distributed.is_initialized()


@pytest.fixture
def four_cards(monkeypatch):
    """A host of four cards with NCCL, as ``initialize`` sees it; the
    group's start and the card chosen are recorded, not done."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return calls


@pytest.mark.parametrize("env, kw", [
    ({}, {}),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, {}),
    ({}, {"local_rank": 1, "local_processes": 4})])
def test_nccl_over_two_hosts(four_cards, monkeypatch, env, kw):
    """Eight ranks over two hosts of four cards, rendezvous on another
    host: rank 5 is the second process of its host, so it takes NCCL on
    ``cuda:1`` (from torchrun's variables, the keywords, or one process
    per card in rank order when neither is given)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    multihost.initialize("10.0.0.1:29500", 8, 5, **kw)
    assert four_cards == {"card": 1, "backend": "nccl",
                          "init_method": "tcp://10.0.0.1:29500",
                          "world_size": 8, "rank": 5}


def test_nccl_refused_with_more_local_ranks_than_cards(four_cards):
    """Eight processes stated to share a host of four cards: refused."""
    with pytest.raises(RuntimeError, match="share a card"):
        multihost.initialize("10.0.0.1:29500", 8, 5, backend="nccl",
                             local_processes=8)
    with pytest.raises(RuntimeError, match="share a card"):
        multihost.initialize("localhost:29500", 8, 5)
    assert four_cards == {}


def test_one_process_mesh_and_host_local():
    """Without a process group ``pod_mesh`` is ``make_mesh`` over the
    local devices (every cell local) and ``host_local`` is ``shard``."""
    mesh = multihost.pod_mesh(2, 2, local_devices=["cpu"] * 4)
    ref = par.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == ref.shape and not mesh.spans_processes
    assert mesh.local_cells() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not mesh.process_ids.any()
    x = torch.arange(8 * 4 * 3, dtype=torch.float32).reshape(8, 4, 3)
    got = multihost.host_local(x, mesh, ("time", "chan"))
    want = par.shard(x, ref, ("time", "chan"))
    assert all(torch.equal(a, b) for a, b in zip(got.flat, want.flat))


def test_mesh_process_ids_in_one_process():
    """A mesh whose cells name two ranks, seen from rank 0 without a
    group: its own cells are local, the others' blocks are None, and
    ``halo='remote'`` on a ring across the ranks does what ``'ppermute'``
    does (on CPU shards it is the same copies): the pipeline builds, and
    a step needs the process group."""
    mesh = par.Mesh([["cpu"] * 2] * 2, ("time", "chan"),
                    process_ids=[[0, 0], [1, 1]])
    assert mesh.spans_processes and mesh.is_local((0, 1))
    assert not mesh.is_local((1, 0))
    assert mesh.local_cells() == [(0, 0), (0, 1)]
    assert np.array_equal(mesh.process_ids, [[0, 0], [1, 1]])
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    grid = par.shard(x, mesh, ("time", "chan"))
    assert grid[1, 0] is None and grid[1, 1] is None
    assert torch.equal(grid[0, 1], x[:4, 2:])
    from baseband_tasks_tpu_torch import WidebandPulsarPipeline, units as u
    pipes = {h: WidebandPulsarPipeline(freq_center=600 * u.MHz,
                                       chan_rate=250 * u.kHz, mesh=mesh,
                                       halo=h, **mc.SMALL)
             for h in ("ppermute", "remote")}
    xf = mc.normal_pairs(pipes["remote"].global_block, mc.SMALL)
    errors = {}
    for h, pipe in pipes.items():
        with pytest.raises(Exception) as info:
            pipe.step_fn()(xf, np.float32(17))
        errors[h] = (type(info.value), str(info.value))
    assert errors["remote"] == errors["ppermute"]
    local = par.make_mesh(2, 2, devices=["cpu"] * 4)
    assert not local.spans_processes and not local.process_ids.any()
    assert all(local.is_local(c) for c in local.local_cells())


# -- the push form's bookkeeping and the host check -----------------------

def test_ring_across_two_hosts_refused():
    """A time ring whose neighbours are on two hosts (the check given the
    two host names) raises naming 'ppermute', from the check itself and
    from the pipeline's constructor on a mesh that records the hosts; a
    ring on one host, or with its hosts unknown, passes."""
    from baseband_tasks_tpu_torch import WidebandPulsarPipeline, units as u
    from baseband_tasks_tpu_torch.parallel import halo_remote as hr
    ids = np.asarray([[0], [0], [1], [1]])
    two = np.asarray([["node-a"], ["node-a"], ["node-b"], ["node-b"]],
                     dtype=object)
    with pytest.raises(ValueError, match="halo='ppermute'"):
        hr.check_hosts(ids, two)
    hr.check_hosts(ids, np.full((4, 1), "node-a", dtype=object))
    hr.check_hosts(ids, None)
    mesh = par.Mesh([["cpu"]] * 4, ("time", "chan"), process_ids=ids,
                    hosts=two)
    with pytest.raises(ValueError, match="halo='ppermute'"):
        WidebandPulsarPipeline(freq_center=600 * u.MHz,
                               chan_rate=250 * u.kHz, mesh=mesh,
                               halo="remote", **mc.SMALL)
    WidebandPulsarPipeline(freq_center=600 * u.MHz, chan_rate=250 * u.kHz,
                           mesh=mesh, **mc.SMALL)      # 'ppermute' serves
    from baseband_tasks_tpu_torch.parallel import _ipc
    with pytest.raises(RuntimeError, match="halo='ppermute'"):
        _ipc.check_reach([(0, 1)], ["node-a", "node-a"], [True, False])


def test_pod_mesh_records_hosts():
    import socket
    mesh = multihost.pod_mesh(2, 1, local_devices=["cpu"] * 2)
    assert mesh.hosts.shape == (2, 1)
    assert set(mesh.hosts.flat) == {socket.gethostname()}


@pytest.mark.parametrize("ids, periodic, launches", [
    ([[0], [0], [1], [1]], False, {0: 2, 1: 2}),
    ([[0], [0], [1], [1]], True, {0: 2, 1: 2}),
    ([[0, 0], [1, 1]], False, {0: 2, 1: 2}),
    ([[0], [1], [2]], True, {0: 2, 1: 2, 2: 2}),
    ([[0, 0], [0, 1], [0, 1]], False, {0: 2, 1: 2}),
    ([[0], [1]], True, {0: 2, 1: 2})])
def test_push_plan(ids, periodic, launches):
    """The push form's plan on every process: each shard's front and end
    come from one move each (a push from its local source, a copy out of
    its mailbox, or zeros), each crossing edge has its own slot, slots of
    one receiver do not overlap, and each process makes two launches a
    call (the push, then the copy out)."""
    from baseband_tasks_tpu_torch.parallel import _ipc
    ranks = np.asarray(ids)
    for me in launches:
        plan = _ipc.Plan(ranks, 5, 3, periodic, 48, me=me)
        assert bool(plan.push_edges()) + bool(plan.copy_out_edges()) \
            == launches[me]
        got = {}
        for e in plan.push_edges():
            if plan.dst(e) == me:
                got[(e[0], e[1], e[2])] = "zeros" if e[3] is None else "push"
        for e in plan.copy_out_edges():
            got[(e[0], e[1], e[2])] = "mailbox"
        want = {(side, t, r) for (t, r), rank in np.ndenumerate(ranks)
                if rank == me for side in (0, 1)}
        assert set(got) == want
        for e in plan.push_edges():
            assert e[3] is None or plan.src(e) == me
        for d, size in plan.parity_bytes.items():
            spans = sorted((plan.offset[e], plan.offset[e]
                            + plan.nbytes[e[0]]) for e in plan.transfers
                           if plan.dst(e) == d)
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
            assert spans[-1][1] <= size and size % 256 == 0
        assert set(plan.send_to) == {plan.dst(e) for e in plan.transfers
                                     if plan.src(e) == me}
    # transfers cross processes only, the same list on every process
    plans = [_ipc.Plan(ranks, 5, 3, periodic, 48, me=m) for m in launches]
    assert all(p.transfers == plans[0].transfers for p in plans)
    assert all(plans[0].src(e) != plans[0].dst(e)
               for e in plans[0].transfers)


def test_push_plan_rings_held_whole_need_no_transfer():
    from baseband_tasks_tpu_torch.parallel import _ipc
    from baseband_tasks_tpu_torch.parallel import halo_remote as hr
    ids = np.asarray([[0, 1], [0, 1]])
    assert _ipc.Plan(ids, 4, 4, True, 8, me=0).transfers == []
    assert hr.crossing_rings(ids) == [] and hr.local_rings(ids) == [0]
    assert hr.crossing_rings([[0, 0], [0, 1]]) == [1]
