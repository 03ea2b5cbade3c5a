"""A GUPPI full-Stokes timing node: ``WidebandPulsarPipeline(
use_kernels=True, detect='stokes', ingest_layout='guppi')`` of the port,
its ``run_fn`` entry on one device, fed GUPPI raw blocks.

Feed (the traffic's ``feed``): ``card_pool``, a pool of ``pool`` seeded
GUPPI blocks, each (n_chan, T) int32 words of random signed 8-bit (X re,
X im, Y re, Y im), made on the device in set-up; T is a step's valid
samples, so a block is one step (GUPPI's OVERLAP 0, NTIME = T).

On the card, set-up first loads the port's kernel libraries, building
them on a checkout's first run; ``build_s`` is that time (part of the
set-up).

Units, keys and the reference's data are the flagship's feed's
(``flagship_fold.py``): unit ``i`` makes ``calls_per_unit`` calls, call
``c`` running ``run_fn(steps_per_call, offset0=c * steps_per_call * T)``
on pool block ``(i + c) % pool``; the calls' profiles and counts are
summed on the device and fetched to the host.

The work of a unit (:meth:`Feed.work_per_unit`) is the bytes and
operations of the configuration's Stokes work (:func:`work_per_step`),
which ``kernels_roofline`` reads, as two :class:`Work` numbers that also
carry by kernel name those of ``guppi_repack`` (:func:`repack_work`) and
of K3 Stokes (:func:`k3_stokes_work`), which ``guppi.repack_roofline``
and ``k3_stokes.roofline`` read.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark.systems import flagship_fold as flagship

FEEDS = ("card_pool",)


def pipeline(cfg, device):
    """The port's pipeline for ``cfg``; its window must be the one the
    configuration states."""
    from baseband_tasks_tpu_torch import (Polyco, PolycoPhase, Time,
                                          WidebandPulsarPipeline, units)
    phase = PolycoPhase(Polyco("".join(f"{line}\n" for line in
                                       cfg["polyco"])))
    pipe = WidebandPulsarPipeline(
        n_chan=cfg["n_chan"], n_pol=cfg["n_pol"], dm=cfg["dm"],
        freq_center=cfg["freq_center_mhz"] * units.MHz,
        chan_rate=cfg["chan_rate_khz"] * units.kHz,
        period_samples=tuple(cfg["period_samples"]), n_phase=cfg["n_phase"],
        block_samples=cfg["block_samples"], device=device, use_kernels=True,
        phase_model=phase, start_time=Time.from_mjd(float(cfg["start_mjd"])),
        ingest_bits=cfg["ingest_bits"], detect=cfg["detect"],
        ingest_layout=cfg["ingest_layout"])
    got = {"n_fft": pipe.pad_start + pipe.block_samples + pipe.pad_end,
           "pad_start": pipe.pad_start, "pad_end": pipe.pad_end,
           "valid_samples": pipe.block_samples}
    if got != cfg["window"]:
        raise ValueError(f"the pipeline's window {got} is not the "
                         f"configuration's {cfg['window']}")
    return pipe


def work_per_step(cfg):
    """(bytes, operations) of one step, from the configuration's shapes:
    the GUPPI words read once (4 bytes a channel and sample) and the
    (n_phase + 1) x n_chan x 4 float32 profile written once; a forward
    and an inverse FFT of each lane's window (5 N log2 N each), the
    response multiply (6 N) and the four Stokes products of each channel
    (3 operations each: 12 T)."""
    w = cfg["window"]
    n, t = w["n_fft"], w["valid_samples"]
    lanes = cfg["n_chan"] * cfg["n_pol"]
    nbytes = t * cfg["n_chan"] * 4 + (cfg["n_phase"] + 1) * cfg["n_chan"] * 16
    ops = lanes * (2 * 5 * n * int(math.log2(n)) + 6 * n) \
        + cfg["n_chan"] * 12 * t
    return nbytes, ops


def repack_work(cfg):
    """(bytes, operations) of one ``guppi_repack`` launch: the (n_chan,
    T) words read once and both (T/4, 2 n_chan) planes written once;
    it computes nothing."""
    t = cfg["window"]["valid_samples"]
    return t * cfg["n_chan"] * 4 * 2, 0


def k3_stokes_work(cfg, tile):
    """(bytes, operations) of one K3 Stokes launch with lane tile
    ``tile``: both float32 planes of the window read once, plus the
    partner column each tile reads (1/tile more), and the (n_phase + 1)
    x 3L profile and the counts written once; the inverse stage A's
    FFTs over N1 rows (5 N log2 N1 a lane) and the four Stokes products
    of each channel's valid rows (12 T)."""
    w = cfg["window"]
    n, t = w["n_fft"], w["valid_samples"]
    lanes = cfg["n_chan"] * cfg["n_pol"]
    n1 = 1 << min(int(math.log2(n)) // 2, 9)
    nbytes = (n * lanes * 8 + n * (lanes // tile) * 8
              + (cfg["n_phase"] + 1) * (3 * lanes + 1) * 4)
    ops = lanes * 5 * n * int(math.log2(n1)) + cfg["n_chan"] * 12 * t
    return nbytes, ops


class Work(float):
    """A unit's bytes or operations (the float) with the same count of
    each kernel that has a roofline of its own, by launch name
    (``kernels``); scaling it, as the harness does by the traced units,
    scales both."""

    def __new__(cls, total, kernels):
        self = super().__new__(cls, total)
        self.kernels = dict(kernels)
        return self

    def __mul__(self, k):
        return Work(float(self) * k,
                    {name: v * k for name, v in self.kernels.items()})

    __rmul__ = __mul__


class Feed(flagship.Feed):
    """The closed loop's view of the pipeline (see the module): the
    flagship's feed, its pool GUPPI words."""

    def __init__(self, cfg, traffic, seed, device, spans):
        if traffic["feed"] not in FEEDS:
            raise ValueError(f"guppi_b1937_stokes has no feed "
                             f"{traffic['feed']!r}")
        self.spans = spans
        self.build_s = None
        # the pipeline first: a port without the GUPPI layout refuses the
        # configuration here, before any kernel is built
        self.pipe = pipeline(cfg, device)
        # K3's lane tile at this shape (the kernels' own choice, read
        # from the library); the CPU runs the plain versions, which read
        # no partner column
        tile = None
        if device.type == "cuda":
            from baseband_tasks_tpu_torch.ops import _build, dedisperse
            t0 = time.perf_counter()
            _build.library()
            self.build_s = time.perf_counter() - t0
            n1 = dedisperse.split_n(cfg["window"]["n_fft"])[0]
            tile = dedisperse.k3_form(
                "k3_fold_stokes", n1, cfg["n_chan"] * cfg["n_pol"],
                cfg["n_phase"])["tile"]
        t = self.pipe.block_samples
        self.n_pool = int(traffic["pool"])
        self.steps = int(traffic["steps_per_call"])
        self.calls = int(traffic["calls_per_unit"])
        self.t = t
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.pool = [torch.randint(0, 256, (cfg["n_chan"], t, 4),
                                   generator=g, dtype=torch.uint8,
                                   device=device).view(torch.int32)
                     .reshape(cfg["n_chan"], t)
                     for _ in range(self.n_pool)]
        self.runs = [self.pipe.run_fn(self.steps, offset0=c * self.steps * t,
                                      ingest_bits=cfg["ingest_bits"])
                     for c in range(self.calls)]
        self.samples_per_unit = (self.calls * self.steps * t
                                 * cfg["n_chan"] * cfg["n_pol"])
        kernels = {"guppi_repack": repack_work(cfg)}
        if tile:
            kernels["k3_fold_stokes"] = k3_stokes_work(cfg, tile)
        n = self.calls * self.steps
        self._work = tuple(
            Work(n * total, {k: n * w[i] for k, w in kernels.items()})
            for i, total in enumerate(work_per_step(cfg)))
        for i in range(2):          # builds the kernels, fills the caches
            self.unit(i)


def make_feed(cfg, traffic, seed, device, spans):
    return Feed(cfg, traffic, seed, device, spans)
