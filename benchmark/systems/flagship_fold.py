"""The flagship: ``WidebandPulsarPipeline(use_kernels=True)`` of the port,
packed 8-bit ingest, its ``run_fn`` entry on one device.

Feeds (the traffic's ``feed``):

- ``card_pool``: a pool of ``pool`` seeded payloads made on the device in
  set-up;
- ``host_pool``: the same pool in pinned host memory (a capture ring
  registered with CUDA), handed to the entry as host tensors: the entry
  copies each block to the card.

On the card, set-up first loads the port's kernel libraries, building
them on a checkout's first run; ``build_s`` is that time (part of the
set-up).

Unit ``i`` (one sub-integration) makes ``calls_per_unit`` calls: call
``c`` runs ``run_fn(steps_per_call, offset0=c * steps_per_call * T)`` on
pool block ``(i + c) % pool``; the calls' profiles and counts are summed
on the device and fetched to the host.  Step ``s`` of call ``c`` folds at
stream sample ``(c * steps_per_call + s) * T``: its fold row and its
``1 + 1e-6 * off`` scale are those of that offset, which is what the
reference is given.
"""

from __future__ import annotations

import math
import time

import torch

FEEDS = ("card_pool", "host_pool")


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
        ingest_bits=cfg["ingest_bits"], detect=cfg["detect"])
    got = {"n_fft": pipe.pad_start + pipe.block_samples + pipe.pad_end,
           "pad_start": pipe.pad_start, "pad_end": pipe.pad_end,
           "valid_samples": pipe.block_samples}
    if got != cfg["window"]:
        raise ValueError(f"the pipeline's window {got} is not the "
                         f"configuration's {cfg['window']}")
    return pipe


def work_per_step(cfg, sample_bytes):
    """(bytes, operations) of one step, from the configuration's shapes:
    the input voltages read once and the profile and counts written once;
    a forward and an inverse FFT of each lane's window (5 N log2 N each),
    the response multiply (6 N) and the detection |x|^2 (3 T)."""
    w = cfg["window"]
    n, t = w["n_fft"], w["valid_samples"]
    lanes = cfg["n_chan"] * cfg["n_pol"]
    nbytes = t * lanes * sample_bytes + cfg["n_phase"] * (lanes + 1) * 4
    ops = lanes * (2 * 5 * n * int(math.log2(n)) + 6 * n + 3 * t)
    return nbytes, ops


class Feed:
    """The closed loop's view of the pipeline (see the module)."""

    def __init__(self, cfg, traffic, seed, device, spans):
        if traffic["feed"] not in FEEDS:
            raise ValueError(f"flagship_fold has no feed {traffic['feed']!r}")
        self.spans = spans
        self.build_s = None
        if device.type == "cuda":
            from baseband_tasks_tpu_torch.ops import _build
            t0 = time.perf_counter()
            _build.library()
            self.build_s = time.perf_counter() - t0
        self.pipe = pipeline(cfg, device)
        t = self.pipe.block_samples
        bits = cfg["ingest_bits"]
        self.n_pool = int(traffic["pool"])
        self.steps = int(traffic["steps_per_call"])
        self.calls = int(traffic["calls_per_unit"])
        self.t = t
        shape = (t * bits // 32, cfg["n_chan"], cfg["n_pol"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        host = traffic["feed"] == "host_pool"
        self.pool = []
        for _ in range(self.n_pool):
            words = torch.randint(0, 256, (2,) + shape + (4,), generator=g,
                                  dtype=torch.uint8, device=device).view(
                torch.int32).reshape((2,) + shape)
            if host:
                words = words.cpu()
                if device.type == "cuda":
                    words = words.pin_memory()
            self.pool.append((words[0], words[1]))
        self.runs = [self.pipe.run_fn(self.steps, offset0=c * self.steps * t,
                                      ingest_bits=bits)
                     for c in range(self.calls)]
        self.samples_per_unit = (self.calls * self.steps * t
                                 * cfg["n_chan"] * cfg["n_pol"])
        step = work_per_step(cfg, 2 * bits // 8)
        self._work = tuple(self.calls * self.steps * w for w in step)
        for i in range(2):          # builds the kernels, fills the caches
            self.unit(i)

    def unit(self, i):
        prof = cnt = None
        for c, run in enumerate(self.runs):
            with self.spans.span("wideband.run", self.steps):
                p, n = run(blocks=self.pool[(i + c) % self.n_pool])
            prof, cnt = (p, n) if prof is None else (prof + p, cnt + n)
        with self.spans.span("bench.fetch"):
            return prof.cpu().numpy(), cnt.cpu().numpy()

    def key(self, i):
        """(pool block, stream sample offset) of every step of unit i."""
        return tuple(((i + c) % self.n_pool, (c * self.steps + s) * self.t)
                     for c in range(self.calls) for s in range(self.steps))

    def work_per_unit(self):
        return self._work

    def reference_data(self):
        return {"pool": self.pool}

    def release(self):
        self.runs = self.pipe = None

    def close(self):
        self.pool = None


def make_feed(cfg, traffic, seed, device, spans):
    return Feed(cfg, traffic, seed, device, spans)
