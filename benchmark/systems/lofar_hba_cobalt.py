"""A LOFAR HBA correlator node, correlated as COBALT does it: the port's FX
correlator ``fx_correlate(streams, n_chan, n_avg, delays=...,
method='phase', lo=<each subband's sky frequency>, products='full')``
compiled by ``CompiledPipeline(..., block_samples=B)`` and run through
its ``run_fn`` entry on one device.

Station k is one source stream of ``(time, subband, pol)`` complex64
voltages, labelled with its subbands' centre frequencies; its arrival
delay ``d_k`` (samples) is drawn from the seed, station 0 (the
reference) at 0, the others uniform in [0, ``max_delay_samples``].  The
chain advances each station by its whole samples, channelizes every
subband (64-point FFTs), turns the fractional part into a per-channel
phase slope and stops the fringe of each subband at its own sky
frequency, then forms the four polarization products of every baseline
i <= j and sums them over ``n_avg`` spectra (the absorbed Integrate).

Feed (the traffic's ``feed``): ``card_pool``, a pool of ``pool`` seeded
dumps made on the device in set-up.  Each dump holds every station's
samples of one unit: a common sky signal at each station's whole-sample
delay, turned by the fringe phase exp(-2 pi i f_sb d_k / rate) of each
subband, plus independent station noise.  A unit runs one ``run_fn``
over ``steps_per_call`` blocks and the lead: the run starts from zeroed
carries, whose warm-up spoils the first spectrum of a delayed station,
so the dump (``fx_correlate``'s ``start``) begins ``lead`` spectra in
and the run has one block more.  Its visibility sums and counts are
fetched to the host; the one dump row must count ``n_avg``.

The work of a unit (:meth:`Feed.work_per_unit`) is the configuration's
work a dump (:func:`work_per_dump`), which ``kernels_roofline`` reads,
as two ``Work`` numbers that also carry the X stage's own
(:func:`x_stage_work`) under the name ``correlator.x``, which
``correlator.x_roofline`` reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.systems.guppi_b1937_stokes import Work

FEEDS = ("card_pool",)


def n_baselines(cfg):
    """Station pairs i <= j, autocorrelations included."""
    n = cfg["n_station"]
    return n * (n + 1) // 2


def subband_hz(cfg):
    """(n_subband,) float64 sky frequency of each subband's centre (its
    complex baseband's zero frequency)."""
    return (cfg["subband0_mhz"] * 1e6
            + np.arange(cfg["n_subband"]) * cfg["subband_khz"] * 1e3)


def rate_hz(cfg):
    return cfg["subband_khz"] * 1e3


def delays(cfg, seed):
    """(n_station,) float64 arrival delays in samples from the seed:
    station 0 the reference at 0, the others uniform in [0,
    max_delay_samples]."""
    d = np.random.default_rng(seed).uniform(
        0.0, cfg["max_delay_samples"], cfg["n_station"])
    d[0] = 0.0
    return d


def lead_spectra(cfg):
    """Spectra before the dump: the carries' warm-up of a station
    advanced by up to ``max_delay_samples``."""
    return -(-cfg["max_delay_samples"] // cfg["n_chan"])


def dump_blocks(cfg):
    """(blocks of the dump, blocks a unit runs): the dump's n_avg spectra
    and, in front of them, the lead."""
    b, n_chan = cfg["block_samples"], cfg["n_chan"]
    dump = cfg["n_avg"] * n_chan
    if dump % b:
        raise ValueError(f"a dump of {dump} samples is not a whole number "
                         f"of {b}-sample blocks")
    return dump // b, -(-(dump + lead_spectra(cfg) * n_chan) // b)


def station_samples(cfg):
    """Samples of each station a unit holds: the blocks it runs, read
    from up to ``max_delay_samples`` in."""
    return dump_blocks(cfg)[1] * cfg["block_samples"] \
        + cfg["max_delay_samples"]


def chain(cfg, d, device, dump=None):
    """The port's correlator over ``cfg``'s stations at delays ``d``
    (samples), its Integrate with sums and counts.  The station streams
    are the dump's rows (n_station, T, n_subband, n_pol) where ``dump``
    is given (eager reads); the compiled entry is fed blocks and reads
    none."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.models import fx_correlate
    u = bt.units
    rate = rate_hz(cfg) * u.Hz
    shape = (station_samples(cfg), cfg["n_subband"], cfg["n_pol"])
    freq = subband_hz(cfg).reshape(-1, 1) * u.Hz
    start = bt.Time.from_mjd(float(cfg["start_mjd"]))

    def rows(k):
        def frame(sh):
            if dump is None:
                raise RuntimeError("the compiled entry reads no station")
            return dump[k, sh.tell():sh.tell() + sh.samples_per_frame]
        return frame

    streams = [bt.StreamGenerator(rows(k), shape, start, rate,
                                  samples_per_frame=cfg["block_samples"],
                                  dtype=np.complex64, frequency=freq,
                                  sideband=cfg["sideband"], device=device)
               for k in range(cfg["n_station"])]
    return fx_correlate(streams, cfg["n_chan"], cfg["n_avg"],
                        delays=[dk / rate for dk in d], lo=freq,
                        method=cfg["method"], products=cfg["products"],
                        samples_per_frame=cfg["block_samples"],
                        start=lead_spectra(cfg), average=False)


def compiled(cfg, d, device):
    """``CompiledPipeline`` of :func:`chain` at the configuration's block;
    its geometry must be the one the feed lays its blocks out for."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    cp = CompiledPipeline(chain(cfg, d, device),
                          block_samples=cfg["block_samples"])
    want = [int(round(x)) for x in d]
    if (cp.delay != 0 or cp.warmup > lead_spectra(cfg)
            or cp.source_offsets != want):
        raise ValueError(f"compiled geometry (delay {cp.delay}, warm-up "
                         f"{cp.warmup}, offsets {cp.source_offsets}) is not "
                         f"the feed's (0, <= {lead_spectra(cfg)}, {want})")
    return cp


def make_dump(cfg, d, g, device):
    """One dump: (n_station, T, n_subband, n_pol) complex64 station
    voltages, unit-variance noise plus the sky signal (variance
    ``sky_snr``) at each station's whole-sample delay and fringe phase."""
    n_st, t = cfg["n_station"], station_samples(cfg)
    lag = cfg["max_delay_samples"]
    sub = (cfg["n_subband"], cfg["n_pol"])
    x = torch.randn((n_st, t) + sub, dtype=torch.complex64, generator=g,
                    device=device)
    sky = torch.randn((t + lag,) + sub, dtype=torch.complex64, generator=g,
                      device=device) * math.sqrt(cfg["sky_snr"])
    for k, dk in enumerate(d):
        n = int(round(dk))
        fringe = np.exp(-2j * np.pi * subband_hz(cfg) * (dk / rate_hz(cfg))
                        * cfg["sideband"]).astype(np.complex64)
        x[k] += sky[lag - n:lag - n + t] * torch.as_tensor(
            fringe, device=device).reshape(-1, 1)
    return x


def work_per_dump(cfg):
    """(bytes, operations) of one dump, from the configuration's shapes:
    the station voltages read once (8 bytes a complex sample) and the
    visibilities written once (complex64); the 64-point FFTs (5 N log2 N
    each), the phase rotation of every spectrum's sample (6) and the X
    stage (:func:`x_stage_work`)."""
    samples = (cfg["n_station"] * cfg["n_subband"] * cfg["n_pol"]
               * cfg["n_avg"] * cfg["n_chan"])
    n_fft = samples // cfg["n_chan"]
    xb, xops = x_stage_work(cfg)
    nbytes = samples * 8 + _vis_bytes(cfg)
    ops = (n_fft * 5 * cfg["n_chan"] * int(math.log2(cfg["n_chan"]))
           + 6 * samples + xops)
    return nbytes, ops


def _vis_bytes(cfg):
    return (n_baselines(cfg) * cfg["n_chan"] * cfg["n_subband"]
            * cfg["n_pol"] ** 2 * 8)


def x_stage_work(cfg):
    """(bytes, operations) of one dump's X stage: the stacked spectra read
    once and the visibilities written once; 8 operations (a complex
    multiply and an add) for each product of every baseline, channel,
    subband, polarization pair and spectrum."""
    spectra_bytes = (cfg["n_station"] * cfg["n_subband"] * cfg["n_pol"]
                     * cfg["n_avg"] * cfg["n_chan"] * 8)
    products = (n_baselines(cfg) * cfg["n_pol"] ** 2 * cfg["n_chan"]
                * cfg["n_subband"] * cfg["n_avg"])
    return spectra_bytes + _vis_bytes(cfg), 8 * products


class Feed:
    """The closed loop's view of the correlator (see the module)."""

    def __init__(self, cfg, traffic, seed, device, spans):
        if traffic["feed"] not in FEEDS:
            raise ValueError(f"lofar_hba_cobalt has no feed "
                             f"{traffic['feed']!r}")
        if int(traffic["calls_per_unit"]) != 1:
            raise ValueError("a unit is one run_fn call over one dump")
        dump, n_blocks = dump_blocks(cfg)
        if int(traffic["steps_per_call"]) != dump:
            raise ValueError(f"a dump is {dump} blocks, not "
                             f"{traffic['steps_per_call']}")
        self.spans = spans
        self.d = delays(cfg, seed)
        # the chain first: a port without the full products or the
        # per-subband fringe refuses the configuration here
        self.cp = compiled(cfg, self.d, device)
        self.run = self.cp.run_fn(n_blocks)
        self.n_pool = int(traffic["pool"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.pool = [make_dump(cfg, self.d, g, device)
                     for _ in range(self.n_pool)]
        b, n = cfg["block_samples"], n_blocks * cfg["block_samples"]
        sub = (cfg["n_subband"], cfg["n_pol"])
        # each station's blocks: a view of its row from its read offset
        self.blocks = [tuple(x[k, o:o + n].view((n_blocks, b) + sub)
                             for k, o in enumerate(self.cp.source_offsets))
                       for x in self.pool]
        self.samples_per_unit = (cfg["n_station"] * cfg["n_subband"]
                                 * cfg["n_pol"] * dump * b)
        x = x_stage_work(cfg)
        self._work = tuple(Work(w, {"correlator.x": x[i]})
                           for i, w in enumerate(work_per_dump(cfg)))
        self.lead = lead_spectra(cfg)
        for i in range(2):          # cuFFT plans, the allocator's blocks
            self.unit(i)

    def unit(self, i):
        with self.spans.span("compiled.run"):
            sums, counts = self.run(self.blocks[i % self.n_pool])
        with self.spans.span("bench.fetch"):
            return sums.cpu().numpy(), counts.cpu().numpy()

    def key(self, i):
        """The pool dump of unit i."""
        return i % self.n_pool

    def work_per_unit(self):
        return self._work

    def reference_data(self):
        return {"pool": self.pool, "delays": self.d, "lead": self.lead}

    def release(self):
        self.run = self.cp = self.blocks = None

    def close(self):
        self.pool = None


def make_feed(cfg, traffic, seed, device, spans):
    return Feed(cfg, traffic, seed, device, spans)
