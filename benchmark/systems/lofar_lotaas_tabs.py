"""LOFAR's tied-array beamformer as a LOTAAS COBALT node forms one SAP's
coherent TABs: the port's ``tied_array_beam(streams, n_chan, delays=...,
lo=<each subband's sky frequency>, method='phase', beam_delays=<each
TAB's geometric delay at each field>, stokes='I')`` into an
``Integrate(n_int)`` of sums and counts, compiled by
``CompiledPipeline(..., block_samples=B)`` and run through its
``run_fn`` entry on one device.

Field k (one of the Superterp's HBA fields) is one source stream of
``(time, subband, pol)`` complex64 voltages, labelled with its subbands'
centre frequencies, at the arrival delay ``d_k`` (samples) of the SAP
centre, drawn from the seed as the LOFAR correlator's system draws it
(``lofar_hba_cobalt.delays``).  The chain advances each field by its
whole samples, channelizes every subband (16-point FFTs), turns the
fractional part into a per-channel phase slope and stops the fringe of
each subband at its own sky frequency (the correlator's F stage), then
forms ``n_tab`` TABs, each steered by its geometric delay ``tau[b, k]``
at every channel's sky frequency, as one batched complex matrix product
a block, detects their Stokes I and sums it over ``n_int`` spectra.

Feed (the traffic's ``feed``): ``card_pool``, a pool of ``pool`` seeded
blocks made on the device in set-up, each holding every field's samples
of one unit (``lofar_hba_cobalt.make_dump``: a common sky signal at
each field's whole-sample delay and fringe, plus independent field
noise).  A unit is one COBALT block of ``cobalt_block_samples`` samples:
one ``run_fn`` over ``steps_per_call`` blocks and a lead block (the
run's first spectrum is the carries' warm-up, so the Stokes sums start
one spectrum in).  Its Stokes I sums and counts are fetched into pinned
host buffers, one pair a pool block (a unit's sums are 584 MB: the loop
cannot keep every unit's); every row must count ``n_int``.

The work of a unit (:meth:`Feed.work_per_unit`) is the configuration's
(:func:`work_per_unit`), which ``kernels_roofline`` reads, as two
``Work`` numbers that also carry the TAB products' and detection's own
(:func:`bf_work`) under the name ``beamformer.bf``, which
``beamformer.bf_roofline`` reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.systems import lofar_hba_cobalt as cobalt
from benchmark.systems.guppi_b1937_stokes import Work

FEEDS = ("card_pool",)
C_M_PER_S = 299_792_458.0


def spectra_per_unit(cfg):
    """Spectra of a unit: one COBALT block channelized."""
    n, r = divmod(cfg["cobalt_block_samples"], cfg["n_chan"])
    if r:
        raise ValueError("a COBALT block is not a whole number of spectra")
    return n


def rows(cfg):
    """Stokes I samples (rows) of a unit: its spectra in sums of n_int."""
    n, r = divmod(spectra_per_unit(cfg), cfg["n_int"])
    if r:
        raise ValueError(f"{spectra_per_unit(cfg)} spectra are not a whole "
                         f"number of {cfg['n_int']}-spectrum sums")
    return n


def _as_dump(cfg):
    """``cfg`` read as the correlator system's configuration, a unit its
    dump, so that its helpers lay out the same blocks."""
    return dict(cfg, n_avg=spectra_per_unit(cfg))


def unit_blocks(cfg):
    """(blocks of the unit, blocks a unit runs): the COBALT block and, in
    front of it, the lead."""
    return cobalt.dump_blocks(_as_dump(cfg))


def unit_samples(cfg):
    """Complex samples of a unit (per field, subband and polarization)."""
    return (cfg["n_station"] * cfg["n_subband"] * cfg["n_pol"]
            * cfg["cobalt_block_samples"])


def tab_delays(cfg, seed):
    """(n_tab, n_station) float64 geometric delays (s) of each TAB at each
    field, from the seed: field positions (x, y) uniform in a disc of
    ``field_radius_m`` around the Superterp's centre, TAB b's direction
    cosines (l_b, m_b) from the SAP centre uniform in a disc of
    ``tab_radius_deg`` (TAB 0 at the centre); tau = (l_b x_k + m_b y_k)
    / c."""
    rng = np.random.default_rng([seed, 29])

    def disc(n, radius):
        r = radius * np.sqrt(rng.uniform(0.0, 1.0, n))
        phi = rng.uniform(0.0, 2 * np.pi, n)
        return r * np.cos(phi), r * np.sin(phi)

    x, y = disc(cfg["n_station"], cfg["field_radius_m"])
    l, m = disc(cfg["n_tab"], np.sin(np.radians(cfg["tab_radius_deg"])))
    l[0] = m[0] = 0.0
    return (np.outer(l, x) + np.outer(m, y)) / C_M_PER_S


def chain(cfg, d, tau, device, dump=None):
    """The port's beamformer over ``cfg``'s fields at delays ``d``
    (samples) and TAB delays ``tau`` (s): Stokes I sums and counts of
    ``n_int`` spectra, from the lead on.  The field streams hold the lead
    and one COBALT block, read from the block's rows (n_station, T,
    n_subband, n_pol) where ``dump`` is given (eager reads); the compiled
    entry is fed blocks and reads none."""
    import baseband_tasks_tpu_torch as bt
    from baseband_tasks_tpu_torch.models import tied_array_beam
    u = bt.units
    rate = cobalt.rate_hz(cfg) * u.Hz
    lead = cobalt.lead_spectra(cfg)
    n = (lead * cfg["n_chan"] + cfg["cobalt_block_samples"]
         + cfg["max_delay_samples"])
    shape = (n, cfg["n_subband"], cfg["n_pol"])
    freq = cobalt.subband_hz(cfg).reshape(-1, 1) * u.Hz
    start = bt.Time.from_mjd(float(cfg["start_mjd"]))

    def rows_of(k):
        def frame(sh):
            if dump is None:
                raise RuntimeError("the compiled entry reads no field")
            return dump[k, sh.tell():sh.tell() + sh.samples_per_frame]
        return frame

    streams = [bt.StreamGenerator(rows_of(k), shape, start, rate,
                                  samples_per_frame=cfg["block_samples"],
                                  dtype=np.complex64, frequency=freq,
                                  sideband=cfg["sideband"], device=device)
               for k in range(cfg["n_station"])]
    beams = tied_array_beam(streams, cfg["n_chan"],
                            delays=[dk / rate for dk in d], lo=freq,
                            method=cfg["method"],
                            samples_per_frame=cfg["block_samples"],
                            beam_delays=tau * u.s, stokes="I")
    return bt.Integrate(beams, cfg["n_int"], start=lead, average=False)


def compiled(cfg, d, tau, device):
    """``CompiledPipeline`` of :func:`chain` at the configuration's block;
    its geometry must be the one the feed lays its blocks out for, and
    its reduction one COBALT block's rows."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    cp = CompiledPipeline(chain(cfg, d, tau, device),
                          block_samples=cfg["block_samples"])
    want = [int(round(x)) for x in d]
    lead = cobalt.lead_spectra(cfg)
    if (cp.delay != 0 or cp.warmup > lead or cp.source_offsets != want
            or cp.reduction.shape[0] != rows(cfg)):
        raise ValueError(f"compiled geometry (delay {cp.delay}, warm-up "
                         f"{cp.warmup}, offsets {cp.source_offsets}, "
                         f"{cp.reduction.shape[0]} rows) is not the feed's "
                         f"(0, <= {lead}, {want}, {rows(cfg)})")
    return cp


def _stokes_bytes(cfg):
    """The Stokes I sums of a unit, float32."""
    return (rows(cfg) * cfg["n_tab"] * cfg["n_chan"] * cfg["n_subband"]
            * 4)


def bf_work(cfg):
    """(bytes, operations) of one unit's TAB products and detection: the
    stacked spectra read once (8 bytes a complex sample) and the Stokes I
    sums written once; 8 operations (a complex multiply and an add) for
    each TAB of every sample, 4 for each beam sample's detection (its
    |.|^2 and the polarization sum)."""
    samples = unit_samples(cfg)
    beams = (cfg["n_tab"] * cfg["n_chan"] * cfg["n_subband"] * cfg["n_pol"]
             * spectra_per_unit(cfg))
    return (samples * 8 + _stokes_bytes(cfg),
            8 * cfg["n_tab"] * samples + 4 * beams)


def work_per_unit(cfg):
    """(bytes, operations) of one unit, from the configuration's shapes:
    the field voltages read once and the Stokes I sums written once; the
    16-point FFTs (5 N log2 N each), the phase rotation of every
    spectrum's sample (6) and the TABs (:func:`bf_work`)."""
    samples = unit_samples(cfg)
    n_chan = cfg["n_chan"]
    nbytes, bf_ops = bf_work(cfg)
    ops = ((samples // n_chan) * 5 * n_chan * int(math.log2(n_chan))
           + 6 * samples + bf_ops)
    return nbytes, ops


class Feed:
    """The closed loop's view of the beamformer (see the module)."""

    def __init__(self, cfg, traffic, seed, device, spans):
        if traffic["feed"] not in FEEDS:
            raise ValueError(f"lofar_lotaas_tabs has no feed "
                             f"{traffic['feed']!r}")
        if int(traffic["calls_per_unit"]) != 1:
            raise ValueError("a unit is one run_fn call over one COBALT "
                             "block")
        unit, n_blocks = unit_blocks(cfg)
        if int(traffic["steps_per_call"]) != unit:
            raise ValueError(f"a COBALT block is {unit} blocks, not "
                             f"{traffic['steps_per_call']}")
        self.spans = spans
        self.d = cobalt.delays(cfg, seed)
        self.tau = tab_delays(cfg, seed)
        # the chain first: a port without TAB steering or Stokes I
        # refuses the configuration here
        self.cp = compiled(cfg, self.d, self.tau, device)
        self.run = self.cp.run_fn(n_blocks)
        self.n_pool = int(traffic["pool"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.pool = [cobalt.make_dump(_as_dump(cfg), self.d, g, device)
                     for _ in range(self.n_pool)]
        b, n = cfg["block_samples"], n_blocks * cfg["block_samples"]
        sub = (cfg["n_subband"], cfg["n_pol"])
        # each field's blocks: a view of its row from its read offset
        self.blocks = [tuple(x[k, o:o + n].view((n_blocks, b) + sub)
                             for k, o in enumerate(self.cp.source_offsets))
                       for x in self.pool]
        # the host's buffers, one pair a pool block: pinned, so the fetch
        # is one copy at the link's rate
        pin = device.type == "cuda"
        shape = (rows(cfg), cfg["n_tab"], cfg["n_chan"], cfg["n_subband"])
        self.host = [(torch.empty(shape, dtype=torch.float32,
                                  pin_memory=pin),
                      torch.empty(rows(cfg), dtype=torch.int64,
                                  pin_memory=pin))
                     for _ in range(self.n_pool)]
        self.samples_per_unit = unit_samples(cfg)
        self._work = tuple(Work(w, {"beamformer.bf": b})
                           for w, b in zip(work_per_unit(cfg), bf_work(cfg)))
        self.lead = cobalt.lead_spectra(cfg)
        for i in range(2):          # cuFFT plans, cuBLAS, the allocator
            self.unit(i)

    def unit(self, i):
        with self.spans.span("compiled.run"):
            sums, counts = self.run(self.blocks[i % self.n_pool])
        with self.spans.span("bench.fetch"):
            s, c = self.host[i % self.n_pool]
            s.copy_(sums)
            c.copy_(counts)
            return s.numpy(), c.numpy().copy()

    def key(self, i):
        """The pool block of unit i."""
        return i % self.n_pool

    def work_per_unit(self):
        return self._work

    def reference_data(self):
        return {"pool": self.pool, "delays": self.d, "tabs": self.tau,
                "lead": self.lead}

    def release(self):
        self.run = self.cp = self.blocks = None

    def close(self):
        self.pool = None


def make_feed(cfg, traffic, seed, device, spans):
    return Feed(cfg, traffic, seed, device, spans)
