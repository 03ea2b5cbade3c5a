"""Plain reference of the flagship configuration (numpy and torch only).

From the configuration's numbers and the benchmark's own 8-bit payloads
it works out, for each step of a unit, what the pipeline is to produce:

- the 8-bit offset-binary decode, (byte - 127.5) / 64 (the flagship's
  8-bit normalisation), of plane-packed words: byte k of word r is
  sample ``k * T/4 + r`` of its lane, lane ``c * n_pol + p``;
- the window geometry: pads from the band edges' DM delay against the
  band centre (+64, up to multiples of 128), a power-of-two window, pads
  up to multiples of its N2 and the end pad grown until the main rows
  divide by 4;
- each window on its own: [zeros | block x scale | zeros], the scale
  ``(1 + 1e-6 * (offset mod q))`` of the step's stream offset;
- coherent dedispersion against the band centre: the FFT of each lane's
  window times conj(exp(2 pi i phi)), phi = D DM f (1/f_c - 1/f)^2
  cycles, D = 1/2.41e-4 MHz^2 s cm^3/pc, the inverse FFT;
- |x|^2 of the valid samples;
- the fold: the polyco's phase at the step's first sample and its
  frequency at mid-block, both in exact rational arithmetic, as 31-bit
  fixed-point ``i0`` and ``p``; sample j goes to bin
  ``((i0 + j p) mod 2^31) * n_phase >> 31``; the counts.

Everything is computed in float64 on the given device (``precision=
'bfloat16'`` stores every intermediate in bfloat16 instead: the control).
"""

from __future__ import annotations

import math
from decimal import Decimal
from fractions import Fraction

import numpy as np
import torch

from benchmark.plain import DISPERSION_CONSTANT, bf16, n2_of

#: limits of the comparison of each unit's output with the reference
LIMITS = {"profile_rel_err": 1e-5, "count_err": 0.0}

FX_ONE = 1 << 31
FX_MASK = FX_ONE - 1


def _pow2_at_least(n):
    return 1 << (int(n) - 1).bit_length()


def channel_mhz(cfg):
    rate_mhz = cfg["chan_rate_khz"] / 1e3
    return cfg["freq_center_mhz"] + (np.arange(cfg["n_chan"])
                                     - cfg["n_chan"] / 2 + 0.5) * rate_mhz


def geometry(cfg):
    """(n_fft, pad_start, pad_end, valid samples T) of the window."""
    rate_hz = cfg["chan_rate_khz"] * 1e3
    fc = cfg["freq_center_mhz"]
    chan = channel_mhz(cfg)
    edges = np.concatenate([chan - rate_hz / 2e6, chan + rate_hz / 2e6])
    delay = DISPERSION_CONSTANT * cfg["dm"] * (1 / edges ** 2 - 1 / fc ** 2)
    ps = max(math.ceil(delay.max() * rate_hz), 0) + 64
    pe = max(math.ceil(-delay.min() * rate_hz), 0) + 64
    ps, pe = -(-ps // 128) * 128, -(-pe // 128) * 128
    n_fft = _pow2_at_least(cfg["block_samples"] + ps + pe)
    n2 = n2_of(n_fft)
    n1 = n_fft // n2
    ps, pe = -(-ps // n2) * n2, -(-pe // n2) * n2
    pe += ((n1 - (ps + pe) // n2) % (32 // cfg["ingest_bits"])) * n2
    return n_fft, ps, pe, n_fft - ps - pe


def _num(s):
    return Fraction(Decimal(s.replace("D", "E").replace("d", "e")))


def polyco(lines):
    """The one entry of a tempo polyco: (tmid MJD, rphase, f0, coeffs),
    exact rationals of the decimal text."""
    h1, h2 = lines[0].split(), lines[1].split()
    n_coeff = int(h2[4])
    coeffs = " ".join(lines[2:]).split()[:n_coeff]
    return _num(h1[3]), _num(h2[0]), _num(h2[1]), [_num(c) for c in coeffs]


def fold_rows(cfg, offsets, t):
    """{offset: (i0, p)}: the fixed-point fold row of the T-sample block
    at each stream sample offset."""
    tmid, rphase, f0, c = polyco(cfg["polyco"])
    rate = Fraction(Decimal(str(cfg["chan_rate_khz"]))) * 1000
    start = _num(str(cfg["start_mjd"]))

    def dt_min(offset):
        return (start - tmid) * 1440 + Fraction(offset) / rate / 60

    rows = {}
    for off in offsets:
        dt = dt_min(off)
        ph = rphase + 60 * f0 * dt + sum(ck * dt ** k for k, ck in
                                         enumerate(c))
        i0 = round((ph - math.floor(ph)) * FX_ONE) & FX_MASK
        dt = dt_min(Fraction(off) + Fraction(t, 2))
        f = f0 + sum(k * ck * dt ** (k - 1) for k, ck in
                     enumerate(c) if k) / 60
        a1 = f / rate
        rows[off] = (i0, round((a1 - math.floor(a1)) * FX_ONE) & FX_MASK)
    return rows


def scale(cfg, offset):
    """The step's scale, 1 + 1e-6 (offset mod q), q the period numerator."""
    q = Fraction(*cfg["period_samples"]).numerator
    return 1.0 + 1e-6 * (offset % q)


def chirp(cfg, n_fft, device):
    """(n_fft, lanes) complex128: conj(exp(2 pi i phi)) per lane."""
    rate_mhz = cfg["chan_rate_khz"] / 1e3
    fc = cfg["freq_center_mhz"]
    chan = torch.as_tensor(channel_mhz(cfg), dtype=torch.float64,
                           device=device)
    off = torch.fft.fftfreq(n_fft, dtype=torch.float64,
                            device=device) * rate_mhz
    f = chan[None, :] + off[:, None]
    cyc = DISPERSION_CONSTANT * 1e6 * cfg["dm"] * f * (1 / fc - 1 / f) ** 2
    cyc = cyc - torch.round(cyc)
    resp = torch.polar(torch.ones_like(cyc), -2 * math.pi * cyc)
    return resp.repeat_interleave(cfg["n_pol"], dim=1)


def decode(words, t, device):
    """(T, lanes) float64 samples of (T/4, n_chan, n_pol) packed words."""
    w = torch.as_tensor(words).to(device).contiguous()
    b = w.view(torch.uint8).reshape(t // 4, w.shape[1], w.shape[2], 4)
    x = b.permute(3, 0, 1, 2).reshape(t, w.shape[1] * w.shape[2])
    return (x.to(torch.float64) - 127.5) / 64.0


def power(x, resp, ps, n_fft, precision):
    """|dedispersed x|^2 of the window [zeros | x | zeros]: (T, lanes)."""
    t, lanes = x.shape
    if precision == "float64":
        w = torch.zeros((n_fft, lanes), dtype=torch.complex128,
                        device=x.device)
        w[ps:ps + t] = x
        y = torch.fft.ifft(torch.fft.fft(w, dim=0) * resp, dim=0)[ps:ps + t]
        return y.real ** 2 + y.imag ** 2
    w = torch.zeros((n_fft, lanes), dtype=torch.complex64, device=x.device)
    w[ps:ps + t] = bf16(x.to(torch.complex64))
    spec = bf16(torch.fft.fft(w, dim=0))
    spec = bf16(spec * resp.to(torch.complex64))
    y = bf16(torch.fft.ifft(spec, dim=0)[ps:ps + t])
    return bf16(y.real ** 2 + y.imag ** 2).to(torch.float64)


def bins(row, t, n_phase, device):
    i0, p = row
    j = torch.arange(t, dtype=torch.int64, device=device)
    return (((i0 + j * p) & FX_MASK) * n_phase) >> 31


def expected(cfg, traffic, data, keys, device, precision="float64"):
    """{key: (profile (n_phase, n_chan, n_pol) float64, counts (n_phase,)
    int64)} for units whose key lists (pool block, stream offset) per
    step; ``data['pool']`` holds the (re, im) packed words of each
    block."""
    n_fft, ps, _, t = geometry(cfg)
    n_phase, lanes = cfg["n_phase"], cfg["n_chan"] * cfg["n_pol"]
    rows = fold_rows(cfg, sorted({off for key in keys for _, off in key}), t)
    resp = chirp(cfg, n_fft, device)
    acc = {key: (torch.zeros((n_phase, lanes), dtype=torch.float64,
                             device=device),
                 torch.zeros(n_phase, dtype=torch.int64, device=device))
           for key in keys}
    for j in sorted({j for key in keys for j, _ in key}):
        re, im = data["pool"][j]
        x = torch.complex(decode(re, t, device), decode(im, t, device))
        pw = power(x, resp, ps, n_fft, "float64") \
            if precision == "float64" else None
        for key in keys:
            for jj, off in key:
                if jj != j:
                    continue
                s = scale(cfg, off)
                b = bins(rows[off], t, n_phase, device)
                step = pw * s * s if pw is not None else power(
                    x * s, resp, ps, n_fft, precision)
                acc[key][0].index_add_(0, b, step)
                acc[key][1].add_(torch.bincount(b, minlength=n_phase))
        del x, pw
    return {key: (p.reshape(n_phase, cfg["n_chan"], cfg["n_pol"]).cpu()
                  .numpy(), c.cpu().numpy()) for key, (p, c) in acc.items()}


def compare(out, ref):
    """The numbers compared for one unit: the largest relative gap of a
    profile cell, and the largest gap of a count."""
    prof, cnt = (np.asarray(a, np.float64) for a in out)
    rprof, rcnt = ref
    gap = np.abs(prof - rprof)
    rel = np.divide(gap, np.abs(rprof), out=np.where(gap > 0, np.inf, 0.0),
                    where=rprof != 0)
    return {"profile_rel_err": float(rel.max()),
            "count_err": float(np.abs(cnt - rcnt).max())}
