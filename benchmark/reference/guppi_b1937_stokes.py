"""Plain reference of the GUPPI full-Stokes deployment (numpy and torch
only).

It follows the flagship's reference (``flagship_fold.py``) step by step
and takes from it what the two configurations share: the window
geometry, the chirp against the band centre, each step's scale, the
polyco's exact rational fold rows and the bins.  What differs:

- the decode: one GUPPI raw block, channel-major (n_chan, T) 32-bit
  words, word (c, t) the signed 8-bit (X re, X im, Y re, Y im) of
  channel c's sample t; each value v is v / 64 (the port's 8-bit
  normalisation); lane 2c is X, lane 2c + 1 is Y;
- the detection: [XX, YY, Re XY*, Im XY*] of each channel's valid rows,
  XY* = X conj(Y);
- the comparison: the cross sums of a cell are sums of terms of either
  sign and pass through zero, so a gap relative to the cell itself means
  nothing there; by Cauchy-Schwarz |sum X conj(Y)| <= sqrt(XX YY) of the
  same bin and channel, so the gap of each Re and Im XY* cell is taken
  relative to sqrt(XX YY) of the reference.

Everything is computed in float64 on the given device (``precision=
'bfloat16'`` stores every intermediate in bfloat16 instead: the control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.plain import bf16
from benchmark.reference.flagship_fold import (bins, chirp, fold_rows,
                                               geometry, scale)

#: limits of the comparison of each unit's output with the reference
LIMITS = {"profile_rel_err": 1e-5, "cross_rel_err": 1e-5, "count_err": 0.0}


def decode(words, device):
    """(T, 2 n_chan) complex128 samples of (n_chan, T) GUPPI words."""
    w = torch.as_tensor(words).to(device).contiguous()
    c, t = w.shape
    v = w.view(torch.int8).reshape(c, t, 2, 2).to(torch.float64) / 64.0
    z = torch.complex(v[..., 0], v[..., 1])           # (chan, T, pol)
    return z.permute(1, 0, 2).reshape(t, 2 * c)


def dedispersed(x, resp, ps, n_fft, precision):
    """The valid rows of the dedispersed window [zeros | x | zeros]."""
    t, lanes = x.shape
    if precision == "float64":
        w = torch.zeros((n_fft, lanes), dtype=torch.complex128,
                        device=x.device)
        w[ps:ps + t] = x
        return torch.fft.ifft(torch.fft.fft(w, dim=0) * resp,
                              dim=0)[ps:ps + t]
    w = torch.zeros((n_fft, lanes), dtype=torch.complex64, device=x.device)
    w[ps:ps + t] = bf16(x.to(torch.complex64))
    spec = bf16(torch.fft.fft(w, dim=0))
    spec = bf16(spec * resp.to(torch.complex64))
    return bf16(torch.fft.ifft(spec, dim=0)[ps:ps + t])


def stokes(y, precision):
    """(T, n_chan * 4) float64 [XX, YY, Re XY*, Im XY*] per channel of
    (T, 2 n_chan) lanes."""
    t = y.shape[0]
    y = y.reshape(t, -1, 2)
    x, q = y[..., 0], y[..., 1]
    parts = [x.real * x.real + x.imag * x.imag,
             q.real * q.real + q.imag * q.imag,
             x.real * q.real + x.imag * q.imag,
             x.imag * q.real - x.real * q.imag]
    if precision != "float64":
        parts = [bf16(p) for p in parts]
    return torch.stack(parts, dim=-1).reshape(t, -1).to(torch.float64)


def expected(cfg, traffic, data, keys, device, precision="float64"):
    """{key: (profile (n_phase, n_chan, 4) float64, counts (n_phase,)
    int64)} for units whose key lists (pool block, stream offset) per
    step; ``data['pool']`` holds each block's (n_chan, T) GUPPI words."""
    n_fft, ps, _, t = geometry(cfg)
    n_phase, width = cfg["n_phase"], cfg["n_chan"] * 4
    rows = fold_rows(cfg, sorted({off for key in keys for _, off in key}), t)
    resp = chirp(cfg, n_fft, device)
    acc = {key: (torch.zeros((n_phase, width), dtype=torch.float64,
                             device=device),
                 torch.zeros(n_phase, dtype=torch.int64, device=device))
           for key in keys}
    for j in sorted({j for key in keys for j, _ in key}):
        x = decode(data["pool"][j], device)
        st = stokes(dedispersed(x, resp, ps, n_fft, "float64"), "float64") \
            if precision == "float64" else None
        for key in keys:
            for jj, off in key:
                if jj != j:
                    continue
                s = scale(cfg, off)
                b = bins(rows[off], t, n_phase, device)
                step = st * s * s if st is not None else stokes(
                    dedispersed(x * s, resp, ps, n_fft, precision),
                    precision)
                acc[key][0].index_add_(0, b, step)
                acc[key][1].add_(torch.bincount(b, minlength=n_phase))
        del x, st
    return {key: (p.reshape(n_phase, cfg["n_chan"], 4).cpu().numpy(),
                  c.cpu().numpy()) for key, (p, c) in acc.items()}


def _rel(gap, base):
    """gap / base, infinite where a gap meets a zero base."""
    return np.divide(gap, base, out=np.where(gap > 0, np.inf, 0.0),
                     where=base != 0)


def compare(out, ref):
    """The numbers compared for one unit: the largest relative gap of an
    XX or YY cell, the largest gap of a Re or Im XY* cell over sqrt(XX
    YY) of its bin and channel, and the largest gap of a count."""
    prof, cnt = (np.asarray(a, np.float64) for a in out)
    rprof, rcnt = ref
    gap = np.abs(prof - rprof)
    bound = np.sqrt(rprof[..., 0] * rprof[..., 1])[..., None]
    return {"profile_rel_err": float(_rel(gap[..., :2],
                                          np.abs(rprof[..., :2])).max()),
            "cross_rel_err": float(_rel(gap[..., 2:], bound).max()),
            "count_err": float(np.abs(cnt - rcnt).max())}
