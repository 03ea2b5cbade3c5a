"""Plain reference of the LOFAR HBA correlator node (numpy and torch only).

An FX correlator written out from its definition, in float64 on the
given device, a chunk of subbands at a time:

- station k's arrival delay ``d_k`` samples splits into whole samples
  ``n_k = round(d_k)`` and a fraction ``f_k = d_k - n_k``; the station is
  advanced by ``n_k`` (its sample ``t + n_k`` is the aligned sample t);
- the dump is the aligned samples' spectra ``lead .. lead + n_avg - 1``,
  each a 64-point FFT (numpy's sign and order, unnormalised) of 64
  consecutive samples of every subband and polarization;
- channel c (frequency ``fftfreq(n_chan)[c]`` cycles a sample) is turned
  by exp(2 pi i fftfreq[c] f_k), the fractional advance, and subband s by
  exp(2 pi i nu_s d_k / rate * sideband), the fringe stopping at its sky
  frequency nu_s;
- V_ij^pq = sum over the spectra of X_i^p conj(X_j^q), for every station
  pair i <= j (packed upper-triangle order) and the four polarization
  pairs in the order XX*, XY*, YX*, YY*: one product of the (station,
  pol) x spectra matrix with its conjugate transpose per channel and
  subband;
- the count of spectra in the dump.

The comparison: a visibility sum passes through zero, so its gap is
taken over sqrt(V_ii^pp V_jj^qq) of its channel and subband, which bounds
it (Cauchy-Schwarz); the XX and YY autocorrelations, positive, are held
to their own value too.

``precision='bfloat16'`` is the control: every intermediate stored in
bfloat16 (the voltages, the spectra, the rotated spectra), each block of
``block_samples / n_chan`` spectra summed from those (float32
accumulation, as bfloat16 products are summed on the card) and the
running sums kept in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: limits of the comparison of each unit's output with the reference.
#: The program sums each visibility over n_avg = 3072 spectra in float32
#: (unit roundoff u = 2^-24), and its gap from the float64 sum is led by
#: that summation's rounding.  Each addition's error is at most u times
#: the partial sum; taken as independent and of mean zero (the
#: probabilistic analysis of Higham and Mary 2019, SIAM J. Sci. Comput.
#: 41, A2815), the gap of a sum of n terms stays under
#: lambda sqrt(n) u times the sum of their magnitudes, except with
#: probability 2 n exp(-lambda^2 / 2).  With lambda = 10 that is 3.30e-5
#: (the probability 1.2e-18 a sum), and the sum of magnitudes is at most
#: sqrt(V_ii^pp V_jj^qq) (Cauchy-Schwarz), the base of both numbers; the
#: F stage's float32 FFT and the rotations add some (log2 64 + 4) u =
#: 6e-7.  So 4e-5.  On an H100 the program reads 3.8e-6 to 4.8e-6 and
#: the reference in bfloat16 (the control) some 3e-2 (PERF.md).
LIMITS = {"vis_rel_err": 4e-5, "auto_rel_err": 4e-5, "count_err": 0.0}

#: subbands a chunk of the reference computes at once (float64 spectra
#: of all 62 stations: 2 GB a chunk at the deployment's size)
CHUNK = 5


def _bf16(z):
    return torch.complex(z.real.to(torch.bfloat16).to(z.real.dtype),
                         z.imag.to(torch.bfloat16).to(z.real.dtype))


def spectra(cfg, x, d, lead, sbs, precision):
    """(n_station, n_avg, n_chan, n_sb, n_pol) complex spectra of the dump
    at the subbands of slice ``sbs``, advanced, rotated and
    fringe-stopped."""
    n_chan, n_avg = cfg["n_chan"], cfg["n_avg"]
    rate = cfg["subband_khz"] * 1e3
    nu = (cfg["subband0_mhz"] * 1e6
          + np.arange(cfg["n_subband"]) * cfg["subband_khz"] * 1e3)[sbs]
    fk = np.fft.fftfreq(n_chan)
    out = []
    for k, dk in enumerate(d):
        n = int(round(dk))
        a = n + lead * n_chan
        seg = x[k, a:a + n_avg * n_chan, sbs]
        rot = (np.exp(2j * np.pi * fk * (dk - n))[:, None, None]
               * np.exp(2j * np.pi * nu * (dk / rate)
                        * cfg["sideband"])[None, :, None])
        if precision == "float64":
            spec = torch.fft.fft(seg.to(torch.complex128).reshape(
                (n_avg, n_chan) + seg.shape[1:]), dim=1)
            out.append(spec * torch.as_tensor(rot, device=x.device))
        else:
            spec = _bf16(torch.fft.fft(_bf16(seg).reshape(
                (n_avg, n_chan) + seg.shape[1:]), dim=1))
            out.append(_bf16(spec * torch.as_tensor(
                rot.astype(np.complex64), device=x.device)))
    return torch.stack(out)


def correlate(cfg, a, precision):
    """(n_baseline, n_chan, n_sb, 4) sums of the products of spectra
    ``a`` (n_station, n_avg, n_chan, n_sb, n_pol)."""
    n_st, n_avg, n_chan, n_sb, n_pol = a.shape
    # (chan, sb) batches of the (station, pol) x spectra matrix
    m = a.permute(2, 3, 0, 4, 1).reshape(n_chan * n_sb, n_st * n_pol, n_avg)
    if precision == "float64":
        v = m @ m.conj().transpose(1, 2)
    else:
        step = cfg["block_samples"] // n_chan
        m = m.to(torch.complex128)     # bfloat16 values, summed exactly
        v = None
        for s in range(0, n_avg, step):
            blk = m[..., s:s + step]
            part = _bf16((blk @ blk.conj().transpose(1, 2)).to(
                torch.complex64))
            v = part if v is None else _bf16(v + part)
        v = v.to(torch.complex128)
    v = v.reshape(n_chan, n_sb, n_st, n_pol, n_st, n_pol)
    i, j = (torch.as_tensor(a, device=v.device)
            for a in np.triu_indices(n_st))
    # (baseline, chan, sb, p, q) -> product p * 2 + q
    out = v.permute(2, 4, 0, 1, 3, 5)[i, j]
    return out.reshape(len(i), n_chan, n_sb, n_pol * n_pol)


def expected(cfg, traffic, data, keys, device, precision="float64"):
    """{key: (visibility sums (n_baseline, n_chan, n_subband, 4)
    complex128 on ``device``, counts (1,) int64, the comparison's bases
    (:func:`bases`))} for units whose key is their pool dump; ``data``
    holds the dumps (``pool``), the delays in samples (``delays``) and
    the spectra before the dump (``lead``)."""
    out = {}
    n_sb = cfg["n_subband"]
    for key in keys:
        x = torch.as_tensor(data["pool"][key]).to(device)
        parts = []
        for s0 in range(0, n_sb, CHUNK):
            sbs = slice(s0, min(s0 + CHUNK, n_sb))
            a = spectra(cfg, x, data["delays"], data["lead"], sbs,
                        precision)
            parts.append(correlate(cfg, a, precision))
            del a
        vis = torch.cat(parts, dim=2)
        out[key] = (vis, np.array([cfg["n_avg"]], np.int64), bases(vis))
    return out


def bases(vis):
    """(autocorrelation mask over the baselines, XX and YY power of each
    station (n_station, n_chan, n_sb, 2), sqrt(V_ii^pp V_jj^qq) of each
    visibility) of reference sums ``vis``: the bases of the
    comparison."""
    n_st = int(round((np.sqrt(8 * vis.shape[0] + 1) - 1) / 2))
    i, j = (torch.as_tensor(a, device=vis.device)
            for a in np.triu_indices(n_st))
    autos = i == j
    power = vis[autos][..., [0, 3]].real
    p, q = [0, 0, 1, 1], [0, 1, 0, 1]
    return autos, power, torch.sqrt(power[i][..., p] * power[j][..., q])


def _rel(gap, base):
    """gap / base, infinite where a gap meets a zero base."""
    inf = torch.where(gap > 0, torch.inf, 0.0).to(gap.dtype)
    return torch.where(base != 0, gap / torch.where(base != 0, base, 1.0),
                       inf)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compare(out, ref):
    """The numbers compared for one unit: the largest gap of a visibility
    over sqrt(V_ii^pp V_jj^qq) of its channel and subband, the largest
    relative gap of an XX or YY autocorrelation, and the largest gap of
    a count, computed where the reference lies.  A unit with another
    number of dumps than the reference's one fails every number."""
    rvis, rcnt, (autos, power, bound) = ref
    vis = torch.as_tensor(_host(out[0])).to(rvis.device)
    cnt = _host(out[1])
    if vis.shape == (1,) + rvis.shape:
        vis = vis[0]
    if vis.shape != rvis.shape or cnt.shape != rcnt.shape:
        return {name: np.inf for name in LIMITS}
    gap = (vis.to(torch.complex128) - rvis).abs()
    auto = gap[autos][..., [0, 3]]
    return {"vis_rel_err": float(_rel(gap, bound).max()),
            "auto_rel_err": float(_rel(auto, power).max()),
            "count_err": float(np.abs(cnt - rcnt).max())}
