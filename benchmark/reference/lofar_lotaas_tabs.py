"""Plain reference of the LOFAR LOTAAS tied-array beamformer (numpy and
torch only).

A beamformer written out from its definition, in float64 on the given
device, a chunk of subbands at a time:

- the F stage as the LOFAR correlator's reference defines it
  (``benchmark/reference/lofar_hba_cobalt.py`` ``spectra``): field k
  advanced by its whole samples ``round(d_k)``, the unit's spectra from
  the lead on, each a 16-point FFT (numpy's sign and order,
  unnormalised), channel c turned by exp(2 pi i fftfreq[c] f_k) for the
  fraction ``f_k`` and subband s by exp(2 pi i nu_s d_k / rate sideband);
- TAB b weights field k by exactly w = exp(2 pi i f_cs tau_bk sideband)
  / n_station at the channel's sky frequency f_cs = nu_s + fftfreq[c]
  rate sideband, for the TAB's geometric delay tau_bk;
- the beam B_b = sum_k w X_k of each spectrum, channel, subband and
  polarization; its Stokes I |B_X|^2 + |B_Y|^2; summed over ``n_int``
  spectra a row;
- the count of spectra a row.

The comparison: a Stokes I sum is a sum of |B|^2, and B a sum of
n_station products, so the gap of a sum is taken over E = sum over the
row's spectra and both polarizations of (sum_k |w| |X_k|)^2 <= (1 /
n_station) sum_k |X_k|^2 (Cauchy-Schwarz, |w| = 1 / n_station), which
bounds every TAB's sum and the rounding of each of its terms.

``precision='bfloat16'`` is the control: every intermediate stored in
bfloat16 (the voltages, the spectra, the rotated spectra, the weights,
the beams, their power and the sums).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.plain import bf16
from benchmark.reference.lofar_hba_cobalt import spectra

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: limits of the comparison of each unit's output with the reference.
#: The program forms each beam sample B from 12 complex products of
#: float32 spectra and complex64 weights (unit roundoff u = 2^-24): the
#: weights' rounding (u), the spectra's 16-point FFT (log2 16 = 4 stages)
#: and rotation (2), the products and their sum (n_station + 1 = 13):
#: some 20 roundings, each at most u times sum_k |w| |X_k|, so
#: |dB| <= 20 u sum_k |w| |X_k| at first order, and |d|B|^2| <= 2 |B|
#: |dB| <= 40 u (sum_k |w| |X_k|)^2.  Summed over the row's 12 terms the
#: gap is at most 40 u E, and the float32 sums of the 12 terms (the
#: detection's 4 squares and the row's 6 x 2 terms) add at most 16 u
#: E: 56 u = 3.3e-6 of E in the worst case, independent of the data.
#: Taken with 3x room: 1e-5.  Each TF32 product (10 mantissa bits, u =
#: 2^-11) moves a term by up to 2^-11 of its magnitude, some 100x that
#: bound, and bfloat16 (u = 2^-8) 800x; ``PERF.md`` has the readings.
LIMITS = {"stokes_rel_err": 1e-5, "count_err": 0.0}

#: subbands a chunk of the reference computes at once (float64 beams of
#: 73 TABs: 0.46 GB a subband at the deployment's size)
CHUNK = 4


def _bf16(z):
    """``z`` rounded to bfloat16, in its own precision."""
    return bf16(z).to(z.dtype)


def sky_frequency(cfg, sbs):
    """(n_chan, n_sb) float64 sky frequency of each channel of subbands
    ``sbs``."""
    rate = cfg["subband_khz"] * 1e3
    nu = (cfg["subband0_mhz"] * 1e6
          + np.arange(cfg["n_subband"]) * rate)[sbs]
    return nu[None, :] + (np.fft.fftfreq(cfg["n_chan"]) * rate
                          * cfg["sideband"])[:, None]


def weights(cfg, tau, sbs):
    """(n_tab, n_station, n_chan, n_sb) complex128 TAB weights, exact."""
    f = sky_frequency(cfg, sbs) * cfg["sideband"]
    return (np.exp(2j * np.pi * f[None, None] * tau[:, :, None, None])
            / cfg["n_station"])


def stokes(cfg, a, w, precision):
    """(rows, n_tab, n_chan, n_sb) Stokes I sums of the beams of spectra
    ``a`` (n_station, n_spec, n_chan, n_sb, n_pol) at weights ``w``, and
    (rows, n_chan, n_sb) bases E of the comparison."""
    n_int = cfg["n_int"]
    a = a.to(torch.complex128)
    w = torch.as_tensor(w, device=a.device)
    if precision != "float64":
        w = _bf16(w)
    beams = torch.einsum("bkcs,ktcsp->tbcsp", w, a)
    if precision != "float64":
        beams = _bf16(beams)
    power = beams.real ** 2 + beams.imag ** 2
    if precision != "float64":
        power = _bf16(power)
    n_spec = power.shape[0]
    sums = power.sum(-1).reshape((n_spec // n_int, n_int)
                                 + power.shape[1:-1]).sum(1)
    if precision != "float64":
        sums = _bf16(sums.float()).to(torch.float64)
    base = (a.real ** 2 + a.imag ** 2).sum(dim=(0, -1)) / a.shape[0]
    base = base.reshape((n_spec // n_int, n_int) + base.shape[1:]).sum(1)
    return sums, base


def expected(cfg, traffic, data, keys, device, precision="float64"):
    """{key: (Stokes I sums (rows, n_tab, n_chan, n_subband) float64 on
    ``device``, counts (rows,) int64, the bases E (rows, n_chan,
    n_subband), a cache of the comparisons made)} for units whose key is
    their pool block; ``data`` holds the blocks (``pool``), the delays in
    samples (``delays``), the TABs' delays in s (``tabs``) and the spectra
    before the unit (``lead``)."""
    n_spec = cfg["cobalt_block_samples"] // cfg["n_chan"]
    view = dict(cfg, n_avg=n_spec)
    n_sb = cfg["n_subband"]
    tau = np.asarray(data["tabs"], dtype=np.float64)
    out = {}
    for key in keys:
        x = torch.as_tensor(data["pool"][key]).to(device)
        sums, bases = [], []
        for s0 in range(0, n_sb, CHUNK):
            sbs = slice(s0, min(s0 + CHUNK, n_sb))
            a = spectra(view, x, data["delays"], data["lead"], sbs,
                        precision)
            s, e = stokes(cfg, a, weights(cfg, tau, sbs), precision)
            sums.append(s)
            bases.append(e)
            del a
        rows = n_spec // cfg["n_int"]
        out[key] = (torch.cat(sums, dim=-1),
                    np.full(rows, cfg["n_int"], np.int64),
                    torch.cat(bases, dim=-1), {})
    return out


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compare(out, ref):
    """The numbers compared for one unit: the largest gap of a Stokes I
    sum over its row, channel and subband's base E, and the largest gap
    of a count.  A unit of another shape than the reference's fails
    every number.  The sums' comparison is made once for each buffer
    they lie in (the feed keeps one a pool block, which holds the last
    unit of that block: every unit's counts are compared, the sums of
    the last unit of each pool block)."""
    rsum, rcnt, base, seen = ref
    cnt = _host(out[1])
    if cnt.shape != rcnt.shape or tuple(np.shape(out[0])) != \
            tuple(rsum.shape):
        return {name: np.inf for name in LIMITS}
    buf = (out[0].data_ptr() if torch.is_tensor(out[0])
           else np.asarray(out[0]).ctypes.data)
    if buf not in seen:
        got = torch.as_tensor(_host(out[0])).to(rsum.device)
        gap = (got.to(torch.float64) - rsum).abs() / base[:, None]
        seen[buf] = float(gap.max())
    return {"stokes_rel_err": seen[buf],
            "count_err": float(np.abs(cnt - rcnt).max())}
