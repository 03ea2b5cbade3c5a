"""Phase-binned accumulation (the fold), as a one-hot matmul.

Counterpart of ``baseband_tasks_tpu/ops/fold.py``:
``profile[b, ...] = sum_t onehot[t, b] * power[t, ...] = onehot^T @ power``.
The matmul runs in full float32 (PyTorch's default: TF32 is off for
matmuls unless a caller enables it).
"""

from __future__ import annotations

import torch

__all__ = ["fold_accumulate"]


def fold_accumulate(power, bins, n_phase, *, with_counts=True):
    """Accumulate samples into phase bins.

    Parameters
    ----------
    power : (T, ...) float32 tensor
    bins : (T,) integer tensor of phase-bin indices in [0, n_phase)
    n_phase : int

    Returns
    -------
    profile : (n_phase, ...) float32 sums
    counts : (n_phase,) float32 sample counts (if ``with_counts``)
    """
    T = power.shape[0]
    phases = torch.arange(n_phase, device=bins.device, dtype=bins.dtype)
    onehot = (bins[:, None] == phases[None]).to(power.dtype)
    prof = (onehot.T @ power.reshape(T, -1)).reshape(
        (n_phase,) + tuple(power.shape[1:]))
    if not with_counts:
        return prof
    return prof, onehot.sum(dim=0, dtype=torch.float32)
