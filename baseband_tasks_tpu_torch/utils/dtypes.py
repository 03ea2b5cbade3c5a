"""numpy <-> torch dtype and array helpers.

Stream metadata keeps numpy dtypes (so it compares equal to the JAX
package's); the data itself is torch tensors.  These helpers translate
between the two.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_dtype", "numpy_dtype", "as_tensor", "to_numpy"]

_PAIRS = [(np.bool_, torch.bool), (np.int8, torch.int8),
          (np.uint8, torch.uint8), (np.int16, torch.int16),
          (np.int32, torch.int32), (np.int64, torch.int64),
          (np.float16, torch.float16), (np.float32, torch.float32),
          (np.float64, torch.float64), (np.complex64, torch.complex64),
          (np.complex128, torch.complex128)]
_TO_TORCH = {np.dtype(n): t for n, t in _PAIRS}
_TO_NUMPY = {t: np.dtype(n) for n, t in _PAIRS}


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype (or of a torch dtype: itself)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TO_TORCH[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"no torch dtype for {np.dtype(dtype)}") from None


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (or of anything numpy reads)."""
    if isinstance(dtype, torch.dtype):
        return _TO_NUMPY[dtype]
    return np.dtype(dtype)


def as_tensor(data, device=None, dtype=None):
    """``data`` as a tensor on ``device`` (numpy arrays are copied over;
    a tensor already there, of that dtype, is returned as is)."""
    return torch.as_tensor(data, device=device,
                           dtype=None if dtype is None
                           else torch_dtype(dtype))


def default_device(device=None):
    """``device`` as a torch device; None means the card when there is
    one, else the CPU (the port's rule for entry points)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def to_numpy(data):
    """A host numpy array of a tensor (or of anything numpy reads)."""
    if torch.is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)
