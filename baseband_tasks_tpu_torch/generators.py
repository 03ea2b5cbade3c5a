"""Source-node stream generators.

Counterparts of ``baseband_tasks_tpu/generators.py``: ``StreamGenerator``
(user frame function), ``EmptyStreamGenerator`` (blank frames) and
``NoiseGenerator`` (reproducible Gaussian noise).  Every source takes the
torch ``device`` its frames live on.

Noise is random-access: the frame at sample offset ``o`` is drawn from a
``torch.Generator`` on the stream's device seeded from (seed, o), so any
frame can be regenerated, in any order, with the same values.  It is not
the JAX package's threefry stream (torch cannot reproduce that), so
comparisons between the two packages feed both the same numpy data
through :class:`StreamGenerator`.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Base
from .utils.dtypes import as_tensor, torch_dtype

__all__ = ["StreamGenerator", "EmptyStreamGenerator", "Noise",
           "NoiseGenerator"]


class StreamGenerator(Base):
    """Stream whose frames are produced by a user function.

    The function is called with the handle itself (positioned at the frame
    start, so ``tell()``/``time`` give the frame location) and must return
    an array of ``(samples_per_frame,) + sample_shape``; a numpy result
    moves to the stream's ``device`` (by default the card when there is
    one, else the CPU; see :class:`~.base.Base`).
    """

    def __init__(self, function, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64,
                 frequency=None, sideband=None, polarization=None,
                 device=None):
        super().__init__(shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization, device=device)
        self._function = function

    def _read_frame(self, frame_index):
        old_offset = self._offset
        try:
            self._offset = frame_index * self._samples_per_frame
            data = self._function(self)
        finally:
            self._offset = old_offset
        n = min(self._samples_per_frame,
                self._shape[0] - frame_index * self._samples_per_frame)
        if len(data) < n:
            # a short frame would silently misalign every later sample
            raise ValueError(
                f"generator function returned {len(data)} samples for "
                f"frame {frame_index}; expected at least {n}")
        return as_tensor(data[:n], device=self._device)


class EmptyStreamGenerator(Base):
    """Stream of blank (zero) frames, to be filled by a downstream Task."""

    def _read_frame(self, frame_index):
        n = min(self._samples_per_frame,
                self._shape[0] - frame_index * self._samples_per_frame)
        return torch.zeros((n,) + self.sample_shape,
                           dtype=torch_dtype(self._dtype),
                           device=self._device)


class Noise:
    """Reproducible random-access Gaussian noise generator.

    Callable with a stream handle; draws the frame at the handle's current
    offset from a ``torch.Generator`` on the handle's device seeded from
    (``seed``, offset), so regenerating any frame gives identical values
    regardless of read order.  Complex noise has unit variance per
    component.
    """

    def __init__(self, seed=None, dtype=np.complex64):
        self._seed = 0 if seed is None else int(seed)
        self._dtype = np.dtype(dtype)

    def _frame_seed(self, offset):
        """The 63-bit generator seed of the frame at sample ``offset``."""
        state = np.random.SeedSequence([self._seed, int(offset)])
        return int(state.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)

    def __call__(self, sh):
        offset = sh.tell()
        n = min(sh.samples_per_frame, sh.shape[0] - offset)
        shape = (n,) + tuple(sh.sample_shape)
        device = getattr(sh, "device", torch.device("cpu"))
        gen = torch.Generator(device=device)
        gen.manual_seed(self._frame_seed(offset))
        complex_out = self._dtype.kind == "c"
        real = torch_dtype(self._dtype.type(0).real.dtype)
        draw = torch.randn(shape + ((2,) if complex_out else ()),
                           generator=gen, dtype=real, device=device)
        return torch.view_as_complex(draw) if complex_out else draw


class NoiseGenerator(StreamGenerator):
    """Stream of Gaussian noise (complex: unit variance per component).

    ``seed`` gives reproducibility; frames are independent of read order.

    Examples
    --------
    >>> import numpy as np
    >>> from baseband_tasks_tpu_torch import NoiseGenerator
    >>> from baseband_tasks_tpu_torch.utils import Time, units as u
    >>> ng = NoiseGenerator(shape=(1000,),
    ...                     start_time=Time("2020-01-01T00:00:00.0"),
    ...                     sample_rate=1 * u.kHz, samples_per_frame=100,
    ...                     seed=4)
    >>> tail = ng.read(1000)[-100:]
    >>> _ = ng.seek(900)        # random access: same samples come back
    >>> bool((ng.read(100) == tail).all())
    True
    """

    def __init__(self, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64, seed=None,
                 frequency=None, sideband=None, polarization=None,
                 device=None):
        noise = Noise(seed, dtype=dtype)
        super().__init__(noise, shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization, device=device)
