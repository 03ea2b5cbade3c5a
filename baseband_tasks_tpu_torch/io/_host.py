"""Stream heads over files: frames decoded on the host.

The JAX package's readers return numpy frames and leave the transfer to
their consumers.  Here a reader decodes a frame on the host
(``_read_frame_host``, numpy) and ``read()`` hands out tensors on the
stream's ``device`` (the card when there is one, unless the caller asks
for the CPU), as every source of the port does.  :meth:`read_host` gives
the same host samples without a device, for a consumer that ships them
itself (``models/runner.StreamRunner``: pinned buffers and a copy
stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import Base

__all__ = ["FileReader"]


class FileReader(Base):
    """A stream head whose frames are decoded on the host.

    Subclasses implement ``_read_frame_host(frame_index)`` returning a
    numpy array of ``(n,) + sample_shape`` (``n`` the frame's samples);
    ``close()`` closes the file handle ``_fh`` (or whatever
    ``_close_file`` releases).
    """

    def _read_frame(self, frame_index):
        frame = np.ascontiguousarray(self._read_frame_host(frame_index))
        return torch.from_numpy(frame).to(self._device)

    def read_host(self, offset, count):
        """Host-decoded samples ``[offset, offset + count)`` as one numpy
        array, the values ``read()`` gives; the stream pointer and the
        frame cache are left alone."""
        if self._closed:
            raise ValueError("I/O operation on closed stream.")
        if offset < 0:
            raise OSError("cannot read from before the start of input.")
        if offset + count > self._shape[0]:
            raise EOFError("cannot read from beyond end of input.")
        if count <= 0:
            return np.zeros((0,) + self.sample_shape, self._dtype)
        spf = self._samples_per_frame
        f0, first = divmod(offset, spf)
        f1 = -(-(offset + count) // spf)
        return self._read_frames_host(f0, f1 - f0)[first:first + count]

    def _read_frames_host(self, f0, n_frames):
        """Frames ``[f0, f0 + n_frames)`` decoded on the host, joined
        (readers that can decode a span at once override this)."""
        frames = [self._read_frame_host(f) for f in range(f0, f0 + n_frames)]
        return frames[0] if n_frames == 1 else np.concatenate(frames)

    def close(self):
        super().close()
        self._close_file()

    def _close_file(self):
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()
            self._fh = None
