"""I/O formats: VDIF, Mark 5B, DADA and GUPPI raw baseband files, HDF5
stream containers (native and reference layouts), PSRFITS (fold and
search mode), SIGPROC filterbank (search-mode) files and multi-file
sequences (counterparts of ``baseband_tasks_tpu/io``).

Readers decode on the host and hand out tensors on their ``device`` (the
card when there is one), or ship their raw payloads as int32 words
(``read_packed``: VDIF, Mark 5B, DADA, GUPPI and bit-packed HDF5) for a
compiled pipeline to decode on the device
(``CompiledPipeline(..., packed=True)``).  ``io.hdf5`` imports ``h5py``
and ``yaml`` only when a file is opened."""

from . import dada
from . import guppi
from . import hdf5
from . import mark5b
from . import psrfits
from . import sequence
from . import sigproc
from . import vdif

__all__ = ["dada", "guppi", "hdf5", "mark5b", "psrfits", "sequence",
           "sigproc", "vdif"]
