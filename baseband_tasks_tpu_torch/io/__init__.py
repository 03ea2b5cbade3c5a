"""I/O formats: VDIF, Mark 5B, DADA and GUPPI raw baseband files, SIGPROC
filterbank (search-mode) files and multi-file sequences (counterparts of
``baseband_tasks_tpu/io``).

Readers decode on the host and hand out tensors on their ``device`` (the
card when there is one), or ship their raw payloads as int32 words
(``read_packed``) for a compiled pipeline to decode on the device
(``CompiledPipeline(..., packed=True)``).  HDF5 and PSRFITS are not
ported yet (ROADMAP.md queue 1 item 8; ``registry.open`` detects them and
raises)."""

from . import dada
from . import guppi
from . import mark5b
from . import sequence
from . import sigproc
from . import vdif

__all__ = ["dada", "guppi", "mark5b", "sequence", "sigproc", "vdif"]
