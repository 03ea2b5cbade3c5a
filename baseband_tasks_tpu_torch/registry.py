"""Format registry and top-level ``open``.

Counterpart of ``baseband_tasks_tpu/registry.py``:
``baseband_tasks_tpu_torch.open(file, mode, format=...)`` with
auto-detection from the file's signature (and name), and the plugin hook:
third-party packages can register more formats under the
``baseband_tasks_tpu_torch.io`` entry-point group (a module or object with
``open(name, mode, **kw)`` and optionally ``detect_format(head, name) ->
bool``), picked up lazily on first use.

VDIF, Mark 5B, DADA, GUPPI and SIGPROC are ported (``io/``); HDF5 and
PSRFITS files are detected as in the JAX package, and opening one raises
``NotImplementedError`` (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import builtins

__all__ = ["open", "detect_format", "FORMATS"]

_NOT_PORTED = ("{} files are not ported yet (ROADMAP.md, queue 1 item 8: "
               "I/O, {})")


def _not_ported(fmt, module):
    def opener(name, mode="r", **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(fmt, module))
    return opener


def _vdif_open(name, mode="r", **kwargs):
    from .io import vdif
    return vdif.open(name, mode, **kwargs)


def _guppi_open(name, mode="r", **kwargs):
    from .io import guppi
    return guppi.open(name, mode, **kwargs)


def _guppi_detect(head, name):
    if head[:6] == b"SIMPLE":
        return False                      # FITS/PSRFITS
    if name.lower().endswith((".raw", ".guppi")):
        return True
    # 80-char cards with '=' at column 8 and a known GUPPI keyword
    return head[8:9] == b"=" and head[:8].strip().isalpha() and \
        any(k in head for k in (b"BLOCSIZE", b"OBSNCHAN", b"PKTIDX"))


def _mark5b_open(name, mode="r", **kwargs):
    from .io import mark5b
    return mark5b.open(name, mode, **kwargs)


def _mark5b_detect(head, name):
    return head[:4] == b"\xed\xde\xad\xab" or \
        name.lower().endswith(".m5b")


def _dada_open(name, mode="r", **kwargs):
    from .io import dada
    return dada.open(name, mode, **kwargs)


def _dada_detect(head, name):
    return head[:9] in (b"HDR_VERSI", b"HDR_SIZE ") or \
        name.lower().endswith(".dada")


def _sigproc_open(name, mode="r", **kwargs):
    from .io import sigproc
    return sigproc.open(name, mode, **kwargs)


def _sigproc_detect(head, name):
    from .io import sigproc
    return sigproc.detect_format(head, name)


#: name -> (opener, detector), in detection order
FORMATS = {
    "hdf5": (_not_ported("HDF5", "io/hdf5/"), lambda head, name:
             head[:8] == b"\x89HDF\r\n\x1a\n"),
    "psrfits": (_not_ported("PSRFITS", "io/psrfits/"), lambda head, name:
                head[:6] == b"SIMPLE"),
    "vdif": (_vdif_open, lambda head, name:
             name.lower().endswith((".vdif", ".vdf"))),
    "mark5b": (_mark5b_open, _mark5b_detect),
    "dada": (_dada_open, _dada_detect),
    "guppi": (_guppi_open, _guppi_detect),
    "sigproc": (_sigproc_open, _sigproc_detect),
}


_entry_points_loaded = False


def _load_entry_points():
    """Merge third-party formats from the ``baseband_tasks_tpu_torch.io``
    entry-point group into ``FORMATS``.  Built-in names cannot be
    overridden; a plugin without ``detect_format`` is only reachable via
    an explicit ``format=`` (or its name as a file suffix)."""
    global _entry_points_loaded
    if _entry_points_loaded:
        return
    _entry_points_loaded = True
    try:
        from importlib.metadata import entry_points
        eps = entry_points(group="baseband_tasks_tpu_torch.io")
    except Exception:  # metadata unavailable -- plugins simply absent
        return
    for ep in eps:
        if ep.name in FORMATS:
            continue
        try:
            obj = ep.load()
        except Exception:
            continue
        opener = getattr(obj, "open", obj)
        detect = getattr(obj, "detect_format", None)
        if detect is None:
            def detect(head, name, _suffix="." + ep.name):
                return str(name).lower().endswith(_suffix)
        FORMATS[ep.name] = (opener, detect)


def detect_format(name):
    """Detect the format of a file from its signature (and name)."""
    _load_entry_points()
    with builtins.open(name, "rb") as fh:
        head = fh.read(512)
    for fmt, (opener, detect) in FORMATS.items():
        try:
            matched = detect(head, str(name))
        except Exception:  # a broken (plugin) detector must not
            continue       # disable detection of later formats
        if matched:
            return fmt
    raise ValueError(f"could not detect format of {name}")


def open(name, mode="r", format=None, **kwargs):
    """Open a stream file in any registered format.

    ``format`` may be 'vdif', 'mark5b', 'dada', 'guppi', 'sigproc' or
    any plugin-registered name ('hdf5' and 'psrfits' raise
    ``NotImplementedError``); when omitted it is detected from the file
    signature (reads) or required (writes).  Readers take ``device=``
    (default: the card when there is one).

    ``name`` may also denote a multi-file sequence -- a list/tuple of
    names, a glob pattern, a ``{file_nr}`` template string, or a
    ``FileNameSequencer`` -- which opens as a single spliced stream
    (reading) or a file-splitting writer (writing; also needs
    ``template=`` and ``samples_per_file=``).
    """
    _load_entry_points()
    from .io import sequence
    if sequence.is_sequence(name):
        if format is not None:
            kwargs["format"] = format
        return sequence.open(name, mode, **kwargs)
    if format is None:
        if "w" in mode:
            raise ValueError("writing requires an explicit format=")
        format = detect_format(name)
    try:
        opener = FORMATS[format][0]
    except KeyError:
        raise ValueError(f"unknown format {format!r}; "
                         f"known: {sorted(FORMATS)}") from None
    return opener(name, mode, **kwargs)
