"""Time variants of the register-FFT kernels, accel_corr (``csrc/
accel.cu``), the K3 detect-fold, K2 and K1 (``csrc/dedisperse.cu``) and
the resident dedisperse -> fold (``csrc/resident.cu``), and of the
forward PFB (``csrc/pfb.cu``), on one CUDA card, at the main paths'
shapes.

Each variant is the checkout's own source with the kernel's constants
line replaced:

- accel_corr (``kCorrThreads``, ``kCorrLanes``, ``kCorrMode``,
  ``kCorrNext``): threads a block, lanes a tile (the power rows staged
  for lane-fastest stores), mode 0 (the kernel), 1 (no FFT: the loads,
  the products and the stores alone) or 2 (the FFT without the trim and
  the stores), and whether the next lane's bank is loaded into registers
  during this lane's FFT (1) or after it (0);
- K3 (``kFoldLanes``, ``kFoldStages``, ``kFoldMode``, ``kFoldRuns``):
  the widest lane tile, one stage buffer or two (the next column's copies
  in flight during this column's FFT and fold, or issued after it), mode
  0 (the kernel), 1 (no FFT: the staged loads and the fold) or 2 (the FFT
  without the fold), and whether each register slot sums its run of
  equal bins over the block's columns before one shared-memory atomic
  (1) or adds every value with its own atomic (0);
- K3's two forms (``kGatherLanes``, ``kGatherItems``, ``kGatherStages``,
  ``kGatherRows``, ``kFoldGather``): the gather form's widest lane tile,
  (lane, row group) items a thread, stage buffers and rows a phase-2
  thread loads at once, and the form every shape takes: 0 the form by
  shape (the runs form where its 8-lane tile holds its shared partials),
  1 the gather form; timed at 64 to 8192 bins, power and Stokes, on the
  GUPPI node's window (N1 = N2 = 512, L = 128, pads 32768/28672, ~2434
  samples a period), the knobs at the node's 2048 Stokes bins and at
  4096 power bins; with ``--old`` the other checkout's K3 at every bin
  count too (before the gather form: the runs form, on narrower tiles or
  global atomics where the 8-lane tile's partials do not fit);
- K2 (``kK2Lanes``, ``kK2Stages``, ``kK2Items``, ``kK2Chirp``,
  ``kK2Mode``): the widest lane tile, the stage buffers, the (lane, row
  group) items a thread, the chirp staged with the planes where the
  buffers hold it, else float32 k2's read into registers (0), float32
  k2's always into registers (1) or always staged (2; the other forms
  stage theirs), and mode 0 (the kernel), 1 (no FFT: the staged loads,
  the chirp and twiddle products and the stores) or 2 (the FFTs without
  the stores);
- resident (``kResTile2048``, ``kResStages2048``, ... ``kResStages4096S``,
  ``kResChirpRegs4096S``; ``kResStages``, ``kResMode``, ``kResRuns``,
  ``kResChirp``): the lane tile and stage buffers of each compiled case
  (N 2048 power and Stokes, 4096 power and Stokes), the chirp slots a
  thread of the 4096-row Stokes case holds in registers (the rest in
  shared memory), the general instantiation's stage buffers, mode
  0, 1 (no FFT) or 2 (no fold), runs of equal bins summed (1) or an
  atomic a value (0), and the chirp held in registers for the block's
  life (1) or read from L2 every window (0);
- K1 (``kK1Lanes``, ``kK1Stages``, ``kK1Vec``, ``kK1Mode``): the widest
  lane tile, the stage buffers, the neighbouring lanes a thread holds
  (1: two single-lane items, 4-byte stores; 2 or 4: 8- or 16-byte
  stores), and mode 0 (the kernel), 1 (no FFT), 2 (no stores) or 3 (the
  staged loads and the decode alone);
- the forward PFB (``kFirRows``, ``kFirUnroll``, ``kFirThreads``;
  ``kPfbBN``, ``kPfbStages``, ``kPfbPeriod``, ``kPfbMode``): the FIR's
  output rows a thread, rows a step and threads a block; the fused DFT's
  column tile, ring stages, promotion period and mode 0 (the kernel), 1
  (the raw window rows as the A tile: no tap sum), 2 (no A tile
  written) or 3 (the mixer staged alone).

With ``--old DIR`` the sources of another checkout's ``csrc`` (the
kernels before the redesign) are built and timed too; its K1 also with
one phase cut at a time (the FFT, the twiddle, the stores, all but the
loads), as it was before any redesign.  ``--only`` picks
the kernels (default all).  The variants are built in parallel into
``build/fft_sweep/``, their ``-Xptxas -v`` register and spill lines and
the shared-memory atomic instructions of their SASS printed, each
variant of mode 0 held against the plain version (accel_corr and K2
float32 planes within 1e-4 of the peak, bf16 planes within one bf16 ulp
plus 1e-6 of it; K3 and resident counts exact, the power plane within
rtol 2e-4, the Stokes cross planes within 1e-4 of their peak), and timed
with CUDA events: accel_corr at 547 segments of 4096 with 3840 valid lags
for 65 and 128 lanes; K3 and K2 at N1 = N2 = 512, L = 128 (K3 with 64
phase bins, power and Stokes, float32 and bf16; K2 in its four launch
forms, and k2 at the compiled PFB chains' N2 = 256, N1 = 128, L = 512);
resident on a 261,120-row, 128-lane block at windows 2048 and
4096, pads 256/256, 64 phase bins, power and Stokes; K1 at the
flagship's window (N1 = N2 = 512, L = 128, pads 3584/4608: 8-bit
packed, float32, both with bf16 planes out, the plain window) and
config 3's and config 2's k1_stream, planes within 1e-4 of the peak
(bf16 one ulp); the PFB at config 3's 32256 x 512, 8 taps, within 1e-4
of the peak, beside the FIR then lane_mix and one complex ``matmul`` of
the tap sums by F; each beside its bound.  The first of each list is
the kernel as the package builds it.

    python -m baseband_tasks_tpu_torch.tools.fft_sweep [--reps N] \
        [--old DIR] [--only corr,fold,forms,k2,resident,k1,pfb]

Prints one line per measurement and ends with a JSON object of them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dedisperse as dd
from ..ops import dedisperse_resident as dr
from ..ops.accel_correlate import accel_correlate_bank_ref

SWEEP_DIR = _build.BUILD_DIR.parent / "fft_sweep"
HBM_BYTES_PER_S = 3.35e12      # the H100 SXM data sheet's HBM rate
FP32_FLOPS = 67e12             # its FP32 rate outside the tensor cores

CORR_RE = (r"constexpr int kCorrThreads = \d+, kCorrLanes = \d+, "
           r"kCorrMode = \d+, kCorrNext = \d+;")
FOLD_RE = (r"constexpr int kFoldLanes = \d+, kFoldStages = \d+, "
           r"kFoldMode = \d+, kFoldRuns = \d+;")
K2_RE = r"constexpr int kK2Lanes = [^;]*;"
GATHER_RE = r"constexpr int kGatherLanes = [^;]*;"
GATHER_KNOBS = ("kGatherLanes", "kGatherItems", "kGatherStages",
                "kGatherRows", "kFoldGather")
# (lanes, items, stages, rows, gather): gather 0 the form by shape, 1 the
# gather form everywhere; the first two are timed at every bin count
FORM_VARIANTS = [(16, 2, 2, 8, 0), (16, 2, 2, 8, 1), (8, 2, 2, 8, 1),
                 (16, 1, 2, 8, 1), (16, 2, 1, 8, 1), (16, 2, 2, 4, 1),
                 (16, 2, 2, 16, 1)]
FORM_BINS = (64, 256, 1024, 2048, 4096, 8192)
# the GUPPI node's window and rate (B1937+21 at 1.5625 MHz)
FORM_PADS, FORM_RATE = (32768, 28672), 1.0 / 2434.07
RES_RE = (r"constexpr int kResTile2048 = [^;]*;\n"
          r"constexpr int kResStages = [^;]*;")
K2_KNOBS = ("kK2Lanes", "kK2Stages", "kK2Items", "kK2Chirp", "kK2Mode")
K1_RE = r"constexpr int kK1Lanes = [^;]*;"
K1_KNOBS = ("kK1Lanes", "kK1Stages", "kK1Vec", "kK1Mode")
# (lanes, stages, lanes a thread, mode): mode 0 the kernel, 1 no FFT, 2 no
# stores, 3 the staged loads alone
K1_VARIANTS = [(16, 2, 1, 0), (16, 2, 2, 0), (16, 2, 4, 0), (16, 3, 1, 0),
               (8, 2, 1, 0), (16, 2, 1, 1), (16, 2, 1, 2), (16, 2, 1, 3)]
# the parent's shared-memory K1 (the kernel before the redesign, from
# --old) with its phases cut one at a time
K1_OLD_MODES = ("kernel", "no FFT", "no twiddle", "no stores", "loads only")
FIR_RE = r"constexpr int kFirRows = [^;]*;"
FIR_KNOBS = ("kFirRows", "kFirUnroll", "kFirThreads")
PFB_RE = r"constexpr int kPfbBN = [^;]*;"
PFB_KNOBS = ("kPfbBN", "kPfbStages", "kPfbPeriod", "kPfbMode")
# ((FIR rows a thread, rows a step, threads), (DFT tile columns, stages,
# promotion period, mode 0 the kernel or 1 no tap sum))
PFB_VARIANTS = [((128, 4, 128), (128, 6, 2, 0)),
                ((64, 4, 128), (128, 5, 2, 0)),
                ((128, 4, 64), (128, 6, 1, 0)),
                ((128, 2, 128), (128, 6, 2, 1)),
                ((128, 4, 128), (128, 6, 2, 2)),
                ((128, 4, 128), (128, 6, 2, 3))]
RES_KNOBS = (("kResTile2048", "kResStages2048", "kResTile2048S",
              "kResStages2048S", "kResTile4096", "kResStages4096",
              "kResTile4096S", "kResStages4096S", "kResChirpRegs4096S"),
             ("kResStages", "kResMode", "kResRuns", "kResChirp"))
# (lanes, stages, items, chirp, mode): chirp 0 staged where it fits, else
# float32 k2's into registers; 1 float32 k2's always into registers; 2
# always staged
K2_VARIANTS = [(16, 2, 2, 0, 0), (16, 2, 2, 1, 0), (16, 2, 2, 2, 0),
               (16, 1, 2, 0, 0), (8, 2, 2, 0, 0), (8, 2, 1, 0, 0),
               (16, 2, 2, 0, 1), (16, 2, 2, 0, 2)]
# ((tile, stages) of 2048 power, 2048 Stokes, 4096 power, 4096 Stokes,
# chirp slots in registers at 4096 Stokes), (general stages, mode, runs,
# chirp in registers)
_RES = (4, 2, 4, 1, 2, 1, 2, 1, 8)
RES_VARIANTS = [(_RES, (2, 0, 1, 1)),
                ((4, 2, 4, 1, 2, 1, 2, 1, 16), (2, 0, 1, 1)),
                ((4, 2, 4, 2, 2, 2, 1, 2, 8), (2, 0, 1, 1)),
                ((4, 1, 4, 1, 2, 1, 1, 1, 8), (2, 0, 1, 1)),
                ((2, 1, 2, 1, 1, 1, 1, 1, 8), (2, 0, 1, 1)),
                (_RES, (2, 0, 0, 1)), (_RES, (2, 0, 1, 0)),
                (_RES, (2, 1, 1, 1)), (_RES, (2, 2, 1, 1))]


def knob_lines(names, values):
    """``constexpr int a = 1, b = 2;`` for the names and values."""
    return ("constexpr int "
            + ", ".join(f"{k} = {v}" for k, v in zip(names, values)) + ";")


# (threads, lanes, mode, next)
CORR_VARIANTS = [(512, 8, 0, 1), (512, 8, 0, 0), (256, 4, 0, 1),
                 (256, 4, 0, 0), (512, 8, 1, 1), (512, 8, 2, 1)]
# (lanes, stages, mode, runs)
FOLD_VARIANTS = [(8, 2, 0, 1), (8, 1, 0, 1), (8, 3, 0, 1), (8, 2, 0, 0),
                 (4, 2, 0, 1), (16, 2, 0, 1), (8, 2, 1, 1), (8, 2, 2, 1)]
# the search's path: 2^22 samples, seg_len 4096, 547 segments, 3840 lags
N_SEG, SEG_LEN, VALID = 547, 4096, 3840
# the flagship's window: N = 2^18 as 512 x 512, L = 128, pads 3584/4608
N1 = N2 = 512
L = 128
N_PHASE, PAD_START, N_VALID = 64, 3584, (1 << 18) - 3584 - 4608
# K2 at the paths' shapes: the flagship's planes in the four launch forms,
# and the compiled PFB chains' (config 3: 2^15-row windows, 512 lanes)
K2_SHAPES = [(N2, N1, L, ("k2", "k2_bf16", "k2_bf16_chirp", "k2_theta")),
             (256, 128, 512, ("k2",))]
# the resident path (chip_smoke.py phase (k), tools/bench_resident.py's
# block): 261,120 rows cut to whole hops, 128 lanes, pads 256/256
RES_T, RES_PAD, RES_WINDOWS = 261120, 256, (2048, 4096)
RES_RATE = 1.0 / 1607.3
# cycles per sample: the flagship's B1937-like pulsar (641.93 Hz) at the
# channel rate of 250 kHz, ~389 samples a turn (chip_smoke.py's polyco)
FOLD_RATE = 641.928123 / 250e3


def corr_label(v):
    mode = ("", " no FFT", " no trim")[v[2]]
    return (f"{v[0]} threads, {v[1]} lanes a tile, next lane "
            f"{'staged' if v[3] else 'after'}{mode}")


def form_label(v):
    if v == "old":
        return "old kernel"
    if v[4] == 0:
        return "form by shape"
    return (f"gather form, tile {v[0]} lanes, {v[1]} item(s) a thread, "
            f"{v[2]} stage buffer(s), {v[3]} rows in flight")


def fold_label(v):
    mode = ("", " no FFT", " no fold")[v[2]]
    return (f"tile {v[0]} lanes, {v[1]} stage buffer(s), "
            f"{'runs summed' if v[3] else 'an atomic a value'}{mode}")


def k2_label(v):
    mode = ("", " no FFT", " no stores")[v[4]]
    chirp = ("chirp staged where it fits", "k2's chirp to registers",
             "chirp staged")[v[3]]
    return (f"tile {v[0]} lanes, {v[1]} stage buffer(s), {v[2]} item(s) a "
            f"thread, {chirp}{mode}")


def k1_label(v):
    mode = ("", " no FFT", " no stores", " loads only")[v[3]]
    return (f"tile {v[0]} lanes, {v[1]} stage buffer(s), {v[2]} lane(s) "
            f"a thread{mode}")


def patch_old_k1(src, mode):
    """The parent's dedisperse.cu with one phase of its shared-memory
    ``k1_kernel`` cut (``K1_OLD_MODES``); what a cut phase computed is
    summed into a value stored only when it is -1, so the compiler keeps
    the work that remains."""
    if mode == "kernel":
        return src
    head, rest = src.split("k1_kernel(const float*", 1)
    body, tail = rest.split("// K2: replaces", 1)

    def sub(old, new):
        nonlocal body
        if body.count(old) != 1:
            raise RuntimeError(f"parent k1_kernel: no single {old!r}")
        body = body.replace(old, new)

    fft = "  fft_dif<false>(x, tw, log_n1, log_tl);\n"
    stores = ("    store_lanes<V>(yr, o, re);\n"
              "    store_lanes<V>(yi, o, im);\n  }\n}")
    if mode == "no FFT":
        sub(fft, "")
    elif mode == "no twiddle":
        sub("    sincospif(-2.0f * static_cast<float>(k * b) / nf, &sn, &cs);",
            "    sn = 0.0f;\n    cs = 1.0f + 0.0f * static_cast<float>(k * b) / nf;")
    elif mode == "no stores":
        sub(fft, fft + "  float keep = 0.0f;\n")
        sub(stores, "    keep += re[0] + im[0];\n  }\n"
            "  const float kk[1] = {keep};\n"
            "  if (keep == -1.0f) store_lanes<1>(yr, 0, kk);\n}")
    elif mode == "loads only":
        sub(fft, "  {\n    const float kk[1] = {x[threadIdx.x].x + "
            "x[threadIdx.x].y};\n    if (kk[0] == -1.0f) "
            "store_lanes<1>(yr, 0, kk);\n    return;\n  }\n")
    return head + "k1_kernel(const float*" + body + "// K2: replaces" + tail


def pfb_label(v):
    (rows, unroll, threads), (bn, stages, period, mode) = v
    return (f"FIR {rows} rows a thread, {unroll} a step, {threads} threads; "
            f"DFT {bn} columns, {stages} stages, promoted every {period}"
            f"{('', ' no tap sum', ' no A tile', ' B alone')[mode]}")


def res_label(v):
    (t2, s2, t2s, s2s, t4, s4, t4s, s4s, cr), (_, mode, runs, chirp) = v
    return (f"tile/stages {t2}/{s2} {t2s}/{s2s} {t4}/{s4} {t4s}/{s4s} "
            f"({cr} chirp registers), "
            f"{'runs summed' if runs else 'an atomic a value'}, chirp "
            f"{'in registers' if chirp else 'from L2'}"
            f"{('', ' no FFT', ' no fold')[mode]}")


def build_one(name, unit_src, headers_dir, pattern, line, text=None):
    d = SWEEP_DIR / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for h in headers_dir.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    src = unit_src.read_text() if text is None else text
    if pattern is not None:
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"{unit_src.name}: no single line to vary")
        src = re.sub(pattern, line, src)
    (d / unit_src.name).write_text(src)
    so = d / "lib.so"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(d / unit_src.name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return so, proc


def ptxas_lines(out, kernel):
    """The register and spill lines of the entries of ``kernel`` (a name
    or a tuple of names)."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    lines, keep = [], False
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in names if k in ln), None)
            keep = name is not None
            if keep:      # the instantiation's template arguments
                lines.append(name + ln.split(name)[-1].split("EEv")[0] + "E")
        elif keep and ("registers" in ln or "spill" in ln):
            lines.append(ln.split("ptxas info    :")[-1].strip())
    return lines


def atomics(so, kernel):
    """The shared-memory atomic instructions in the SASS of ``kernel``'s
    entries, by opcode (a float add to shared memory is a CAS loop)."""
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(so)], capture_output=True, text=True, check=True).stdout
    names = (kernel,) if isinstance(kernel, str) else kernel
    ops = {}
    for fn in sass.split("Function : ")[1:]:
        if not any(k in fn.split()[0] for k in names):
            continue
        for m in re.finditer(r"\b(ATOMS\.\S+)", fn):
            op = m.group(1).rstrip(";")
            ops[op] = ops.get(op, 0) + 1
    return [f"SASS shared atomics: {ops}"] if ops else []


# the entry points whose arguments a redesign changed, as they were
_OLD_SIGNATURES = {"bbt_accel_corr": [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_int, ctypes.c_void_p],
                   "bbt_pfb_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_void_p]}


def old_pfb(lib):
    """Whether ``lib``'s forward PFB takes the DFT planes (fr, fi) raw,
    as before the tensor-core DFT (which reports a staged tile)."""
    return not hasattr(lib, "bbt_pfb_fwd_tile")


def load(so, old=False):
    lib = ctypes.CDLL(str(so))
    sigs = dict(_build._SIGNATURES)
    if old:
        sigs.update({k: v for k, v in _OLD_SIGNATURES.items()
                     if k != "bbt_pfb_fwd" or old_pfb(lib)})
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _build._RESTYPES.get(name, ctypes.c_int)
    if not hasattr(lib, "bbt_k3_scratch"):    # K3 before its scratch
        for name in ("bbt_k3_fold", "bbt_k3_fold_stokes", "bbt_k3_fold_bf16",
                     "bbt_k3_fold_stokes_bf16"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = (
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_int, ctypes.c_void_p])
    return lib


def k3_call(lib, form, dev, z, fold, prof, cnt, n_phase, pad_start,
            n_valid):
    """A launch of K3 ``form`` (k3_fold, k3_fold_stokes, their _bf16
    twins) from ``lib``, with the scratch its shape needs (none before K3
    took one), as a function of no arguments."""
    n2, n1, lanes = z[0].shape
    fn = getattr(lib, f"bbt_{form}")
    head = (z[0].data_ptr(), z[1].data_ptr(), fold.data_ptr(),
            prof.data_ptr(), cnt.data_ptr())
    if hasattr(lib, "bbt_k3_scratch"):
        nbytes = lib.bbt_k3_scratch(n1, n2, lanes, n_phase,
                                    dd._K3_KINDS[form])
        scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
                   if nbytes else None)
        head += (None if scratch is None else scratch.data_ptr(),)
    else:
        scratch = None
    return lambda: (scratch, call(fn, dev, *head, n1, n2, lanes, n_phase,
                                  pad_start, n_valid))


def build_variants(old, only):
    """{key: (library, ptxas lines)}: key (kind, v) for kind 'corr',
    'fold', 'k2', 'res', or (kind, 'old') for ``old``'s sources."""
    csrc = _build.CSRC
    jobs = []
    for v in CORR_VARIANTS if "corr" in only else ():
        line = (f"constexpr int kCorrThreads = {v[0]}, kCorrLanes = {v[1]}, "
                f"kCorrMode = {v[2]}, kCorrNext = {v[3]};")
        jobs.append((("corr", v), "accel_corr",
                     build_one(f"accel_{'_'.join(map(str, v))}",
                               csrc / "accel.cu", csrc, CORR_RE, line)))
    for v in FOLD_VARIANTS if "fold" in only else ():
        line = (f"constexpr int kFoldLanes = {v[0]}, kFoldStages = {v[1]}, "
                f"kFoldMode = {v[2]}, kFoldRuns = {v[3]};")
        jobs.append((("fold", v), "k3_fold",
                     build_one(f"dedisperse_{'_'.join(map(str, v))}",
                               csrc / "dedisperse.cu", csrc, FOLD_RE, line)))
    for v in FORM_VARIANTS if "forms" in only else ():
        jobs.append((("forms", v), "k3_fold",
                     build_one(f"forms_{'_'.join(map(str, v))}",
                               csrc / "dedisperse.cu", csrc, GATHER_RE,
                               knob_lines(GATHER_KNOBS, v))))
    for v in K2_VARIANTS if "k2" in only else ():
        jobs.append((("k2", v), "k2_reg",
                     build_one(f"k2_{'_'.join(map(str, v))}",
                               csrc / "dedisperse.cu", csrc, K2_RE,
                               knob_lines(K2_KNOBS, v))))
    for v in RES_VARIANTS if "resident" in only else ():
        lines = "\n".join(knob_lines(k, x) for k, x in zip(RES_KNOBS, v))
        jobs.append((("res", v), "resident_reg",
                     build_one("resident_" + "_".join(map(str, v[0] + v[1])),
                               csrc / "resident.cu", csrc, RES_RE, lines)))
    if "k1" in only and re.search(K1_RE, (csrc / "dedisperse.cu")
                                  .read_text()):
        for v in K1_VARIANTS:
            jobs.append((("k1", v), "k1_reg",
                         build_one(f"k1_{'_'.join(map(str, v))}",
                                   csrc / "dedisperse.cu", csrc, K1_RE,
                                   knob_lines(K1_KNOBS, v))))
    if old is not None and "k1" in only:
        old_src = (Path(old) / "dedisperse.cu").read_text()
        # phases are cut from the shared-memory K1 only (trees before the
        # register K1); a later tree's K1 is timed whole
        modes = (K1_OLD_MODES if "k1_kernel(const float*" in old_src
                 else K1_OLD_MODES[:1])
        for mode in modes:
            src = patch_old_k1(old_src, mode)
            jobs.append((("k1", ("old", mode)), "k1_kernel",
                         build_one(f"k1_old_{mode.replace(' ', '_')}",
                                   Path(old) / "dedisperse.cu", Path(old),
                                   None, "", text=src)))
    for v in PFB_VARIANTS if "pfb" in only else ():
        src = re.sub(PFB_RE, knob_lines(PFB_KNOBS, v[1]),
                     re.sub(FIR_RE, knob_lines(FIR_KNOBS, v[0]),
                            (csrc / "pfb.cu").read_text()))
        jobs.append((("pfb", v), ("pfb_fir", "pfb_dft"),
                     build_one("pfb_" + "_".join(map(str, v[0] + v[1])),
                               csrc / "pfb.cu", csrc, None, "", text=src)))
    if old is not None and "pfb" in only:
        jobs.append((("pfb", ("old",)), ("pfb_fir", "pfb_dft"),
                     build_one("pfb_old", Path(old) / "pfb.cu", Path(old),
                               None, "")))
    if old is not None:
        old = Path(old)
        if "corr" in only:
            jobs.append((("corr", "old"), "accel_corr",
                         build_one("accel_old", old / "accel.cu", old, None,
                                   "")))
        if {"fold", "k2"} & set(only):
            jobs.append((("fold", "old"), ("k3_fold", "k2_kernel"),
                         build_one("dedisperse_old", old / "dedisperse.cu",
                                   old, None, "")))
        if "forms" in only:
            jobs.append((("forms", "old"), "k3_fold",
                         build_one("forms_old", old / "dedisperse.cu", old,
                                   None, "")))
        if "resident" in only:
            jobs.append((("res", "old"), "resident_kernel",
                         build_one("resident_old", old / "resident.cu", old,
                                   None, "")))
    libs = {}
    for key, kernel, (so, proc) in jobs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {key}:\n{out}")
        libs[key] = (load(so, key[1] == "old" or key[1][0] == "old"),
                     ptxas_lines(out, kernel)
                     + [ln.strip() for ln in out.splitlines() if "wgmma" in ln]
                     + atomics(so, kernel))
    if ("fold", "old") in libs:   # the parent's K2 is in its dedisperse.cu
        if "k2" in only:
            libs[("k2", "old")] = libs[("fold", "old")]
        if "fold" not in only:
            del libs[("fold", "old")]
    return libs


def call(fn, dev, *args):
    err = fn(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def randn(dev, shape, seed, count):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(count)]


def bytes_ms(*tensors_or_bytes):
    n = sum(t if isinstance(t, int) else t.numel() * t.element_size()
            for t in tensors_or_bytes)
    return 1e3 * n / HBM_BYTES_PER_S


def sweep_corr(libs, dev, reps, out):
    sr, si = randn(dev, (N_SEG, SEG_LEN), 81, 2)
    segs = torch.complex(sr, si)
    tr, ti = randn(dev, (SEG_LEN, 128), 82, 2)
    bank = torch.complex(tr, ti).T.contiguous()
    ref = accel_correlate_bank_ref(segs, tr, ti, valid=VALID)
    keys = [k for k in libs if k[0] == "corr"]
    for key in keys:
        lib, lines = libs[key]
        v = key[1]
        name = ("accel_corr old kernel" if v == "old"
                else f"accel_corr {corr_label(v)}")
        rec = {"kernel": "accel_corr", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        for n_used, n_out in ((65, 72), (65, 65), (128, 128)):
            got = torch.empty((N_SEG, VALID, n_out), device=dev)
            if v == "old":
                if n_used != 128:
                    continue
                kern = lambda: call(lib.bbt_accel_corr, dev, segs.data_ptr(),
                                    tr.data_ptr(), ti.data_ptr(),
                                    got.data_ptr(), N_SEG, SEG_LEN, 128,
                                    VALID)
            else:
                kern = lambda: call(lib.bbt_accel_corr, dev, segs.data_ptr(),
                                    bank.data_ptr(), got.data_ptr(), N_SEG,
                                    SEG_LEN, 128, n_used, n_out, VALID)
            kern()
            torch.cuda.synchronize()
            rel = None
            if v == "old" or v[2] == 0:
                r = ref[..., :n_used]
                rel = float((got[..., :n_used] - r).abs().max()
                            / r.abs().max())
                if got[..., n_used:].any():
                    raise AssertionError(f"{name}: padding lanes not zero")
                if not rel <= 1e-4:
                    raise AssertionError(f"{name}: {rel} of the peak")
            ms = cuda_ms(kern, reps)
            bound = bytes_ms(segs, 8 * SEG_LEN * n_used,
                             4 * N_SEG * VALID * n_used)
            rec[f"{n_used} lanes, rows of {n_out}"] = {
                "ms": ms, "bound_ms": bound, "rel": rel}
            print(f"{name}, {n_used} lanes, rows of {n_out}: {ms:.4f} ms, "
                  f"bound {bound:.4f} "
                  f"ms (bytes), vs plain "
                  f"{'-' if rel is None else f'{rel:.2e}'}", flush=True)
            del got
        out.append(rec)


def sweep_fold(libs, dev, reps, out):
    zf = randn(dev, (N2, N1, L), 83, 2)
    zb = [p.to(torch.bfloat16) for p in zf]
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, FOLD_RATE), device=dev)
    refs = {}
    keys = [k for k in libs if k[0] == "fold"]
    for key in keys:
        lib, lines = libs[key]
        v = key[1]
        name = ("K3 old kernel" if v == "old" else f"K3 {fold_label(v)}")
        rec = {"kernel": "k3_fold", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        for stokes in (False, True):
            for z in (zf, zb):
                form = (("k3_fold_stokes" if stokes else "k3_fold")
                        + ("_bf16" if z is zb else ""))
                W = 3 if stokes else 1
                prof = torch.zeros((N_PHASE + 1, W * L), device=dev)
                cnt = torch.zeros((N_PHASE + 1,), dtype=torch.int32,
                                  device=dev)
                kern = k3_call(lib, form, dev, z, fold, prof, cnt, N_PHASE,
                               PAD_START, N_VALID)
                kern()
                torch.cuda.synchronize()
                rel = cross = None
                if v == "old" or v[2] == 0:
                    if form not in refs:
                        refs[form] = dd.fold_ref(
                            *z, fold, n_phase=N_PHASE, pad_start=PAD_START,
                            n_valid=N_VALID, stokes=stokes)
                    rprof, rcnt = refs[form]
                    if not torch.equal(cnt, rcnt):
                        raise AssertionError(f"{name} {form}: counts")
                    hit = rcnt > 0
                    rel = float(((prof[:, :L] - rprof[:, :L]).abs()[hit]
                                 / rprof[:, :L].abs()[hit]).max())
                    cross = (float((prof[:, L:] - rprof[:, L:]).abs().max()
                                   / rprof[:, L:].abs().max())
                             if stokes else 0.0)
                    if not (rel <= 2e-4 and cross <= 1e-4):
                        raise AssertionError(f"{name} {form}: {rel} {cross}")
                ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_(), kern()),
                             reps)
                zero_ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_()), reps)
                bound = bytes_ms(*z, fold, prof, cnt)
                rec[form] = {"ms": ms - zero_ms, "bound_ms": bound,
                             "rel": rel, "cross": cross}
                print(f"{name}, {form}: {ms - zero_ms:.4f} ms, bound "
                      f"{bound:.4f} ms (bytes), vs plain "
                      f"{'-' if rel is None else f'{rel:.2e} / {cross:.2e}'}",
                      flush=True)
        out.append(rec)


def sweep_forms(libs, dev, reps, out):
    """K3's forms at FORM_BINS, power and Stokes, on the GUPPI node's
    window (by shape, the gather form everywhere, and ``--old``'s); the
    gather knobs at 2048 Stokes and 4096 power bins.  Each held to the plain version (counts exact, power within
    rtol 2e-4, cross planes within 1e-4 of their peak), timed beside the
    planes' bytes bound."""
    z = randn(dev, (N2, N1, L), 86, 2)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, FORM_RATE), device=dev)
    n = N1 * N2
    pad_start, n_valid = FORM_PADS[0], n - sum(FORM_PADS)
    keys = [k for k in libs if k[0] == "forms"]
    for key in keys:
        lib, lines = libs[key]
        v = key[1]
        name = f"K3 {form_label(v)}"
        rec = {"kernel": "k3_fold", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        cases = ([(b, s) for b in FORM_BINS for s in (False, True)]
                 if v in ("old", *FORM_VARIANTS[:2])
                 else [(2048, True), (4096, False)])
        for n_phase, stokes in cases:
            form = "k3_fold_stokes" if stokes else "k3_fold"
            W = 3 if stokes else 1
            code = lib.bbt_k3_form(N1, L, n_phase, dd._K3_KINDS[form])
            shape = ("gather" if code & 64 else "shared" if code & 16
                     else "global", 1 << (code & 15))
            prof = torch.zeros((n_phase + 1, W * L), device=dev)
            cnt = torch.zeros((n_phase + 1,), dtype=torch.int32, device=dev)
            kern = k3_call(lib, form, dev, z, fold, prof, cnt, n_phase,
                           pad_start, n_valid)
            kern()
            torch.cuda.synchronize()
            rprof, rcnt = dd.fold_ref(*z, fold, n_phase=n_phase,
                                      pad_start=pad_start, n_valid=n_valid,
                                      stokes=stokes)
            if not torch.equal(cnt, rcnt):
                raise AssertionError(f"{name} {form} {n_phase}: counts")
            hit = rcnt > 0
            rel = float(((prof[:, :L] - rprof[:, :L]).abs()[hit]
                         / rprof[:, :L].abs()[hit]).max())
            cross = (float((prof[:, L:] - rprof[:, L:]).abs().max()
                           / rprof[:, L:].abs().max()) if stokes else 0.0)
            del rprof, rcnt
            if not (rel <= 2e-4 and cross <= 1e-4):
                raise AssertionError(f"{name} {form} {n_phase}: {rel} "
                                     f"{cross}")
            ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_(), kern()), reps)
            zero_ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_()), reps)
            bound = bytes_ms(*z, fold, prof, cnt)
            rec[f"{form} {n_phase}"] = {"ms": ms - zero_ms, "bound_ms": bound,
                                        "form": shape, "rel": rel,
                                        "cross": cross}
            print(f"{name}, {form} at {n_phase} bins ({shape[0]}, tile "
                  f"{shape[1]}): {ms - zero_ms:.4f} ms, bound {bound:.4f} "
                  f"ms (planes' bytes), vs plain {rel:.2e} / {cross:.2e}",
                  flush=True)
        out.append(rec)


def check_k2_planes(name, got, ref):
    """float32 planes within 1e-4 of the peak, bf16 within one bf16 ulp
    plus 1e-6 of it; returns the error relative to the peak."""
    peak = max(float(r.float().abs().max()) for r in ref)
    rel = max(float((g.float() - r.float()).abs().max()) for g, r in
              zip(got, ref)) / peak
    for g, r in zip(got, ref):
        if r.dtype == torch.bfloat16:
            r, g = r.float(), g.float()
            ulp = torch.exp2(torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
            if not bool(((g - r).abs() <= ulp + 1e-6 * peak).all()):
                raise AssertionError(f"{name}: beyond one bf16 ulp")
        elif not rel <= 1e-4:
            raise AssertionError(f"{name}: {rel} of the peak")
    return rel


def sweep_k2(libs, dev, reps, out):
    cases = {}          # (shape, form) -> (planes, chirp planes)
    for n2, n1, lanes, forms in K2_SHAPES:
        y32 = randn(dev, (n2, n1, lanes), 84, 2)
        y16 = [p.to(torch.bfloat16) for p in y32]
        g = torch.Generator(device=dev)
        g.manual_seed(85)
        theta = torch.rand((n2, n1, lanes), generator=g, device=dev)
        c32 = [torch.cos(2 * torch.pi * theta),
               torch.sin(2 * torch.pi * theta)]
        c16 = [c.to(torch.bfloat16) for c in c32]
        every = {"k2": (y32, c32), "k2_bf16": (y16, c32),
                 "k2_bf16_chirp": (y16, c16), "k2_theta": (y32, [theta])}
        for form in forms:
            cases[((n2, n1, lanes), form)] = every[form]
    refs = {}
    for key in [k for k in libs if k[0] == "k2"]:
        lib, lines = libs[key]
        v = key[1]
        name = "K2 old kernel" if v == "old" else f"K2 {k2_label(v)}"
        rec = {"kernel": "k2", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        for (shape, form), (y, ch) in cases.items():
            n2, n1, lanes = shape
            tag = f"{form} {n2}x{n1}x{lanes}"
            fn = getattr(lib, f"bbt_{form}")
            ptrs = [c.data_ptr() for c in ch]
            work = [p.clone() for p in y]
            kern = lambda w=work: call(fn, dev, w[0].data_ptr(),
                                       w[1].data_ptr(), *ptrs, n1, n2, lanes)
            rel = None
            if v == "old" or v[4] == 0:
                if tag not in refs:
                    yy = [p.clone() for p in y]
                    refs[tag] = (dd.k2_theta_ref(*yy, ch[0])
                                 if form == "k2_theta"
                                 else dd.stage_b_ref(*yy, *ch))
                kern()
                torch.cuda.synchronize()
                rel = check_k2_planes(f"{name} {tag}", work, refs[tag])
            # in place on one scratch copy (a unit-modulus chirp keeps the
            # values bounded over the repeats)
            ms = cuda_ms(kern, reps)
            bound = bytes_ms(*y, *ch, *y)
            rec[tag] = {"ms": ms, "bound_ms": bound, "rel": rel}
            print(f"{name}, {tag}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"(bytes), vs plain {'-' if rel is None else f'{rel:.2e}'}",
                  flush=True)
            del work
        out.append(rec)


# K1 at the paths' shapes: the flagship's (N1 = N2 = 512, L = 128, pads
# 3584/4608: kf 7, ke 9) packed 8-bit and float, float32 and bf16 planes,
# and its plain window (k1_window, k1_planes); config 3's compiled PFB
# chain (N1 = 128, N2 = 256, L = 512, the 256-row carry) and config 2's
# (N1 = N2 = 512, L = 128, the 512-row carry) k1_stream
K1_CASES = [("k1_packed", 512, 512, 128, 7, 9),
            ("k1_packed_bf16", 512, 512, 128, 7, 9),
            ("k1_float", 512, 512, 128, 7, 9),
            ("k1_float_bf16", 512, 512, 128, 7, 9),
            ("k1_window", 512, 512, 128, 0, 0),
            ("k1_stream", 128, 256, 512, 1, 0),
            ("k1_stream", 512, 512, 128, 1, 0)]
K1_BITS = 8


def k1_case(form, n1, n2, lanes, kf, ke, dev):
    """(C entry point, its arguments, the plain result, the tensors it
    reads and writes: the outputs last) of one K1 case."""
    from ..ops import fft as ff
    from ..ops.unpack import default_levels, default_offset
    per = 32 // K1_BITS
    nm = n1 - kf - ke
    dt = torch.bfloat16 if form.endswith("_bf16") else torch.float32
    edges = randn(dev, (kf * n2, lanes), 91, 2) + randn(dev, (ke * n2, lanes),
                                                        92, 2)
    scale = torch.tensor([0.75], device=dev)
    y = [torch.empty((n2, n1, lanes), dtype=dt, device=dev) for _ in range(2)]
    ptr = lambda ts: [t.data_ptr() for t in ts]
    if form.startswith("k1_packed"):
        g = torch.Generator(device=dev)
        g.manual_seed(93)
        words = [torch.randint(-2 ** 31, 2 ** 31 - 1, (nm // per * n2, lanes),
                               generator=g, device=dev, dtype=torch.int64)
                 .to(torch.int32) for _ in range(2)]
        args = (*ptr(words), *ptr(edges), scale.data_ptr(), *ptr(y), n1, n2,
                lanes, kf, ke, K1_BITS, float(default_offset(K1_BITS)),
                *map(float, default_levels(K1_BITS)))
        ref = dd.stage_a_packed_ref(*words, *edges, scale, bits=K1_BITS,
                                    out_dtype=dt)
        ins = words + edges
    elif form.startswith("k1_float"):
        x = randn(dev, (nm * n2, lanes), 94, 2)
        args = (*ptr(x), *ptr(edges), scale.data_ptr(), *ptr(y), n1, n2,
                lanes, kf, ke)
        ref = dd.stage_a_ref(*x, *edges, scale, dt)
        ins = x + edges
    elif form == "k1_window":
        x = randn(dev, (n1 * n2, lanes), 95, 2)
        args = (*ptr(x), *ptr(y), n1, n2, lanes)
        ref = ff.k1_window_ref(*x)
        ins = x
    else:
        x = randn(dev, ((n1 - kf) * n2, lanes), 96, 2)
        carry = edges[:2]
        args = (*ptr(carry), *ptr(x), scale.data_ptr(), 0.0, *ptr(y), n1, n2,
                lanes, kf)
        ref = ff.k1_stream_ref(*carry, *x, scale)
        ins = carry + x
    return f"bbt_{form}", args, ref, ins + [scale] + y


def sweep_k1(libs, dev, reps, out):
    cases = [k1_case(*c, dev) for c in K1_CASES]
    for key in [k for k in libs if k[0] == "k1"]:
        lib, lines = libs[key]
        v = key[1]
        old = v[0] == "old"
        name = (f"K1 old kernel, {v[1]}" if old else f"K1 {k1_label(v)}")
        rec = {"kernel": "k1", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        for (form, n1, n2, lanes, kf, ke), (fn, args, ref, ts) in zip(
                K1_CASES, cases):
            tag = f"{form} {n1}x{n2}x{lanes}"
            y = ts[-2:]
            kern = lambda: call(getattr(lib, fn), dev, *args)
            kern()
            torch.cuda.synchronize()
            rel = None
            if (v[1] if old else v[3]) in ("kernel", 0):
                rel = check_k2_planes(f"{name} {tag}", y, ref)
            ms = cuda_ms(kern, reps)
            bound = bytes_ms(*ts)
            rec[tag] = {"ms": ms, "bound_ms": bound, "rel": rel}
            print(f"{name}, {tag}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"(bytes), vs plain {'-' if rel is None else f'{rel:.2e}'}",
                  flush=True)
        out.append(rec)


# the forward PFB at config 3's shape: 32256 spectra of 512 lanes (256
# channels x 2 pols), 8 taps, the DFT F (x) I_2
PFB_M, PFB_L, PFB_TAPS = 32256, 512, 8
TF32_FLOPS = 495e12            # dense TF32 on the tensor cores


def sweep_pfb(libs, dev, reps, out):
    """pfb_fwd and pfb_fwd_dft of each variant (and the parent's) against
    the plain versions, timed beside their bounds; the shipped FIR then
    lane_mix back to back, and one complex ``matmul`` of the tap sums by
    F (the library's DFT product), timed in the same run."""
    from ..ops import pfb as pf
    from ..ops import spectral_filter as sf
    from ..ops.dft_matmul import _expanded_mats, device_mats
    from ..ops.tf32 import mix_operand, pack_operand
    torch.backends.cuda.matmul.allow_tf32 = False
    m, lanes, nt = PFB_M, PFB_L, PFB_TAPS
    carry = randn(dev, (nt - 1, lanes), 97, 2)
    x = randn(dev, (m, lanes), 98, 2)
    taps = randn(dev, (nt, lanes), 99, 1)[0]
    fr, fi = device_mats(_expanded_mats(256, 2, "forward"), dev)
    scale = torch.tensor([0.75], device=dev)
    kw = dict(n_tap=nt, scale=scale)
    ref_fir = pf.pfb_forward_stream_ref(*carry, *x, taps, **kw)
    ref_dft = pf.pfb_forward_stream_ref(*carry, *x, taps, fr, fi, **kw)
    y = [torch.empty((m, lanes), device=dev) for _ in range(2)]
    ins = [*carry, *x, taps]
    fir_bound = bytes_ms(*ins, scale, *y)
    flops = 8 * lanes * m * lanes            # the DFT's, a pass
    dft_bound = max(bytes_ms(*ins, fr, fi, scale, *y),
                    1e3 * 3 * flops / TF32_FLOPS)
    fp32_bound = 1e3 * flops / FP32_FLOPS
    ptr = lambda ts: [t.data_ptr() for t in ts]
    for key in [k for k in libs if k[0] == "pfb"]:
        lib, lines = libs[key]
        v = key[1]
        old = v[0] == "old"
        name = "PFB old kernels" if old else f"PFB {pfb_label(v)}"
        rec = {"kernel": "pfb", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        if old and old_pfb(lib):
            dft_args = (fr.data_ptr(), fi.data_ptr())
            fir_args = (None, None)
        else:
            tile = (ctypes.c_int * 2)()
            lib.bbt_pfb_fwd_tile(tile)
            wp = pack_operand([mix_operand(fr, fi)], *tuple(tile))
            dft_args = (wp.data_ptr(),)
            fir_args = (None,)
        for form, args, ref, bound in (
                ("pfb_fwd", fir_args, ref_fir, fir_bound),
                ("pfb_fwd_dft", dft_args, ref_dft, dft_bound)):
            kern = lambda a=args: call(
                lib.bbt_pfb_fwd, dev, *ptr(carry), *ptr(x), taps.data_ptr(),
                *a, scale.data_ptr(), 0.0, *ptr(y), m, lanes, nt)
            kern()
            torch.cuda.synchronize()
            rel = None
            if old or v[1][3] == 0 or form == "pfb_fwd":
                rel = check_k2_planes(f"{name} {form}", y, ref)
            ms = cuda_ms(kern, reps)
            rec[form] = {"ms": ms, "bound_ms": bound, "rel": rel}
            print(f"{name}, {form}: {ms:.4f} ms, bound {bound:.4f} ms"
                  f"{' (3xTF32; FP32-core %.4f)' % fp32_bound if 'dft' in form else ' (bytes)'}, "
                  f"vs plain {'-' if rel is None else f'{rel:.2e}'}",
                  flush=True)
        out.append(rec)
    # the yardsticks: the shipped FIR then lane_mix, and the library
    fc = torch.complex(fr, fi)
    ac = torch.complex(*ref_fir)
    pair = lambda: sf.lane_mix(*pf.pfb_forward_stream(*carry, *x, taps, **kw),
                               fr, fi)
    got = pair()
    torch.cuda.synchronize()
    rel = check_k2_planes("pfb_fwd then lane_mix", got, ref_dft)
    del got
    pair_ms = cuda_ms(pair, reps)
    mix_ms = cuda_ms(lambda: sf.lane_mix(*ref_fir, fr, fi), reps)
    lib_ms = cuda_ms(lambda: torch.matmul(ac, fc), reps)
    print(f"pfb_fwd then lane_mix (shipped): {pair_ms:.4f} ms (lane_mix "
          f"alone {mix_ms:.4f}), vs plain {rel:.2e}; library (one complex "
          f"matmul of the tap sums by F): {lib_ms:.4f} ms", flush=True)
    out.append({"kernel": "pfb yardsticks", "pair_ms": pair_ms,
                "lane_mix_ms": mix_ms, "pair_rel": rel, "library_ms": lib_ms,
                "dft_bound_ms": dft_bound, "fp32_bound_ms": fp32_bound})


def sweep_resident(libs, dev, reps, out):
    fold = torch.as_tensor(dd.fold_phase_vector(0.123, RES_RATE), device=dev)
    scale = torch.tensor([0.5], device=dev)
    refs = {}
    for key in [k for k in libs if k[0] == "res"]:
        lib, lines = libs[key]
        v = key[1]
        name = ("resident old kernel" if v == "old"
                else f"resident {res_label(v)}")
        rec = {"kernel": "resident", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        for n in RES_WINDOWS:
            hop, n1, n2 = dr.resident_geometry(n, RES_PAD, RES_PAD)
            T = RES_T // hop * hop
            x = randn(dev, (T, L), 86, 2)
            halos = randn(dev, (RES_PAD, L), 87, 4)
            g = torch.Generator(device=dev)
            g.manual_seed(88)
            ph = torch.rand((n2, n1, L), generator=g, device=dev)
            chirp = [torch.cos(2 * torch.pi * ph), torch.sin(2 * torch.pi * ph)]
            ins = [*x, *halos, *chirp]
            for stokes in (False, True):
                form = f"N={n} {'stokes' if stokes else 'power'}"
                W = 3 if stokes else 1
                prof = torch.zeros((N_PHASE + 1, W * L), device=dev)
                cnt = torch.zeros((N_PHASE + 1,), dtype=torch.int32,
                                  device=dev)
                kern = lambda: call(lib.bbt_resident, dev,
                                    *(t.data_ptr() for t in ins),
                                    fold.data_ptr(), scale.data_ptr(),
                                    prof.data_ptr(), cnt.data_ptr(), n, L,
                                    RES_PAD, RES_PAD, T, N_PHASE,
                                    int(stokes))
                kern()
                torch.cuda.synchronize()
                rel = cross = None
                if v == "old" or v[1][1] == 0:
                    if form not in refs:
                        refs[form] = dr.dedisperse_fold_resident_ref(
                            *ins, fold, scale, n_window=n, n_phase=N_PHASE,
                            pad_start=RES_PAD, pad_end=RES_PAD,
                            stokes=stokes)
                    rprof, rcnt = refs[form]
                    if not torch.equal(cnt, rcnt):
                        raise AssertionError(f"{name} {form}: counts")
                    rel = float(((prof[:, :L] - rprof[:, :L]).abs()
                                 / rprof[:, :L].abs()).max())
                    cross = (float((prof[:, L:] - rprof[:, L:]).abs().max()
                                   / rprof[:, L:].abs().max())
                             if stokes else 0.0)
                    if not (rel <= 2e-4 and cross <= 1e-4):
                        raise AssertionError(f"{name} {form}: {rel} {cross}")
                ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_(), kern()),
                             reps)
                zero_ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_()), reps)
                # the function's bytes (block, halos, chirp once; the
                # profile) against its FP32 work over every window's rows
                rows = T // hop * n
                ops = rows * L * (10 * math.log2(n) + 8 + (12 if stokes
                                                           else 3))
                bound = max(bytes_ms(*ins, fold, prof, cnt),
                            1e3 * ops / FP32_FLOPS)
                rec[form] = {"ms": ms - zero_ms, "bound_ms": bound,
                             "rel": rel, "cross": cross}
                print(f"{name}, {form}: {ms - zero_ms:.4f} ms, bound "
                      f"{bound:.4f} ms, vs plain "
                      f"{'-' if rel is None else f'{rel:.2e} / {cross:.2e}'}",
                      flush=True)
            del x, halos, chirp, ins
        out.append(rec)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--old", default=None,
                   help="another checkout's csrc directory to time too")
    p.add_argument("--only", default="corr,fold,forms,k2,resident,k1,pfb",
                   help="the kernels to sweep, comma-separated")
    args = p.parse_args(argv)
    only = args.only.split(",")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants(args.old, only)
    out = []
    for kind, sweep in (("corr", sweep_corr), ("fold", sweep_fold),
                        ("forms", sweep_forms),
                        ("k2", sweep_k2), ("resident", sweep_resident),
                        ("k1", sweep_k1), ("pfb", sweep_pfb)):
        if kind in only:
            sweep(libs, dev, args.reps, out)
    print(json.dumps({"gpu": gpu, "variants": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
