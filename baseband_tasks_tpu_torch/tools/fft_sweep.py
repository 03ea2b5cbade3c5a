"""Time variants of the hand-written kernels' shipped parameters on one
CUDA card, at the main paths' shapes.

Each variant is the checkout's own source with one constants line of a
kernel replaced (``TABLES``: the line's names and the values it is built
with, the first the line as shipped):

- corr (``csrc/accel.cu`` accel_corr): threads a block, lanes a tile;
- bank (``csrc/accel.cu`` bank_power) and mix (``csrc/fourstep.cu``
  lane_mix), the 3xTF32 GEMMs: the column tile, the stages of the
  shared-memory ring, and the stages a partial runs before it is promoted
  into the float32 totals;
- fold (``csrc/dedisperse.cu`` K3's runs form): the widest lane tile and
  the stage buffers;
- forms (K3's gather form): its widest lane tile, (lane, row group)
  items a thread, stage buffers, rows a phase-2 thread loads at once, and
  the form every shape takes (``kFoldGather`` 0 the form by shape, 1 the
  gather form); timed at 64 to 8192 bins, power and Stokes, on the GUPPI
  node's window (N1 = N2 = 512, L = 128, pads 32768/28672, ~2434 samples
  a period), the other knobs at 2048 Stokes and 4096 power bins;
- k2 (K2 in registers): the widest lane tile, the stage buffers, the
  items a thread, and the chirp staged where it fits, else float32 k2's
  read into registers (0), float32 k2's always into registers (1) or
  always staged (2);
- k1 (K1 in registers): the widest lane tile and the stage buffers;
- fir and pfb (``csrc/pfb.cu``, both timed by ``--only pfb``): the FIR's
  output rows a thread, rows a step and threads a block; the fused DFT's
  column tile, ring stages and promotion period;
- resident (``csrc/resident.cu``): the lane tile and stage buffers of
  each compiled case (N 2048 power and Stokes, 4096 power and Stokes) and
  the chirp slots a thread of the 4096-row Stokes case holds in
  registers;
- xcorr (``csrc/xcorr.cu``, the correlator's fused X stage): threads a
  block, the stations a thread's tile spans on each side, spectra a ring
  buffer, ring buffers, and the blocks an SM its launch bounds ask for; timed on one LOFAR block (64 spectra, 62
  stations x 2 pol, 64 channels x 30 subbands into one dump row) beside
  the unfused products and ``index_add_`` it replaces.

With ``--old DIR`` the kernels of another checkout's ``csrc`` directory,
as it ships them, are built and timed at the same shapes.  ``--only``
picks the groups (default all).  The builds go in parallel into
``build/fft_sweep/``; each prints its ``-Xptxas -v`` register and spill
lines, its wgmma warnings, and the shared-memory atomics and tensor-core
instructions of its SASS.  Every build is held against the plain version
(accel_corr and K2 float32 planes within 1e-4 of the peak, bf16 planes
within one bf16 ulp plus 1e-6 of it; K3 and resident counts exact, the
power plane within rtol 2e-4, the Stokes cross planes within 1e-4 of
their peak; lane_mix and bank_power also against float64 at several
depths and seeds) and timed with CUDA events beside its bound: accel_corr
at 547 segments of 4096 with 3840 valid lags for 65 and 128 lanes; the
3xTF32 GEMMs at the paths' shapes beside one library call; K3 and K2 at
N1 = N2 = 512, L = 128 (K3 with 64 phase bins, power and Stokes, float32
and bf16; K2 in its four launch forms, and k2 at the compiled PFB chains'
N2 = 256, N1 = 128, L = 512); resident on a 261,120-row, 128-lane block
at windows 2048 and 4096, pads 256/256, 64 phase bins, power and Stokes;
K1 at the flagship's window (N1 = N2 = 512, L = 128, pads 3584/4608:
8-bit packed, float32, both with bf16 planes out, the plain window) and
config 3's and config 2's k1_stream; the PFB at config 3's 32256 x 512,
8 taps, beside the FIR then lane_mix and one complex ``matmul`` of the
tap sums by F.

    python -m baseband_tasks_tpu_torch.tools.fft_sweep [--reps N] \
        [--old DIR] \
        [--only corr,bank,mix,fold,forms,k2,resident,k1,pfb,xcorr]

Prints one line per measurement and ends with a JSON object of them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from ..ops import _build, tf32
from ..ops import dedisperse as dd
from ..ops import dedisperse_resident as dr
from ..ops.accel_correlate import (accel_correlate_bank_ref,
                                   bank_matmul_power_ref)
from ..ops.spectral_filter import lane_mix_ref

SWEEP_DIR = _build.BUILD_DIR.parent / "fft_sweep"
HBM_BYTES_PER_S = 3.35e12      # the H100 SXM data sheet's HBM rate
FP32_FLOPS = 67e12             # its FP32 rate outside the tensor cores
TF32_FLOPS = 495e12            # dense TF32 on the tensor cores


class Table(NamedTuple):
    """One constants line of a ``csrc`` unit and the values the sweep
    builds it with; the first are the line as shipped."""
    unit: str
    names: tuple
    variants: list
    label: Callable


def knob_pattern(names):
    """The regular expression of the constants line of ``names``."""
    return ("constexpr int "
            + r",\s+".join(rf"{k} = -?\d+" for k in names) + ";")


def knob_line(names, values):
    """``constexpr int a = 1, b = 2;`` for the names and values."""
    return ("constexpr int "
            + ", ".join(f"{k} = {v}" for k, v in zip(names, values)) + ";")


def form_label(v):
    if v[4] == 0:
        return "form by shape"
    return (f"gather form, tile {v[0]} lanes, {v[1]} item(s) a thread, "
            f"{v[2]} stage buffer(s), {v[3]} rows in flight")


def k2_label(v):
    chirp = ("chirp staged where it fits", "k2's chirp to registers",
             "chirp staged")[v[3]]
    return (f"tile {v[0]} lanes, {v[1]} stage buffer(s), {v[2]} item(s) a "
            f"thread, {chirp}")


def res_label(v):
    return (f"tile/stages {v[0]}/{v[1]} {v[2]}/{v[3]} {v[4]}/{v[5]} "
            f"{v[6]}/{v[7]} ({v[8]} chirp registers)")


def tile_label(v):
    return f"tile {v[0]} lanes, {v[1]} stage buffer(s)"


def gemm_label(v):
    return f"BN {v[0]} stages {v[1]} period {v[2]}"


TABLES = {
    "corr": Table("accel.cu", ("kCorrThreads", "kCorrLanes"),
                  [(512, 8), (256, 4)],
                  lambda v: f"{v[0]} threads, {v[1]} lanes a tile"),
    "bank": Table("accel.cu", ("kBankBN", "kBankStages", "kBankPeriod"),
                  [(64, 4, 1), (64, 4, 2), (64, 4, 4), (56, 4, 2),
                   (80, 4, 2)], gemm_label),
    "mix": Table("fourstep.cu", ("kMixBN", "kMixStages", "kMixPeriod"),
                 [(128, 4, 2), (128, 4, 1), (128, 4, 4), (128, 5, 2)],
                 gemm_label),
    "fold": Table("dedisperse.cu", ("kFoldLanes", "kFoldStages"),
                  [(8, 2), (8, 1), (8, 3), (4, 2), (16, 2)], tile_label),
    # the first two are timed at every bin count
    "forms": Table("dedisperse.cu", ("kGatherLanes", "kGatherItems",
                                     "kGatherStages", "kGatherRows",
                                     "kFoldGather"),
                   [(16, 2, 2, 8, 0), (16, 2, 2, 8, 1), (8, 2, 2, 8, 1),
                    (16, 1, 2, 8, 1), (16, 2, 1, 8, 1), (16, 2, 2, 4, 1),
                    (16, 2, 2, 16, 1)], form_label),
    "k2": Table("dedisperse.cu", ("kK2Lanes", "kK2Stages", "kK2Items",
                                  "kK2Chirp"),
                [(16, 2, 2, 0), (16, 2, 2, 1), (16, 2, 2, 2), (16, 1, 2, 0),
                 (8, 2, 2, 0), (8, 2, 1, 0)], k2_label),
    "k1": Table("dedisperse.cu", ("kK1Lanes", "kK1Stages"),
                [(16, 2), (16, 3), (8, 2)], tile_label),
    "fir": Table("pfb.cu", ("kFirRows", "kFirUnroll", "kFirThreads"),
                 [(128, 4, 128), (64, 4, 128), (128, 4, 64)],
                 lambda v: (f"FIR {v[0]} rows a thread, {v[1]} a step, "
                            f"{v[2]} threads")),
    "pfb": Table("pfb.cu", ("kPfbBN", "kPfbStages", "kPfbPeriod"),
                 [(128, 5, 2), (128, 6, 2), (128, 6, 1)],
                 lambda v: (f"DFT {v[0]} columns, {v[1]} stages, promoted "
                            f"every {v[2]}")),
    "resident": Table("resident.cu", (
        "kResTile2048", "kResStages2048", "kResTile2048S", "kResStages2048S",
        "kResTile4096", "kResStages4096", "kResTile4096S", "kResStages4096S",
        "kResChirpRegs4096S"),
        [(4, 2, 4, 1, 2, 1, 2, 1, 8), (4, 2, 4, 1, 2, 1, 2, 1, 16),
         (4, 2, 4, 2, 2, 2, 1, 2, 8), (4, 1, 4, 1, 2, 1, 1, 1, 8),
         (2, 1, 2, 1, 1, 1, 1, 1, 8)], res_label),
    "xcorr": Table("xcorr.cu", ("kXcThreads", "kXcTileI", "kXcTileJ",
                                "kXcChunk", "kXcStages", "kXcMinBlocks"),
                   [(384, 4, 2, 16, 2, 1), (384, 2, 4, 16, 2, 1),
                    (256, 4, 4, 16, 2, 1), (512, 2, 2, 16, 2, 1),
                    (384, 4, 2, 32, 2, 1), (384, 4, 2, 8, 3, 1)],
                   lambda v: (f"{v[0]} threads, {v[1]} x {v[2]} station "
                              f"tiles, {v[3]} spectra a buffer, {v[4]} "
                              f"buffers, {v[5]} blocks an SM")),
}

# the search's path: 2^22 samples, seg_len 4096, 547 segments, 3840 lags
N_SEG, SEG_LEN, VALID = 547, 4096, 3840
# the flagship's window: N = 2^18 as 512 x 512, L = 128, pads 3584/4608
N1 = N2 = 512
L = 128
N_PHASE, PAD_START, N_VALID = 64, 3584, (1 << 18) - 3584 - 4608
FORM_BINS = (64, 256, 1024, 2048, 4096, 8192)
# the GUPPI node's window and rate (B1937+21 at 1.5625 MHz)
FORM_PADS, FORM_RATE = (32768, 28672), 1.0 / 2434.07
# K2 at the paths' shapes: the flagship's planes in the four launch forms,
# and the compiled PFB chains' (config 3: 2^15-row windows, 512 lanes)
K2_SHAPES = [(N2, N1, L, ("k2", "k2_bf16", "k2_bf16_chirp", "k2_theta")),
             (256, 128, 512, ("k2",))]
# the resident path (chip_smoke.py phase (k)): 261,120 rows cut to whole
# hops, 128 lanes, pads 256/256
RES_T, RES_PAD, RES_WINDOWS = 261120, 256, (2048, 4096)
RES_RATE = 1.0 / 1607.3
# cycles per sample: the flagship's B1937-like pulsar (641.93 Hz) at the
# channel rate of 250 kHz, ~389 samples a turn (chip_smoke.py's polyco)
FOLD_RATE = 641.928123 / 250e3
# the 3xTF32 GEMMs' float64 checks
MIX_DEPTHS = (128, 512, 1600)
SEEDS = (0, 1, 2, 3, 4)


class Build(NamedTuple):
    label: str
    variant: object      # the table's values, or "old"
    lib: ctypes.CDLL
    lines: list          # ptxas and SASS lines of the group's kernels


def build_one(src_dir, unit, edit, started):
    """The library of ``src_dir``'s ``unit`` with the constants line
    ``edit = (pattern, line)`` replaced (None: as it is), its ``nvcc``
    started into ``started`` {library: process} unless an equal source
    already is."""
    src = (Path(src_dir) / unit).read_text()
    if edit is not None:
        if len(re.findall(edit[0], src)) != 1:
            raise RuntimeError(f"{unit}: no single line to vary")
        src = re.sub(edit[0], edit[1], src)
    headers = sorted(Path(src_dir).glob("*.cuh"))
    digest = hashlib.sha1(src.encode())
    for h in headers:
        digest.update(h.read_bytes())
    d = SWEEP_DIR / f"{unit[:-3]}_{digest.hexdigest()[:12]}"
    so = d / "lib.so"
    if so in started:
        return so
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for h in headers:
        shutil.copy(h, d / h.name)
    (d / unit).write_text(src)
    started[so] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
         str(d / unit)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return so


def ptxas_lines(out, names):
    """The register and spill lines of the entries of kernels ``names``,
    and the wgmma warnings."""
    lines, keep = [], False
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in names if k in ln), None)
            keep = name is not None
            if keep:      # the instantiation's template arguments
                lines.append(name + ln.split(name)[-1].split("EEv")[0] + "E")
        elif keep and ("registers" in ln or "spill" in ln):
            lines.append(ln.split("ptxas info    :")[-1].strip())
        elif "wgmma" in ln or "C75" in ln:
            lines.append(ln.strip())
    return lines


def sass_lines(so, names):
    """The shared-memory atomic instructions (a float add to shared memory
    is a CAS loop) and tensor-core instructions in the SASS of kernels
    ``names``, by opcode."""
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(so)], capture_output=True, text=True, check=True).stdout
    lines = []
    for what, op in (("shared atomics", r"ATOMS\.\S+"),
                     ("tensor-core instructions", r"HGMMA\.\S+")):
        ops = {}
        for fn in sass.split("Function : ")[1:]:
            if any(k in fn.split()[0] for k in names):
                for m in re.finditer(rf"\b({op})", fn):
                    ops[m.group(1).rstrip(";")] = ops.get(
                        m.group(1).rstrip(";"), 0) + 1
        if ops:
            lines.append(f"SASS {what}: {ops}")
    return lines


def load(so):
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _build._RESTYPES.get(name, ctypes.c_int)
    return lib


def build_variants(old, only):
    """{group: [Build]}: the variants of each of the group's tables (one
    library for equal sources, timed once a group) and, with ``old``,
    that checkout's kernels."""
    procs, wanted = {}, []
    for group in only:
        tables, kernels, _ = GROUPS[group]
        seen = set()
        for t in tables:
            tab = TABLES[t]
            for v in tab.variants:
                edit = (knob_pattern(tab.names), knob_line(tab.names, v))
                so = build_one(_build.CSRC, tab.unit, edit, procs)
                if so not in seen:
                    seen.add(so)
                    wanted.append((group, f"{t} {tab.label(v)}", v, kernels,
                                   so))
        if old is not None:
            so = build_one(old, TABLES[tables[0]].unit, None, procs)
            wanted.append((group, "old kernel", "old", kernels, so))
    outs = {}
    for so, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {so.parent.name}:\n{out}")
        outs[so] = (load(so), out)
    libs = {}
    for group, label, v, kernels, so in wanted:
        lib, out = outs[so]
        libs.setdefault(group, []).append(Build(
            label, v, lib, ptxas_lines(out, kernels) + sass_lines(so,
                                                                  kernels)))
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


def start(kernel, build, out):
    """The record of one build, its header printed."""
    name = f"{kernel} {build.label}"
    print(name, *build.lines, sep="\n  ", flush=True)
    rec = {"kernel": kernel, "variant": build.variant, "ptxas": build.lines}
    out.append(rec)
    return name, rec


def check_fold(name, prof, cnt, ref, stokes):
    """Counts exact, bins no row reached zero, the power plane within rtol
    2e-4 elsewhere, the Stokes cross planes within 1e-4 of their peak;
    (rel, cross)."""
    rprof, rcnt = ref
    if not torch.equal(cnt, rcnt):
        raise AssertionError(f"{name}: counts")
    hit = rcnt > 0
    if prof[~hit].any() or rprof[~hit].any():
        raise AssertionError(f"{name}: an empty bin is not zero")
    rel = float(((prof[:, :L] - rprof[:, :L]).abs()[hit]
                 / rprof[:, :L].abs()[hit]).max())
    cross = (float((prof[:, L:] - rprof[:, L:]).abs().max()
                   / rprof[:, L:].abs().max()) if stokes else 0.0)
    if not (rel <= 2e-4 and cross <= 1e-4):
        raise AssertionError(f"{name}: {rel} {cross}")
    return rel, cross


def sweep_corr(builds, dev, reps, out):
    sr, si = randn(dev, (N_SEG, SEG_LEN), 81, 2)
    segs = torch.complex(sr, si)
    tr, ti = randn(dev, (SEG_LEN, 128), 82, 2)
    bank = torch.complex(tr, ti).T.contiguous()
    ref = accel_correlate_bank_ref(segs, tr, ti, valid=VALID)
    for b in builds:
        name, rec = start("accel_corr", b, out)
        for n_used, n_out in ((65, 72), (65, 65), (128, 128)):
            got = torch.empty((N_SEG, VALID, n_out), device=dev)
            kern = lambda: call(b.lib.bbt_accel_corr, dev, segs.data_ptr(),
                                bank.data_ptr(), got.data_ptr(), N_SEG,
                                SEG_LEN, 128, n_used, n_out, VALID)
            kern()
            torch.cuda.synchronize()
            r = ref[..., :n_used]
            rel = float((got[..., :n_used] - r).abs().max() / r.abs().max())
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
                  f"bound {bound:.4f} ms (bytes), vs plain {rel:.2e}",
                  flush=True)
            del got


def tile_of(lib, name):
    tile = (ctypes.c_int * 2)()
    getattr(lib, name)(tile)
    return tuple(tile)


def peak_rel(got, ref):
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    return err / max(float(r.abs().max()) for r in ref)


def sweep_mix(builds, dev, reps, out):
    """lane_mix against float64 at MIX_DEPTHS and SEEDS, then timed at the
    compiled chains' shapes beside one complex ``matmul``."""
    for b in builds:
        name, rec = start("lane_mix", b, out)
        rec["f64"] = {}

        def run(xr, xi, wr, wi):
            rows, lanes = xr.shape
            wp = tf32.pack_operand([tf32.mix_operand(wr, wi)],
                                   *tile_of(b.lib, "bbt_lane_mix_tile"))
            yr, yi = torch.empty_like(xr), torch.empty_like(xr)
            call(b.lib.bbt_lane_mix, dev, xr.data_ptr(), xi.data_ptr(),
                 wp.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, lanes,
                 int(lanes % 4 == 0))
            return (yr, yi), wp

        for depth in MIX_DEPTHS:
            errs = []
            for seed in SEEDS:
                x = randn(dev, (4096, depth), 100 + seed, 2)
                w = randn(dev, (depth, depth), 200 + seed, 2)
                got, _ = run(*x, *w)
                errs.append(peak_rel(got, lane_mix_ref(
                    *(t.double() for t in (*x, *w)))))
            rec["f64"][f"4096x{depth}"] = errs
            print(f"{name} 4096 x {depth} against float64, seeds {SEEDS}: "
                  f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
        for rows, lanes in ((32768, 512), (261120, 128)):
            x = randn(dev, (rows, lanes), 41, 2)
            w = randn(dev, (lanes, lanes), 42, 2)
            got, wp = run(*x, *w)
            rel = peak_rel(got, [r.double() for r in lane_mix_ref(*x, *w)])
            xc, wc = torch.complex(*x), torch.complex(*w)
            kern = lambda: call(b.lib.bbt_lane_mix, dev, x[0].data_ptr(),
                                x[1].data_ptr(), wp.data_ptr(),
                                got[0].data_ptr(), got[1].data_ptr(), rows,
                                lanes, 1)
            ms = cuda_ms(kern, reps)
            lib_ms = cuda_ms(lambda: torch.matmul(xc, wc), reps)
            rec[f"{rows}x{lanes}"] = {"ms": ms, "library_ms": lib_ms,
                                      "rel_vs_plain": rel}
            print(f"{name} {rows} x {lanes}: {ms:.4f} ms kernel, {lib_ms:.4f}"
                  f" ms library (one complex matmul), vs plain rel {rel:.3e}",
                  flush=True)
            del x, w, got, xc, wc, wp


def sweep_bank(builds, dev, reps, out):
    """bank_power against float64 at SEEDS, then timed at the search's
    full width beside a complex ``matmul`` and ``abs()**2``."""
    n_seg, depth, n_cols = 8448, 512, 16896
    fr, fi = randn(dev, (n_seg, depth), 74, 2)
    ka, kb, kc = randn(dev, (depth, n_cols), 75, 3)
    op, sc = torch.complex(ka, kb), torch.complex(fr, fi)
    for b in builds:
        name, rec = start("bank_power", b, out)

        def run(ar, ai, oa, ob, oc):
            kp = tf32.pack_operand([oa, ob, oc],
                                   *tile_of(b.lib, "bbt_bank_power_tile"))
            got = torch.empty((ar.shape[0], oa.shape[1]), device=dev)
            call(b.lib.bbt_bank_power, dev, ar.data_ptr(), ai.data_ptr(),
                 kp.data_ptr(), got.data_ptr(), ar.shape[0], ar.shape[1],
                 oa.shape[1])
            return got, kp

        errs = []
        for seed in SEEDS:
            a = randn(dev, (256, depth), 300 + seed, 2)
            k = randn(dev, (depth, n_cols), 400 + seed, 3)
            got, _ = run(*a, *k)
            errs.append(peak_rel([got], [bank_matmul_power_ref(
                *(t.double() for t in (*a, *k)))]))
            del a, k, got
        rec[f"f64 256x{depth}x{n_cols}"] = errs
        print(f"{name} 256 x {depth} x {n_cols} against float64, seeds "
              f"{SEEDS}: {', '.join(f'{e:.3e}' for e in errs)}", flush=True)
        got, kp = run(fr, fi, ka, kb, kc)
        rel = peak_rel([got], [bank_matmul_power_ref(fr, fi, ka, kb,
                                                     kc).double()])
        kern = lambda: call(b.lib.bbt_bank_power, dev, fr.data_ptr(),
                            fi.data_ptr(), kp.data_ptr(), got.data_ptr(),
                            n_seg, depth, n_cols)
        ms = cuda_ms(kern, reps)
        lib_ms = cuda_ms(lambda: (sc @ op).abs() ** 2, reps)
        rec[f"{n_seg}x{depth}x{n_cols}"] = {"ms": ms, "library_ms": lib_ms,
                                            "rel_vs_plain": rel}
        print(f"{name} {n_seg} x {depth} x {n_cols}: {ms:.4f} ms kernel, "
              f"{lib_ms:.4f} ms library (complex matmul + abs()**2), vs "
              f"plain rel {rel:.3e}", flush=True)
        del got, kp


def k3_call(lib, form, dev, z, fold, prof, cnt, n_phase, pad_start,
            n_valid):
    """A launch of K3 ``form`` (k3_fold, k3_fold_stokes, their _bf16
    twins) from ``lib``, with the scratch its shape needs, as a function
    of no arguments."""
    n2, n1, lanes = z[0].shape
    nbytes = lib.bbt_k3_scratch(n1, n2, lanes, n_phase, dd._K3_KINDS[form])
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
               if nbytes else None)
    args = (z[0].data_ptr(), z[1].data_ptr(), fold.data_ptr(),
            prof.data_ptr(), cnt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n1, n2, lanes,
            n_phase, pad_start, n_valid)
    fn = getattr(lib, f"bbt_{form}")
    return lambda: (scratch, call(fn, dev, *args))


def sweep_fold(builds, dev, reps, out):
    zf = randn(dev, (N2, N1, L), 83, 2)
    zb = [p.to(torch.bfloat16) for p in zf]
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, FOLD_RATE), device=dev)
    refs = {}
    for b in builds:
        name, rec = start("K3", b, out)
        for stokes in (False, True):
            for z in (zf, zb):
                form = (("k3_fold_stokes" if stokes else "k3_fold")
                        + ("_bf16" if z is zb else ""))
                W = 3 if stokes else 1
                prof = torch.zeros((N_PHASE + 1, W * L), device=dev)
                cnt = torch.zeros((N_PHASE + 1,), dtype=torch.int32,
                                  device=dev)
                kern = k3_call(b.lib, form, dev, z, fold, prof, cnt, N_PHASE,
                               PAD_START, N_VALID)
                kern()
                torch.cuda.synchronize()
                if form not in refs:
                    refs[form] = dd.fold_ref(
                        *z, fold, n_phase=N_PHASE, pad_start=PAD_START,
                        n_valid=N_VALID, stokes=stokes)
                rel, cross = check_fold(f"{name} {form}", prof, cnt,
                                        refs[form], stokes)
                ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_(), kern()),
                             reps)
                zero_ms = cuda_ms(lambda: (prof.zero_(), cnt.zero_()), reps)
                bound = bytes_ms(*z, fold, prof, cnt)
                rec[form] = {"ms": ms - zero_ms, "bound_ms": bound,
                             "rel": rel, "cross": cross}
                print(f"{name}, {form}: {ms - zero_ms:.4f} ms, bound "
                      f"{bound:.4f} ms (bytes), vs plain {rel:.2e} / "
                      f"{cross:.2e}", flush=True)


def sweep_forms(builds, dev, reps, out):
    """K3's forms at FORM_BINS, power and Stokes, on the GUPPI node's
    window (by shape, the gather form everywhere, and ``--old``'s); the
    gather knobs at 2048 Stokes and 4096 power bins.  Each held to the
    plain version, timed beside the planes' bytes bound."""
    z = randn(dev, (N2, N1, L), 86, 2)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, FORM_RATE), device=dev)
    n = N1 * N2
    pad_start, n_valid = FORM_PADS[0], n - sum(FORM_PADS)
    every = ("old", *TABLES["forms"].variants[:2])
    for b in builds:
        name, rec = start("K3", b, out)
        cases = ([(bins, s) for bins in FORM_BINS for s in (False, True)]
                 if b.variant in every else [(2048, True), (4096, False)])
        for n_phase, stokes in cases:
            form = "k3_fold_stokes" if stokes else "k3_fold"
            W = 3 if stokes else 1
            code = b.lib.bbt_k3_form(N1, L, n_phase, dd._K3_KINDS[form])
            shape = ("gather" if code & 64 else "shared" if code & 16
                     else "global", 1 << (code & 15))
            prof = torch.zeros((n_phase + 1, W * L), device=dev)
            cnt = torch.zeros((n_phase + 1,), dtype=torch.int32, device=dev)
            kern = k3_call(b.lib, form, dev, z, fold, prof, cnt, n_phase,
                           pad_start, n_valid)
            kern()
            torch.cuda.synchronize()
            ref = dd.fold_ref(*z, fold, n_phase=n_phase, pad_start=pad_start,
                              n_valid=n_valid, stokes=stokes)
            rel, cross = check_fold(f"{name} {form} {n_phase}", prof, cnt,
                                    ref, stokes)
            del ref
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


def sweep_k2(builds, dev, reps, out):
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
    for b in builds:
        name, rec = start("K2", b, out)
        for (shape, form), (y, ch) in cases.items():
            n2, n1, lanes = shape
            tag = f"{form} {n2}x{n1}x{lanes}"
            fn = getattr(b.lib, f"bbt_{form}")
            ptrs = [c.data_ptr() for c in ch]
            work = [p.clone() for p in y]
            kern = lambda w=work: call(fn, dev, w[0].data_ptr(),
                                       w[1].data_ptr(), *ptrs, n1, n2, lanes)
            if tag not in refs:
                yy = [p.clone() for p in y]
                refs[tag] = (dd.k2_theta_ref(*yy, ch[0]) if form == "k2_theta"
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
                  f"(bytes), vs plain {rel:.2e}", flush=True)
            del work


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


def sweep_k1(builds, dev, reps, out):
    cases = [k1_case(*c, dev) for c in K1_CASES]
    for b in builds:
        name, rec = start("K1", b, out)
        for (form, n1, n2, lanes, kf, ke), (fn, args, ref, ts) in zip(
                K1_CASES, cases):
            tag = f"{form} {n1}x{n2}x{lanes}"
            kern = lambda: call(getattr(b.lib, fn), dev, *args)
            kern()
            torch.cuda.synchronize()
            rel = check_k2_planes(f"{name} {tag}", ts[-2:], ref)
            ms = cuda_ms(kern, reps)
            bound = bytes_ms(*ts)
            rec[tag] = {"ms": ms, "bound_ms": bound, "rel": rel}
            print(f"{name}, {tag}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"(bytes), vs plain {rel:.2e}", flush=True)


# the forward PFB at config 3's shape: 32256 spectra of 512 lanes (256
# channels x 2 pols), 8 taps, the DFT F (x) I_2
PFB_M, PFB_L, PFB_TAPS = 32256, 512, 8


def sweep_pfb(builds, dev, reps, out):
    """pfb_fwd and pfb_fwd_dft of each build against the plain versions,
    timed beside their bounds; the shipped FIR then lane_mix back to
    back, and one complex ``matmul`` of the tap sums by F (the library's
    DFT product), timed in the same run."""
    from ..ops import pfb as pf
    from ..ops import spectral_filter as sf
    from ..ops.dft_matmul import _expanded_mats, device_mats
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
    for b in builds:
        name, rec = start("PFB", b, out)
        wp = tf32.pack_operand([tf32.mix_operand(fr, fi)],
                               *tile_of(b.lib, "bbt_pfb_fwd_tile"))
        for form, args, ref, bound in (
                ("pfb_fwd", (None,), ref_fir, fir_bound),
                ("pfb_fwd_dft", (wp.data_ptr(),), ref_dft, dft_bound)):
            kern = lambda a=args: call(
                b.lib.bbt_pfb_fwd, dev, *ptr(carry), *ptr(x), taps.data_ptr(),
                *a, scale.data_ptr(), 0.0, *ptr(y), m, lanes, nt)
            kern()
            torch.cuda.synchronize()
            rel = check_k2_planes(f"{name} {form}", y, ref)
            ms = cuda_ms(kern, reps)
            rec[form] = {"ms": ms, "bound_ms": bound, "rel": rel}
            by = (f"3xTF32; FP32-core {fp32_bound:.4f}" if "dft" in form
                  else "bytes")
            print(f"{name}, {form}: {ms:.4f} ms, bound {bound:.4f} ms ({by}),"
                  f" vs plain {rel:.2e}", flush=True)
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


def sweep_resident(builds, dev, reps, out):
    fold = torch.as_tensor(dd.fold_phase_vector(0.123, RES_RATE), device=dev)
    scale = torch.tensor([0.5], device=dev)
    refs = {}
    for b in builds:
        name, rec = start("resident", b, out)
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
                kern = lambda: call(b.lib.bbt_resident, dev,
                                    *(t.data_ptr() for t in ins),
                                    fold.data_ptr(), scale.data_ptr(),
                                    prof.data_ptr(), cnt.data_ptr(), n, L,
                                    RES_PAD, RES_PAD, T, N_PHASE,
                                    int(stokes))
                kern()
                torch.cuda.synchronize()
                if form not in refs:
                    refs[form] = dr.dedisperse_fold_resident_ref(
                        *ins, fold, scale, n_window=n, n_phase=N_PHASE,
                        pad_start=RES_PAD, pad_end=RES_PAD, stokes=stokes)
                rel, cross = check_fold(f"{name} {form}", prof, cnt,
                                        refs[form], stokes)
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
                      f"{bound:.4f} ms, vs plain {rel:.2e} / {cross:.2e}",
                      flush=True)
            del x, halos, chirp, ins


# group: (its tables, the kernels whose ptxas and SASS lines it prints,
# its sweep); the order is the order they run in
# one LOFAR block: 64 spectra of 62 stations x 2 pol at 64 channels x 30
# subbands, all of one dump
XC_T, XC_N, XC_F, XC_SB = 64, 62, 64 * 30, 30


def sweep_xcorr(builds, dev, reps, out):
    """xcorr of each build against the plain version (within 2e-6 of the
    peak) and timed on one LOFAR block, laid out as the correlator's
    stack is (each station's channels contiguous, its polarizations and
    subbands outside them), beside its bound (8 operations a complex
    product at the FP32 rate; the spectra read once, one dump row read
    and written) and the unfused path (gathers, products and
    ``index_add_``, ``models/correlator.py``)."""
    from ..ops.xcorr import _cell_axes, xcorr_accumulate_ref
    xr, xi = randn(dev, (XC_T, XC_SB, 2, XC_N, XC_F // XC_SB), 91, 2)
    x = torch.complex(xr, xi).permute(0, 3, 4, 1, 2)
    del xr, xi
    seg = torch.zeros(XC_T, dtype=torch.int64, device=dev)
    nb = XC_N * (XC_N + 1) // 2
    zeros = torch.zeros((2, nb, XC_F // XC_SB, XC_SB, 4),
                        dtype=torch.complex64, device=dev)
    ref = xcorr_accumulate_ref(x, seg, zeros.clone(), full=True)[0]
    peak = float(ref.abs().max())
    bi, bj = torch.triu_indices(XC_N, XC_N, device=dev)

    def unfused():
        conj = torch.conj(x).resolve_conj()
        y = (x[:, bi].unsqueeze(-1) * conj[:, bj].unsqueeze(-2)).flatten(-2)
        zeros.index_add_(0, seg, y)

    dims, strides, outs = _cell_axes(x, 2)
    nd = len(dims)
    dims = (ctypes.c_int * nd)(*dims)
    strides = (ctypes.c_longlong * nd)(*strides)
    outs = (ctypes.c_longlong * nd)(*outs)
    ops = 8.0 * nb * 4 * XC_F * XC_T
    bound = max(1e3 * ops / FP32_FLOPS, bytes_ms(x, 2 * nb * XC_F * 32))
    lib_ms = cuda_ms(unfused, max(1, reps // 10))
    print(f"xcorr unfused (gathers, products, index_add_): {lib_ms:.4f} ms",
          flush=True)
    for b in builds:
        name, rec = start("xcorr", b, out)
        sums = zeros.clone().zero_()
        kern = lambda: call(b.lib.bbt_xcorr, dev, x.data_ptr(),
                            seg.data_ptr(), sums.data_ptr(), XC_T, XC_N, 2,
                            1, x.stride(0), x.stride(1), x.stride(-1), nd,
                            dims, strides, outs)
        kern()
        torch.cuda.synchronize()
        rel = float((sums[0] - ref).abs().max()) / peak
        if not rel <= 2e-6:
            raise AssertionError(f"{name}: {rel} of the peak")
        ms = cuda_ms(kern, reps)
        rec["lofar block"] = {"ms": ms, "bound_ms": bound, "rel": rel,
                              "unfused_ms": lib_ms}
        print(f"{name}: {ms:.4f} ms, bound {bound:.4f} ms (operations), "
              f"{100 * bound / ms:.1f} %, vs plain {rel:.2e}", flush=True)
        del sums


GROUPS = {
    "corr": (("corr",), ("accel_corr",), sweep_corr),
    "bank": (("bank",), ("bank_power_kernel",), sweep_bank),
    "mix": (("mix",), ("lane_mix_kernel",), sweep_mix),
    "fold": (("fold",), ("k3_fold",), sweep_fold),
    "forms": (("forms",), ("k3_fold",), sweep_forms),
    "k2": (("k2",), ("k2_reg",), sweep_k2),
    "resident": (("resident",), ("resident_reg",), sweep_resident),
    "k1": (("k1",), ("k1_reg",), sweep_k1),
    "pfb": (("fir", "pfb"), ("pfb_fir", "pfb_dft"), sweep_pfb),
    "xcorr": (("xcorr",), ("xcorr_kernel",), sweep_xcorr),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--old", default=None,
                   help="another checkout's csrc directory to time too")
    p.add_argument("--only", default=",".join(GROUPS),
                   help="the groups to sweep, comma-separated")
    args = p.parse_args(argv)
    only = [g for g in GROUPS if g in args.only.split(",")]
    unknown = set(args.only.split(",")) - set(GROUPS)
    if unknown:
        p.error(f"no group {', '.join(sorted(unknown))}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # the library calls and references in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants(args.old, only)
    out = []
    for group in only:
        GROUPS[group][2](libs[group], dev, args.reps, out)
    print(json.dumps({"gpu": gpu, "variants": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
