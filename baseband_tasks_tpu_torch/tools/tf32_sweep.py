"""Time and error of tile and promotion variants of the two 3xTF32
kernels, lane_mix (``csrc/fourstep.cu``) and bank_power (``csrc/
accel.cu``), on one CUDA card.

Each variant is the checkout's own source with the kernel's tile
constants replaced (``kMixBN``/``kMixStages``/``kMixPeriod`` and the
same for ``kBank``: the column tile, the stages of the shared-memory
ring, and the stages a partial runs before it is promoted into the
float32 totals).  A "staging only" variant never promotes: the MMAs'
results are then unused and ptxas drops them, which leaves the time of
the operand traffic, the fragment splits and the barriers alone (its
error is meaningless; the HGMMA count printed for each variant shows
it).  The variants are built in parallel into ``build/sweep/``, their
``-Xptxas -v`` register and spill lines and the tensor-core
instructions of their SASS printed, and each is held against the
float64 product
(peak-relative error, at several depths and seeds) and timed with CUDA
events at the main paths' shapes beside one library call (a complex
``matmul``; for the bank with ``abs()**2``), the references in full
float32.  The first of each list is the kernel as the package builds it.

    python -m baseband_tasks_tpu_torch.tools.tf32_sweep [--reps N]

Prints one line per measurement and ends with a JSON object of them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, tf32
from ..ops.accel_correlate import bank_matmul_power_ref
from ..ops.spectral_filter import lane_mix_ref

SWEEP_DIR = _build.BUILD_DIR.parent / "sweep"

MIX_RE = r"constexpr int kMixBN = \d+, kMixStages = \d+, kMixPeriod = \d+;"
BANK_RE = (r"constexpr int kBankBN = \d+, kBankStages = \d+, "
           r"kBankPeriod = \d+;")
# (BN, stages, period, staging only)
MIX_VARIANTS = [(128, 4, 2, 0), (128, 4, 1, 0), (128, 4, 4, 0),
                (128, 5, 2, 0), (128, 4, 2, 1)]
BANK_VARIANTS = [(64, 4, 1, 0), (64, 4, 2, 0), (64, 4, 4, 0),
                 (56, 4, 2, 0), (80, 4, 2, 0), (64, 4, 1, 1)]
NO_PROMOTION = ("if constexpr (PROMOTE) {", "if constexpr (false) {")
MIX_DEPTHS = (128, 512, 1600)
SEEDS = (0, 1, 2, 3, 4)


def mix_source(bn, stages, period, _):
    return (f"constexpr int kMixBN = {bn}, kMixStages = {stages}, "
            f"kMixPeriod = {period};")


def bank_source(bn, stages, period, _):
    return (f"constexpr int kBankBN = {bn}, kBankStages = {stages}, "
            f"kBankPeriod = {period};")


def label(v):
    return (f"BN {v[0]} stages {v[1]} period {v[2]}"
            f"{' staging only' if v[3] else ''}")


def build_variants():
    """{(unit, variant): (ctypes library, ptxas lines)}, built in
    parallel from the checkout's sources."""
    jobs = []
    for unit, pattern, variants, text_of in (
            ("fourstep.cu", MIX_RE, MIX_VARIANTS, mix_source),
            ("accel.cu", BANK_RE, BANK_VARIANTS, bank_source)):
        src = (_build.CSRC / unit).read_text()
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"{unit}: no single tile line to vary")
        for v in variants:
            d = SWEEP_DIR / f"{unit[:-3]}_{'_'.join(map(str, v))}"
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for h in _build.CSRC.glob("*.cuh"):
                text = h.read_text()
                if v[3]:
                    if text.count(NO_PROMOTION[0]) > 1:
                        raise RuntimeError("no single promotion to remove")
                    text = text.replace(*NO_PROMOTION)
                (d / h.name).write_text(text)
            (d / unit).write_text(re.sub(pattern, text_of(*v), src))
            so = d / "lib.so"
            proc = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(d / unit)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            jobs.append((unit, v, so, proc))
    libs = {}
    for unit, v, so, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {unit} {v}:\n{out}")
        lines = [ln.strip() for ln in out.splitlines()
                 if any(k in ln for k in ("registers", "spill", "wgmma",
                                          "C75"))]
        sass = subprocess.run(
            [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(so)], capture_output=True, text=True, check=True).stdout
        kernel = "lane_mix_kernel" if unit == "fourstep.cu" else \
            "bank_power_kernel"
        hgmma = [m.group(0) for fn in sass.split("Function : ")[1:]
                 if kernel in fn.split()[0] for m in
                 map(re.compile(r"HGMMA\.\S+").search, fn.splitlines())
                 if m]
        lines.append(f"SASS: {len(hgmma)} tensor-core instructions "
                     f"{sorted(set(hgmma))}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[unit, v] = (lib, lines)
    return libs


def tile_of(lib, name):
    tile = (ctypes.c_int * 2)()
    getattr(lib, name)(tile)
    return tuple(tile)


def call(fn, dev, *args):
    err = fn(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def lane_mix_with(lib, dev):
    def run(xr, xi, wr, wi):
        rows, L = xr.shape
        wp = tf32.pack_operand([tf32.mix_operand(wr, wi)],
                               *tile_of(lib, "bbt_lane_mix_tile"))
        yr, yi = torch.empty_like(xr), torch.empty_like(xr)
        vec = int(L % 4 == 0)
        call(lib.bbt_lane_mix, dev, xr.data_ptr(), xi.data_ptr(),
             wp.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, L, vec)
        return (yr, yi), wp
    return run


def bank_power_with(lib, dev):
    def run(fr, fi, ka, kb, kc):
        n_seg, L = fr.shape
        kp = tf32.pack_operand([ka, kb, kc],
                               *tile_of(lib, "bbt_bank_power_tile"))
        out = torch.empty((n_seg, ka.shape[1]), device=dev)
        call(lib.bbt_bank_power, dev, fr.data_ptr(), fi.data_ptr(),
             kp.data_ptr(), out.data_ptr(), n_seg, L, ka.shape[1])
        return out, kp
    return run


def randn(dev, shape, seed, count):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(count)]


def peak_rel(got, ref):
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    return err / max(float(r.abs().max()) for r in ref)


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


def sweep_mix(libs, dev, reps, out):
    for v in MIX_VARIANTS:
        lib, lines = libs["fourstep.cu", v]
        run = lane_mix_with(lib, dev)
        name = f"lane_mix {label(v)}"
        rec = {"kernel": "lane_mix", "variant": v, "ptxas": lines,
               "f64": {}}
        print(name, *lines, sep="\n  ", flush=True)
        for L in MIX_DEPTHS:
            errs = []
            for seed in SEEDS:
                x = randn(dev, (4096, L), 100 + seed, 2)
                w = randn(dev, (L, L), 200 + seed, 2)
                got, _ = run(*x, *w)
                errs.append(peak_rel(got, lane_mix_ref(
                    *(t.double() for t in (*x, *w)))))
            rec["f64"][f"4096x{L}"] = errs
            print(f"{name} 4096 x {L} against float64, seeds {SEEDS}: "
                  f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
        for rows, L in ((32768, 512), (261120, 128)):
            x = randn(dev, (rows, L), 41, 2)
            w = randn(dev, (L, L), 42, 2)
            got, wp = run(*x, *w)
            ref = lane_mix_ref(*x, *w)
            rel = peak_rel(got, [r.double() for r in ref])
            xc, wc = torch.complex(*x), torch.complex(*w)
            kern = lambda: call(lib.bbt_lane_mix, dev, x[0].data_ptr(),
                                x[1].data_ptr(), wp.data_ptr(),
                                got[0].data_ptr(), got[1].data_ptr(), rows,
                                L, 1)
            ms = cuda_ms(kern, reps)
            lib_ms = cuda_ms(lambda: torch.matmul(xc, wc), reps)
            rec[f"{rows}x{L}"] = {"ms": ms, "library_ms": lib_ms,
                                  "rel_vs_plain": rel}
            print(f"{name} {rows} x {L}: {ms:.4f} ms kernel, {lib_ms:.4f} "
                  f"ms library (one complex matmul), vs plain rel "
                  f"{rel:.3e}", flush=True)
            del x, w, got, ref, xc, wc, wp
        out.append(rec)


def sweep_bank(libs, dev, reps, out):
    n_seg, L, n_cols = 8448, 512, 16896
    fr, fi = randn(dev, (n_seg, L), 74, 2)
    ka, kb, kc = randn(dev, (L, n_cols), 75, 3)
    # a library call of the same shapes (for its time only)
    op = torch.complex(ka, kb)
    sc = torch.complex(fr, fi)
    for v in BANK_VARIANTS:
        lib, lines = libs["accel.cu", v]
        run = bank_power_with(lib, dev)
        name = f"bank_power {label(v)}"
        rec = {"kernel": "bank_power", "variant": v, "ptxas": lines}
        print(name, *lines, sep="\n  ", flush=True)
        errs = []
        for seed in SEEDS:
            a = randn(dev, (256, L), 300 + seed, 2)
            k = randn(dev, (L, n_cols), 400 + seed, 3)
            got, _ = run(*a, *k)
            errs.append(peak_rel([got], [bank_matmul_power_ref(
                *(t.double() for t in (*a, *k)))]))
            del a, k, got
        rec["f64 256x512x16896"] = errs
        print(f"{name} 256 x 512 x 16896 against float64, seeds {SEEDS}: "
              f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
        got, kp = run(fr, fi, ka, kb, kc)
        rel = peak_rel([got], [bank_matmul_power_ref(fr, fi, ka, kb,
                                                     kc).double()])
        kern = lambda: call(lib.bbt_bank_power, dev, fr.data_ptr(),
                            fi.data_ptr(), kp.data_ptr(), got.data_ptr(),
                            n_seg, L, n_cols)
        ms = cuda_ms(kern, reps)
        lib_ms = cuda_ms(lambda: (sc @ op).abs() ** 2, reps)
        rec[f"{n_seg}x{L}x{n_cols}"] = {"ms": ms, "library_ms": lib_ms,
                                        "rel_vs_plain": rel}
        print(f"{name} {n_seg} x {L} x {n_cols}: {ms:.4f} ms kernel, "
              f"{lib_ms:.4f} ms library (complex matmul + abs()**2), vs "
              f"plain rel {rel:.3e}", flush=True)
        del got, kp
        out.append(rec)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants()
    out = []
    sweep_mix(libs, dev, args.reps, out)
    sweep_bank(libs, dev, args.reps, out)
    print(json.dumps({"gpu": gpu, "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
