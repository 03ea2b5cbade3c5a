"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the Hopper kernels of ``baseband_tasks_tpu_torch/csrc`` (into
``build/kernels/``), then, at the flagship configuration of ``bench.py``
(64 channels x 2 pols at 250 kHz, DM 500, 64 phase bins, a B1937-like
polyco, 8-bit plane-packed ingest; window N = 2^18, L = 128 lanes):

(a) holds each kernel against its plain PyTorch version on the same
    random input at the flagship shapes, and times both;
(b) drives the pipeline's entry points, ``run_fn(8, ingest_bits=8)`` and
    the float32 twin ``run_fn(2)``, with ``use_kernels=True``, checks the
    counts, checks the profiles against the plain path on the card, and
    checks that every kernel was launched;
(c) times one pipeline step, kernels against the plain path.

Any failure raises (non-zero exit).  Without a CUDA device it fails.  The
second-to-last line is a JSON object of per-kernel results; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# float32 FFT roundoff over log2(512) radix-2 stages is ~1e-6 of the
# largest element; an indexing or decode fault gives errors of order 1.
FFT_TOL = 1e-4            # max |kernel - plain| / max |plain|, K1/K2
# profile bins sum ~4000 detected samples per lane in a run-dependent
# (atomic) order; float32 summation noise is ~1e-6 relative
PROFILE_RTOL = 2e-4       # elementwise, K3 and the end-to-end profiles
N_ITER = 8

KERNELS = {   # launch-count name -> (TPU kernel it replaces)
    "k1_packed": "baseband_tasks_tpu/ops/dedisperse_pallas.py:764",
    "k1_float": "baseband_tasks_tpu/ops/dedisperse_pallas.py:570",
    "k2": "baseband_tasks_tpu/ops/dedisperse_pallas.py:259",
    "k3_fold": "baseband_tasks_tpu/ops/dedisperse_pallas.py:381",
}
SOURCE = "baseband_tasks_tpu_torch/csrc/dedisperse.cu"


def b1937_polyco():
    """bench.py's synthetic B1937+21-like single-entry polyco."""
    from baseband_tasks_tpu_torch import Polyco, PolycoPhase
    f0 = 641.928123
    text = ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")
    return PolycoPhase(Polyco(text))


def flagship(use_kernels, device):
    from baseband_tasks_tpu_torch import Time, WidebandPulsarPipeline, units
    u = units
    return WidebandPulsarPipeline(
        n_chan=64, n_pol=2, dm=500.0, freq_center=1400 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(160000, 3), n_phase=64,
        block_samples=1 << 17, device=device, use_kernels=use_kernels,
        phase_model=b1937_polyco(), start_time=Time.from_mjd(58000.0),
        ingest_bits=8)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
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


def compare(got, ref):
    """Max abs error and its ratio to max |ref| over paired tensors."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    peak = max(float(r.abs().max()) for r in ref)
    return err, err / peak


def check_kernels(pipe, gpu):
    """Phase (a): each kernel against its plain version, then timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dev = pipe.device
    L = pipe.n_chan * pipe.n_pol
    T = pipe.global_block
    words = [w.reshape(-1, L) for w in
             pipe._payload(7, (T // 4, pipe.n_chan, pipe.n_pol), 8)]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    planes = [torch.randn((T, L), generator=g, device=dev) for _ in (0, 1)]
    edges = [torch.randn((n, L), generator=g, device=dev) for n in
             (pipe.pad_start, pipe.pad_start, pipe.pad_end, pipe.pad_end)]
    scale = torch.tensor([1.0 / 64], device=dev)
    csr, csi = pipe._chirp_device()
    fold = torch.as_tensor(pipe._shard_fold3(pipe.fold_model.table(
        [0], T))[0].astype(np.int32), device=dev)
    fold_kw = dict(n_phase=pipe.n_phase, pad_start=pipe.pad_start,
                   n_valid=T)

    cases = {
        "k1_packed": (lambda: dd.stage_a_packed(*words, *edges, scale,
                                                bits=8),
                      lambda: dd.stage_a_packed_ref(*words, *edges, scale,
                                                    bits=8)),
        "k1_float": (lambda: dd.stage_a(*planes, *edges, scale),
                     lambda: dd.stage_a_ref(*planes, *edges, scale)),
    }
    y = dd.stage_a_packed_ref(*words, *edges, scale, bits=8)
    cases["k2"] = (lambda: dd.stage_b(*[p.clone() for p in y], csr, csi),
                   lambda: dd.stage_b_ref(*[p.clone() for p in y], csr,
                                          csi))
    z = dd.stage_b_ref(*[p.clone() for p in y], csr, csi)
    cases["k3_fold"] = (lambda: dd.detect_fold(*z, fold, **fold_kw),
                        lambda: dd.fold_ref(*z, fold, **fold_kw))
    # stage B is timed in place on one scratch copy, without the clones
    # (its chirp has unit modulus, so repeats keep the values bounded)
    work = [p.clone() for p in y]
    timed = dict(cases, k2=(lambda: dd.stage_b(*work, csr, csi),
                            lambda: dd.stage_b_ref(*work, csr, csi)))

    results = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if name == "k3_fold":
            if not torch.equal(got[1], ref[1]):
                raise AssertionError(f"{name}: counts differ")
            err = float((got[0] - ref[0]).abs().max())
            rel = float(((got[0] - ref[0]).abs()
                         / ref[0].abs().clamp_min(1e-30)).max())
            ok = rel <= PROFILE_RTOL
        else:
            err, rel = compare(got, ref)
            ok = rel <= FFT_TOL
        print(f"(a) {name}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"({'ok' if ok else 'FAIL'})", flush=True)
        if not ok or not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{name} disagrees with its plain version")
        ms, plain_ms = (cuda_ms(f) for f in timed[name])
        print(f"(a) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain "
              f"[{gpu}]", flush=True)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def drive_main_path(kern, plain):
    """Phase (b): the pipeline's entry points with the kernels, counted,
    then held against the plain path on the card."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dd.reset_launch_counts()
    runs = {"packed": kern.run_fn(N_ITER, ingest_bits=8)(seed=0),
            "float32": kern.run_fn(2)(seed=0)}
    torch.cuda.synchronize()
    launches = dict(dd.launch_counts)
    print(f"(b) launches: {launches}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    refs = {"packed": plain.run_fn(N_ITER, ingest_bits=8)(seed=0),
            "float32": plain.run_fn(2)(seed=0)}
    for key, n in (("packed", N_ITER), ("float32", 2)):
        (prof, cnt), (rprof, rcnt) = runs[key], refs[key]
        want = n * kern.global_block
        total = int(cnt.sum())
        shape = (kern.n_phase, kern.n_chan, kern.n_pol)
        print(f"(b) {key}: counts sum {total} (want {want}), profile "
              f"{tuple(prof.shape)}", flush=True)
        if total != want or not torch.equal(cnt, rcnt):
            raise AssertionError(f"{key}: counts wrong")
        if tuple(prof.shape) != shape or not torch.isfinite(prof).all():
            raise AssertionError(f"{key}: profile not finite/shaped")
        rel = float(((prof - rprof).abs() / rprof.abs()).max())
        print(f"(b) {key}: profile max rel err vs plain {rel:.3e}",
              flush=True)
        if rel > PROFILE_RTOL:
            raise AssertionError(f"{key}: profile disagrees with plain")
    return launches


def time_steps(kern, plain, gpu):
    """Phase (c): one flagship step, kernels vs plain, in turns."""
    runs = {"kernels": kern.run_fn(N_ITER, ingest_bits=8),
            "plain": plain.run_fn(N_ITER, ingest_bits=8)}
    best = {}
    for key in ("plain", "kernels", "kernels", "plain"):
        runs[key](seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[key](seed=0)
        torch.cuda.synchronize()
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    samples = N_ITER * kern.block_samples * kern.n_chan * kern.n_pol
    for key, dt in best.items():
        print(f"(c) step {key}: {1e3 * dt / N_ITER:.3f} ms/step, "
              f"{samples / dt:.4e} samples/s [{gpu}]", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from baseband_tasks_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    kern, plain = flagship(True, dev), flagship(False, dev)
    print(f"flagship: N={kern._n_fft} pads=({kern.pad_start}, "
          f"{kern.pad_end}) block={kern.block_samples} L="
          f"{kern.n_chan * kern.n_pol}", flush=True)
    results = check_kernels(kern, gpu)
    launches = drive_main_path(kern, plain)
    time_steps(kern, plain, gpu)
    print(gpu)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
             launches=launches[name], **results[name])
        for name, replaces in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
