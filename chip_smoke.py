"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the Hopper kernels of ``baseband_tasks_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel, into ``build/kernels/``), then, at the
flagship configuration of ``bench.py`` (64 channels x 2 pols at 250 kHz,
DM 500, 64 phase bins, a B1937-like polyco, 8-bit plane-packed ingest;
window N = 2^18, L = 128 lanes):

(a) holds each flagship kernel against its plain PyTorch version on the
    same random input at the flagship shapes, and times both;
(b) drives the pipeline's entry points, ``run_fn(8, ingest_bits=8)`` and
    the float32 twin ``run_fn(2)``, with ``use_kernels=True``, checks the
    counts, checks the profiles against the plain path on the card, and
    checks that every kernel was launched;
(c) times one pipeline step, kernels against the plain path;

and at the coherent-dedispersion configuration of ``BASELINE.json``
config 2 (``tools/bench_full.py`` ``config2``: 128 channels x 125 kHz
around 1400 MHz, sideband +1, DM 29.7, noise from seed 1):

(d) holds the four-step kernels (k1_window, k2_fwd, k2_inv, k3_trim)
    against their plain versions at N = 2^18, L = 128 (pads 512/512 for
    the trim, both ortho settings for the FFT), and times both;
(e) drives the stream-task paths: ``Dechannelize(Dedisperse(src, 29.7,
    samples_per_frame=2**17, engine='pallas'))`` and ``Dedisperse(src,
    29.7, samples_per_frame=2**18 - 693, engine='xla')`` under
    ``fft_maker.set('pallas')``; reads a few frames of each, checks the
    geometry, that every kernel of each path was launched, and holds the
    output against the same chain on the plain versions on the card;
(f) times one frame of the first path, kernels against plain.

Any failure raises (non-zero exit).  Without a CUDA device it fails.  The
second-to-last line is a JSON object of per-kernel results; the last line
is ``{"ok": true, "device": {...}}``.
"""

import contextlib
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

N_FRAMES = 2               # frames read from each stream-task path
DEDISPERSE_CU = "baseband_tasks_tpu_torch/csrc/dedisperse.cu"
FOURSTEP_CU = "baseband_tasks_tpu_torch/csrc/fourstep.cu"
KERNELS = {   # launch-count name -> (TPU kernel it replaces, source)
    "k1_packed": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:764",
                  DEDISPERSE_CU),
    "k1_float": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:570",
                 DEDISPERSE_CU),
    "k2": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:259", DEDISPERSE_CU),
    "k3_fold": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:381",
                DEDISPERSE_CU),
    "k1_window": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:223",
                  DEDISPERSE_CU),
    "k2_fwd": ("baseband_tasks_tpu/ops/fft_pallas.py:36", FOURSTEP_CU),
    "k2_inv": ("baseband_tasks_tpu/ops/fft_pallas.py:44", FOURSTEP_CU),
    "k3_trim": ("baseband_tasks_tpu/ops/spectral_filter.py:129",
                FOURSTEP_CU),
}
FLAGSHIP = ("k1_packed", "k1_float", "k2", "k3_fold")


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
    missing = [k for k in FLAGSHIP if launches[k] <= 0]
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


def config2_source(dev):
    """``tools/bench_full.py`` config 2's source, on the card: 128 x
    125 kHz complex channels around 1400 MHz, sideband +1, 2^23 samples
    of noise from seed 1 in frames of 8192."""
    from baseband_tasks_tpu_torch import (NoiseGenerator, SetAttribute,
                                          Time, units as u)
    n_chan = 128
    freq = (1400 + (np.arange(n_chan) - n_chan / 2) * 0.125) * u.MHz
    return SetAttribute(NoiseGenerator(
        shape=(1 << 23, n_chan), start_time=Time.from_mjd(58000.0),
        sample_rate=125 * u.kHz, samples_per_frame=8192, seed=1,
        device=dev), frequency=freq, sideband=1)


def check_four_step(dev, gpu):
    """Phase (d): the four-step kernels against their plain versions at
    N = 2^18, L = 128, then timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd, fft as ff
    n, L = 1 << 18, 128
    n1, n2 = dd.split_n(n)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    x = [torch.randn((n, L), generator=g, device=dev) for _ in (0, 1)]
    y = [torch.randn((n2, n1, L), generator=g, device=dev) for _ in (0, 1)]
    pads = dict(pad_start=512, pad_end=512)
    cases = {"k1_window": [(lambda: ff.k1_window(*x),
                            lambda: ff.k1_window_ref(*x))],
             "k3_trim": [(lambda: ff.k3_trim(*y, **pads),
                          lambda: ff.k3_trim_ref(*y, **pads))],
             "k2_fwd": [], "k2_inv": []}
    for ortho in (False, True):
        fwd = ff.fft_scale(n, inverse=False, ortho=ortho)
        inv = ff.fft_scale(n, inverse=True, ortho=ortho) * n1
        cases["k2_fwd"].append((lambda s=fwd: ff.k2_fwd(*y, s),
                                lambda s=fwd: ff.k2_fwd_ref(*y, s)))
        cases["k2_inv"].append((lambda s=inv: ff.k2_inv(*y, s),
                                lambda s=inv: ff.k2_inv_ref(*y, s)))
    results = {}
    for name, pairs in cases.items():
        errs = []
        for kern, plain in pairs:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err, rel = compare(got, ref)
            ok = rel <= FFT_TOL and all(bool(torch.isfinite(t).all())
                                        for t in got)
            print(f"(d) {name}: max_abs_err={err:.3e} rel={rel:.3e} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version")
            errs.append(err)
        ms, plain_ms = (cuda_ms(f) for f in pairs[0])
        print(f"(d) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain "
              f"[{gpu}]", flush=True)
        results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    return results


def task_paths(src, kernels):
    """The two config-2 stream-task paths, kernels or plain versions:
    (name, stream, FFT engine to read it under)."""
    from baseband_tasks_tpu_torch import Dechannelize, Dedisperse
    from baseband_tasks_tpu_torch.fourier import PallasFFTMaker, fft_maker
    ded = Dedisperse(src, 29.7, samples_per_frame=2 ** 17, engine="pallas",
                     use_kernels=kernels)
    engine = PallasFFTMaker(use_kernels=kernels)
    with fft_maker.set(engine):
        xla = Dedisperse(src, 29.7, samples_per_frame=2 ** 18 - 693,
                         engine="xla")
    return [("dedisperse_dechannelize", Dechannelize(ded), None),
            ("xla_under_pallas_fft", xla, engine)]


def read_frames(stream, engine, first, count):
    """Frames [first, first + count) of ``stream``, read under FFT
    ``engine`` (None: the default), synchronized."""
    from baseband_tasks_tpu_torch.fourier import fft_maker
    spf = stream.samples_per_frame
    with (fft_maker.set(engine) if engine else contextlib.nullcontext()):
        stream.seek(first * spf)
        out = stream.read(count * spf)
    torch.cuda.synchronize()
    return out


def check_geometry(name, stream, engine):
    """The full-width geometry of each path, and that it runs the
    four-step kernels."""
    n_chan = 128
    if name == "dedisperse_dechannelize":
        ded = stream.ih
        want = (512, 512, 1 << 18, 261120)
        ok = (ded.engine == "pallas" and stream.sample_shape == ()
              and stream.samples_per_frame == 261120 * n_chan)
    else:
        ded = stream
        want = (346, 347, 1 << 18, 2 ** 18 - 693)
        ok = (ded.engine == "xla" and stream.sample_shape == (n_chan,)
              and engine((1 << 18, n_chan), np.complex64)._use_pallas)
    got = (ded.pad_start, ded.pad_end, ded._padded_samples_per_frame,
           ded.samples_per_frame)
    print(f"(e) {name}: pads {got[:2]}, window {got[2]}, "
          f"{got[3]} valid samples per channel per frame, output "
          f"{stream.shape}, {stream.samples_per_frame} samples per frame",
          flush=True)
    if got != want or not ok:
        raise AssertionError(f"{name}: geometry {got}, want {want}")


def drive_task_paths(dev, gpu):
    """Phase (e): both config-2 stream-task paths at full width with the
    kernels, counted, then held against the plain versions on the card."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    src = config2_source(dev)
    kern, plain = task_paths(src, True), task_paths(src, False)
    needs = {"dedisperse_dechannelize": ("k1_window", "k2", "k3_trim"),
             "xla_under_pallas_fft": ("k1_window", "k2_fwd", "k2_inv",
                                      "k3_trim")}
    launches = {}
    for (name, stream, engine), (_, ref_stream, ref_engine) in zip(kern,
                                                                   plain):
        check_geometry(name, stream, engine)
        dd.reset_launch_counts()
        got = read_frames(stream, engine, 0, N_FRAMES)
        counts = dict(dd.launch_counts)
        print(f"(e) {name}: launches {counts}", flush=True)
        missing = [k for k in needs[name] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ref = read_frames(ref_stream, ref_engine, 0, N_FRAMES)
        want = (N_FRAMES * stream.samples_per_frame,) + stream.sample_shape
        err, rel = compare((got.real, got.imag), (ref.real, ref.imag))
        print(f"(e) {name}: {tuple(got.shape)} {got.dtype}, max abs err "
              f"vs plain {err:.3e}, {rel:.3e} of the peak [{gpu}]",
              flush=True)
        if tuple(got.shape) != want or not torch.isfinite(
                torch.view_as_real(got)).all() or rel > FFT_TOL:
            raise AssertionError(f"{name}: output wrong")
        del got, ref
    return launches, kern[0], plain[0]


def time_task_frame(kern, plain, gpu):
    """Phase (f): one frame of Dechannelize(Dedisperse(engine='pallas')),
    kernels against plain versions, in turns (plain, kernels, kernels,
    plain), each turn reading a frame not read before."""
    runs = {"kernels": kern, "plain": plain}
    best = {}
    for frame, key in enumerate(("plain", "kernels", "kernels", "plain"),
                                start=N_FRAMES):
        _, stream, engine = runs[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        read_frames(stream, engine, frame, 1)
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    samples = kern[1].samples_per_frame
    for key, dt in best.items():
        print(f"(f) dedisperse+dechannelize frame {key}: {1e3 * dt:.3f} "
              f"ms/frame, {samples / dt:.4e} samples/s [{gpu}]", flush=True)
    layer_times(kern, N_FRAMES + 4, gpu)
    profile_frame(kern, N_FRAMES + 5, gpu)
    return best


def layer_times(kern, frame, gpu):
    """A kernels frame by layer, host clock around synchronized calls
    (best of two): the source read of the padded window, the
    dedispersion task on it, the Dechannelize task on its output."""
    _, dch, _ = kern
    ded = dch.ih
    src = ded.ih
    start, stop = ded._seek_frame(frame)

    def timed(fn):
        best = np.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, 1e3 * best

    def read_window():
        src.seek(start)
        return src.read(stop - start)
    window, t_src = timed(read_window)
    filtered, t_ded = timed(lambda: ded.task(window))
    _, t_dch = timed(lambda: dch.task(filtered))
    print(f"(f) frame by layer: source read {t_src:.3f} ms, dedisperse "
          f"task {t_ded:.3f} ms, dechannelize task {t_dch:.3f} ms [{gpu}]",
          flush=True)


def profile_frame(kern, frame, gpu):
    """Where a kernels frame's time goes: device time by kernel under
    ``torch.profiler`` (which stretches the frame), and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, stream, engine = kern
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        read_frames(stream, engine, frame, 1)
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows) / 1e3
    print(f"(f) profiled frame: {1e3 * wall:.3f} ms wall, {busy:.3f} ms "
          f"device busy ({busy / (1e3 * wall):.2f}) [{gpu}]", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"(f)   {dev_us / 1e3:8.3f} ms  x{count:<3d} {key[:90]}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from baseband_tasks_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths, log = _build.build()
    print(f"build: {[p.name for p in paths]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
    del kern, plain
    results.update(check_four_step(dev, gpu))
    task_launches, task_kern, task_plain = drive_task_paths(dev, gpu)
    time_task_frame(task_kern, task_plain, gpu)
    print(f"(e) k2 launches on the task paths: {task_launches['k2']}")
    launches.update({k: task_launches[k] for k in KERNELS
                     if k not in FLAGSHIP})
    print(gpu)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **results[name])
        for name, (replaces, source) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
