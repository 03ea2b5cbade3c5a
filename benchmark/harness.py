"""Run one cell of ``BENCHMARK.json`` once and make its result line.

A run: load the cell's configuration, traffic mix, system and reference
by name; set up (the system's feed builds the port's entry and the
inputs from the seed and warms up every shape the traffic uses); run the
closed-loop window; read the peak device memory; free the program's
state; compare every unit the window produced with the plain reference;
print the numbers compared and the result line.

The closed loop (the one general generator): unit ``i`` starts as soon
as unit ``i - 1`` has its output on the host, for ``--seconds``; the
window ends when the last unit started in it ends.  A unit is one
sub-integration of the traffic mix.  With ``--trace 1``,
``trace_units`` units run under ``torch.profiler`` first, then the
window; the span metrics read the window's units.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "baseband_tasks_tpu")


def load_spec(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_of(spec, name):
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec, name):
    for cfg in spec["configs"]:
        if cfg["name"] == name:
            with open(ROOT / cfg["file"]) as fh:
                return json.load(fh)
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name):
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"benchmark_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``baseband_tasks_tpu_torch`` is not
    ``baseband_tasks_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """Host spans of the benchmark's own code around calls into the
    program: per name, a list of (seconds, weight).  Each span is also a
    ``record_function`` range, so a trace shows it."""

    def __init__(self):
        self.records = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name, weight=1):
        with torch.profiler.record_function(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                self.records[name].append((time.perf_counter() - t, weight))

    def clear(self):
        self.records.clear()


def run_units(feed, start, count=None, until=None):
    """Units ``start, start + 1, ...`` back to back: ``count`` of them, or
    as many as start before the host clock passes ``until``; returns
    (latencies, outputs as (key, output), end time)."""
    lat, outs, end, i = [], [], time.perf_counter(), start
    while (i - start < count) if count is not None else \
            (time.perf_counter() < until):
        a = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            out = feed.unit(i)
        end = time.perf_counter()
        lat.append(end - a)
        outs.append((feed.key(i), out))
        i += 1
    return lat, outs, end


def check_outputs(reference, cfg, traffic, data, outs, device,
                  control=False):
    """Compare every unit's output with the reference: returns (numbers
    as {name: worst value}, units failed, and with ``control`` the
    control's numbers and the keys it failed: the reference computed in
    bfloat16, put in the program's place for every key and judged by the
    same limits)."""
    keys = sorted({k for k, _ in outs})
    refs = reference.expected(cfg, traffic, data, keys, device)
    worst = {name: 0.0 for name in reference.LIMITS}
    failed = 0
    for key, out in outs:
        nums = reference.compare(out, refs[key])
        failed += any(nums[n] > reference.LIMITS[n] for n in nums)
        for n, v in nums.items():
            worst[n] = max(worst[n], v)
    ctl = None
    if control:
        low = reference.expected(cfg, traffic, data, keys, device,
                                 precision="bfloat16")
        ctl = {"numbers": {name: 0.0 for name in reference.LIMITS},
               "failed": 0, "keys": len(keys)}
        for key in keys:
            nums = reference.compare(low[key], refs[key])
            ctl["failed"] += any(nums[n] > reference.LIMITS[n] for n in nums)
            for n, v in nums.items():
                ctl["numbers"][n] = max(ctl["numbers"][n], v)
    return worst, failed, ctl


def run_cell(spec, cell, seed, seconds, trace, device, t_start,
             cfg=None, traffic=None, control=False):
    """One run of ``cell``; returns (result dict, stderr lines).
    ``cfg``/``traffic`` replace the cell's files (the CPU tests' small
    sizes); ``control`` adds the control's numbers (``control.py``)."""
    cfg = cfg or config_of(spec, cell["config"])
    traffic = traffic or traffic_of(cell["traffic"])
    system = module("systems", cfg["system"])
    reference = module("reference", cfg["reference"])
    spans = Spans()
    cuda = device.type == "cuda"
    feed = system.make_feed(cfg, traffic, int(seed), device, spans)
    feed_build_s = getattr(feed, "build_s", None)
    try:
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        spans.clear()
        tr, outs, lat = None, [], []
        if trace:
            (lat, outs, _), tr = trace_mod.traced(
                lambda: run_units(feed, 0, count=int(traffic["trace_units"])),
                device)
            spans.clear()      # the span metrics read the untraced units
        t0 = time.perf_counter()
        more_lat, more_outs, end = run_units(feed, len(outs),
                                             until=t0 + seconds)
        lat += more_lat
        outs += more_outs
        window_s = end - t0
        peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
        data = feed.reference_data()
        n_units = len(outs)
        samples = len(more_outs) * feed.samples_per_unit
        unit_work = feed.work_per_unit()
        feed.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers, failed, ctl = check_outputs(reference, cfg, traffic, data,
                                             outs, device, control)
    finally:
        feed.close()
    correct = n_units > 0 and failed == 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {"correct": correct, "attempted": n_units, "failed": failed}
    if trace:
        ctx = SimpleNamespace(
            trace=tr, spans=spans.records,
            work=tuple(w * int(traffic["trace_units"]) for w in unit_work))
        for m in spec["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        lat_ms = np.asarray(lat) * 1e3
        e2e = {"samples_per_s": samples / window_s if window_s > 0 else 0.0,
               "subint_ms_p95": (float(np.percentile(lat_ms, 95))
                                 if lat else 0.0),
               "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    if feed_build_s is not None:
        # the kernels' build (nvcc on a checkout's first run), part of
        # setup_s, recorded apart
        result["build_s"] = feed_build_s
    if ctl is not None:
        # the control is correct only where it fails no key
        result["control"] = ctl["numbers"]
        result["control_correct"] = ctl["failed"] == 0
    result["check"] = {n: {"value": v, "limit": reference.LIMITS[n]}
                       for n, v in numbers.items()}
    lines = [f"check {n}: {v!r} (limit {reference.LIMITS[n]!r})"
             for n, v in numbers.items()]
    lines.append(f"check units: {n_units} attempted, {failed} failed")
    if feed_build_s is not None:
        lines.insert(0, f"setup: {setup_s:.3f} s, of which the kernels' "
                     f"build {feed_build_s:.3f} s")
    if lat:
        # the window's shape: unit time by quarter of the units, for a
        # reader looking for drift or a stall
        arr = np.asarray(lat)
        q = [float(np.median(part)) * 1e3 for part in
             np.array_split(arr, 4) if len(part)]
        slow = arr[arr > 2 * np.median(arr)]
        lines.insert(0, "window: unit ms median by quarter "
                     + ", ".join(f"{v:.3f}" for v in q)
                     + f"; max {arr.max() * 1e3:.3f}; {len(slow)} units "
                     f"over twice the median, {slow.sum() * 1e3:.1f} ms")
    return result, lines


def main(args, t_start):
    spec = load_spec()
    cell = cell_of(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_cell(spec, cell, args.seed, args.seconds,
                             bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
