"""One run of one benchmark cell: set-up, the measured window, the
per-layer readings, the check against the plain reference, the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name that ``BENCHMARK.json`` gives:

  * ``perfbench/configs/<config>.json``  (the entry's ``file``)
  * ``perfbench/traffic/<traffic>.json``  parameters of the generator; its
    ``driver`` names ``perfbench/drivers/<driver>.py``
  * ``perfbench/limits/<workload>.json``  the limit of each compared number
  * ``perfbench/metrics/<metric>.py``  a ``read(ctx)`` that returns the
    metric, or None where it finds nothing to read

The window is a closed loop of whole cycles of the traffic's batches, with
no host read, until ``--seconds`` have passed on the host clock, then
``torch.cuda.synchronize()``.  ``--trace 1`` instead runs
``trace_cycles`` cycles under ``torch.profiler`` and reads the per-layer
metrics from the device's kernels.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fast_rnnt_tpu"}


def fail(code: int, msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str, root: Path = ROOT):
    """(workload entry, config, traffic, limits) of a cell, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        fail(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(root / entry["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """Names of the metrics this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric without ``workloads``
    belongs to every cell that reports the metric it moves."""
    e2e = [m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    return [m["name"] for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


def metric_reader(name: str, root: Path = ROOT):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_kernels(root: Path, pattern: str) -> set:
    """Names of the ``__global__`` functions in the port's CUDA sources
    whose file name matches ``pattern`` (a glob under csrc/)."""
    names = set()
    for f in sorted((root / "fast_rnnt_tpu_torch" / "csrc").glob(pattern)):
        text = f.read_text()
        names.update(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(", text))
    return names


def kernel_is(name: str, names: set) -> bool:
    return any(re.search(rf"\b{n}\s*[<(]", name) for n in names)


def _union(spans):
    spans = sorted(spans)
    total, (lo, hi) = 0.0, spans[0]
    merged = []
    for a, b in spans[1:]:
        if a > hi:
            merged.append((lo, hi))
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    merged.append((lo, hi))
    return total + hi - lo, merged


def read_trace(prof) -> dict:
    """Kernels (name, seconds), device busy seconds, and the breakdown:
    the device operations that took most time and the longest idle gaps,
    each named by the innermost host operation running when it began."""
    import torch

    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        fail(5, "the profiler saw no device activity")
    busy_us, merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    kernels = [(e.name, e.time_range.elapsed_us() * 1e-6) for e in dev
               if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in dev:
        by_name[e.name[:200]] = by_name.get(e.name[:200], 0.0) + e.time_range.elapsed_us() * 1e-6
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda r: r[0])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:10]
    idle = []
    for length, at in gaps:
        inner = [(end - start, name) for start, end, name in host if start <= at <= end]
        idle.append([min(inner)[1] if inner else "no host operation", length * 1e-6])
    return {
        "kernels": kernels,
        "busy_s": busy_us * 1e-6,
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda r: -r[1])[:10]],
            "idle_gaps": idle,
        },
    }


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, fault=None, control=False):
    """Set-up, window and check of one cell, everything a run does but the
    look for a chip: (result without its device, checks, readings).  ``fault`` and
    ``control`` plant under the timed call what perfbench/control.py and the
    tests plant; a benchmark run passes neither."""
    import torch

    spec = load_json(root / "BENCHMARK.json")
    cell, cfg, traffic, limits = cell_files(spec, workload, root)
    readers = {n: metric_reader(n, root) for n in cell_metrics(spec, workload, trace)}
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    kw = {"fault": fault} if fault else {}
    obj = driver.setup(cfg, traffic, seed, device, control=control, **kw)
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = {"steps": 0, "cycles": 0, "work": obj.work(), "root": root}
    t0 = time.perf_counter()
    ctx["setup_s"] = t0 - t_process
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        # the metrics' window: device activity only, so that the profiler
        # adds little host time to a host-bound step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traffic["trace_cycles"]):
                for j in range(obj.n):
                    obj.step(j)
                    ctx["steps"] += 1
                ctx["cycles"] += 1
            _sync(device)
            ctx["window_s"] = time.perf_counter() - t0
        ctx.update(read_trace(prof))
        # one more cycle with the host's operations, to name the idle gaps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for j in range(obj.n):
                with record_function(f"perfbench.step.{j}"):
                    obj.step(j)
            _sync(device)
        ctx["breakdown"]["idle_gaps"] = read_trace(prof)["breakdown"]["idle_gaps"]
        del prof
    else:
        while True:
            for j in range(obj.n):
                obj.step(j)
                ctx["steps"] += 1
            ctx["cycles"] += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        ctx["window_s"] = time.perf_counter() - t0
    ctx["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in readers:
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    obj.release()
    t_check = time.perf_counter()
    checks = obj.check(limits)
    ctx["check_s"] = time.perf_counter() - t_check
    result = {
        "correct": all(math.isfinite(v) and v <= lim for v, lim in checks.values()),
        "attempted": ctx["steps"], "failed": 0, "metrics": metrics,
    }
    if trace:
        result["breakdown"] = ctx["breakdown"]
    return result, checks, ctx


def main(argv, t_process: float) -> int:
    args = parse(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = cell_files(spec, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(3, f"{args.workload} needs {cell['chips']} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    try:
        import fast_rnnt_tpu_torch
    except ImportError as e:
        fail(4, f"the port does not import from {ROOT}: {e}")
    if Path(fast_rnnt_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(4, f"fast_rnnt_tpu_torch came from {fast_rnnt_tpu_torch.__file__}, not {ROOT}")

    result, checks, ctx = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_process)
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        fail(6, f"the run loaded {', '.join(found)}: the benchmark measures the port alone")
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell["chips"],
        "memory_peak_bytes": ctx["peak_bytes"],
        "power": power_limit(),
    }
    if args.trace:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
    breakdown = result.pop("breakdown", None)
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(f"perfbench: {args.workload} seed {args.seed}: set-up {ctx['setup_s']:.3f} s, "
          f"{ctx['steps']} steps in {ctx['window_s']:.3f} s, check {ctx['check_s']:.3f} s, "
          f"{device['kind']}, {device['power']}",
          file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
