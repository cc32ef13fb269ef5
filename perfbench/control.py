"""The readings that the limits of ``perfbench/limits/`` are set from, at a
cell's own size on the card: the program on many seeds, the control (the
nearest precision below the configuration's) and each fault the cell can
have, planted under the timed call, on a few.  The benchmark's own runs
never run this.

    python3 perfbench/control.py --workload <name> --seed <first> --sound 12 --others 3 \
        [--variants control,half_batch,altered,ranges_shifted] [--cycles 2] [--out FILE]

Each reading is one process-local set-up from the seed, ``--cycles``
cycles of the timed call, and ``check``.  One JSON line a reading is
printed, and the lot written to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--others", type=int, default=3)
    ap.add_argument("--variants", default="control")
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from perfbench import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = harness.cell_files(spec, args.workload)
    import importlib

    import torch

    if not torch.cuda.is_available():
        harness.fail(3, "no CUDA device")
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    runs = [("sound", args.seed + i) for i in range(args.sound)]
    for v in filter(None, args.variants.split(",")):
        runs += [(v, args.seed + i) for i in range(args.others)]
    out = []
    for variant, seed in runs:
        t0 = time.perf_counter()
        kw = {"control": True} if variant == "control" else {}
        if variant not in ("sound", "control"):
            kw["fault"] = variant
        obj = driver.setup(cfg, traffic, seed, "cuda", **kw)
        for _ in range(args.cycles):
            for j in range(obj.n):
                obj.step(j)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        obj.release()
        t1 = time.perf_counter()
        obj.check(limits)
        row = {"workload": args.workload, "variant": variant, "seed": seed,
               "readings": obj.detail["readings"],
               "setup_and_window_s": t1 - t0, "check_s": time.perf_counter() - t1,
               "peak_bytes": peak, "check_peak_bytes": torch.cuda.max_memory_allocated(),
               }
        print(json.dumps(row), flush=True)
        out.append(row)
        del obj
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main(sys.argv[1:]))
