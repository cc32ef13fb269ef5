#!/usr/bin/env python3
"""Time the pruning-window kernels of a checkout of the port on one NVIDIA
GPU, warm, cold and inside the training step.

    python3 scripts/ranges_probe.py [--root DIR] [--label NAME]

``--root`` is the root of the checkout whose ``fast_rnnt_tpu_torch`` is
timed (default: this one; an unpacked earlier commit gives the A/B); its
kernels are built into its own ``build/``.  At chip_smoke's headline
shape (B=30, T=1000, S=100, C=500, s_range=5, seed 0), on the float32
occupancies of the fused kernel, it prints one JSON line: the
``ranges.window_starts`` wrapper's ms with the L2 cache warm (10 calls
back to back behind a device-side head start, median of 10), with the L2
flushed before each call (median of 10), and the device time of the
ranges kernels inside the training step (``torch.profiler``, 10 steps of
the gradient of 0.5*simple + pruned), beside the card's name and power
limit.  Run it for two checkouts in one call, in turns (A, B, B, A).
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ranges_probe: no CUDA device", file=sys.stderr)
        return 2
    # chip_smoke's inputs and timers from this checkout, the package from --root
    spec = importlib.util.spec_from_file_location("chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.root))
    import fast_rnnt_tpu_torch as ft
    from fast_rnnt_tpu_torch.ops.kernels import latbuild, ranges, wavefront
    from fast_rnnt_tpu_torch.utils import from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    am, lm, sym, bnd = from_numpy(*cs.make_inputs(0), device=dev)
    px, py = latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)
    _, gx, gy = wavefront.fused_rows(px, py, bnd)
    del px, py

    def call():
        return ranges.window_starts(gy, gx, cs.S_RANGE, bnd, cs.S_RANGE)

    warm = cs.kernel_ms(call)
    cold = cs.cold_ms(call)
    am_g, lm_g = am.clone().requires_grad_(), lm.clone().requires_grad_()

    def train_step():
        s, p, _ = ft.rnnt_loss_simple_pruned(lm_g, am_g, sym, 0, cs.S_RANGE, bnd, reduction="sum")
        return torch.autograd.grad(0.5 * s + p, (am_g, lm_g))

    rows, busy = cs.profile_step(train_step)
    in_step = [(re.search(r"ranges\w*", name).group(0), round(us, 2)) for name, us, _ in rows if "ranges" in name]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "root": os.path.relpath(os.path.abspath(args.root), HERE),
                      "card": smi, "warm_ms": warm, "cold_ms": cold,
                      "in_train_step_us": in_step, "train_step_kernels_us": sum(r[1] for r in rows),
                      "device_busy": busy}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
