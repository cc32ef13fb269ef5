#!/usr/bin/env python3
"""Quick check of the port's recursion kernels on one NVIDIA GPU.

    python3 scripts/sweep_probe.py

Builds the kernels, then on small ragged cases (several 128-row strips,
bands, non-zero begins, S = 0) in float32, bfloat16 and float16 storage
holds the sweep pair (``forward_rows`` / ``backward_rows``) to its plain
versions (p in every cell; the backward on random seeds, one of them 0),
to the fused kernel bit for bit when seeded with ones, and to itself on a
second run; runs the forward at T = 20000 against float64; and times the
sweep pair against the row scans in turns at chip_smoke's headline lattice
(B=30, T=1000, S=100, C=500, seed 0), unbanded and under the stage-2 band
of its own ranges.  Exits non-zero on a failed check.  A lighter probe
than chip_smoke.py, for iterating on the recursion kernels.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from fast_rnnt_tpu_torch.ops.kernels import _build, latbuild, ranges  # noqa: E402
from fast_rnnt_tpu_torch.ops.kernels import wavefront as wf  # noqa: E402
from fast_rnnt_tpu_torch.utils import from_numpy  # noqa: E402

CASES = [(3, 6, 20, False, False, False), (3, 6, 20, True, True, True), (2, 0, 9, False, False, False),
         (3, 130, 150, False, False, True), (3, 130, 150, True, True, True), (3, 9, 1200, False, True, True),
         (2, 300, 90, True, False, True), (2, 260, 70, False, True, False)]


def main():
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.load_library()
    print(torch.cuda.get_device_name(0), "build", f"{_build.BUILD_LOG['seconds']:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    bad = 0
    for case in CASES:
        px, py, bnd, lo, K = from_numpy(*cs.rand_case(rng, *case), device=dev)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x, y = px.to(dt), py.to(dt)
            step = cs.STORAGE_STEP[str(dt).split(".")[1]]
            try:
                p_k, sc_k = wf.forward_rows(x, y, bnd, lo, K)
                p_p, sc_p = wf.forward_rows_plain(x, y, bnd, lo, K)
                e_p = cs.finite_err(p_k, p_p, "p", 1e-4, 1e-5)[0]
                e_s = cs.finite_err(sc_k, sc_p, "scores", 1e-4, 1e-5)[0]
                ag = torch.randn(case[0], device=dev)
                ag[0] = 0.0
                g_k = wf.backward_rows(x, y, p_k, bnd, ag, lo, K)
                g_p = wf.backward_rows_plain(x, y, p_k, bnd, ag, lo, K)
                e_g = max(cs.finite_err(a, b, "occupancy", 1e-5, 1e-4 + step)[0] for a, b in zip(g_k, g_p))
                ones = torch.ones(case[0], device=dev)
                pair = (sc_k, *wf.backward_rows(x, y, p_k, bnd, ones, lo, K))
                same = all(torch.equal(a, b) for a, b in zip(wf.fused_rows(x, y, bnd, lo, K), pair))
                det = all(torch.equal(a, b) for a, b in zip(g_k, wf.backward_rows(x, y, p_k, bnd, ag, lo, K)))
                print(case, dt, f"max abs err p {e_p:.3e} scores {e_s:.3e} occupancies {e_g:.3e}; "
                      f"pair == fused {same}; deterministic {det}", flush=True)
                bad += not (same and det)
            except cs.Failed as e:
                bad += 1
                print(case, dt, "FAILED", e, flush=True)
    px, py, bnd = from_numpy(*cs.rand_case(np.random.default_rng(3), 2, 12, 20000, False, False, False)[:3],
                             device=dev)
    sc_k = wf.forward_rows(px, py, bnd)[1]
    sc_p = wf.forward_rows_plain(px.double(), py.double(), bnd)[1]
    rel = ((sc_k.double() - sc_p).abs() / sc_p.abs()).max().item()
    print(f"T=20000 scores rel err vs float64 {rel:.3e}", flush=True)
    bad += not rel <= 1e-5

    am, lm, sym, bnd = from_numpy(*cs.make_inputs(0), device=dev)
    px, py = latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)
    _, gx, gy = wf.fused_rows(px, py, bnd)
    lo = ranges.window_starts(gy, gx, cs.S_RANGE, bnd, cs.S_RANGE)
    ones = torch.ones(cs.B, device=dev)
    for name, band in (("full", ()), ("banded", (lo, cs.S_RANGE))):
        p = wf.forward_rows(px, py, bnd, *band)[0]
        ps = wf.forward_rows_scan(px, py, bnd, *band)[0]
        f = cs.in_turns(lambda: wf.forward_rows_scan(px, py, bnd, *band), lambda: wf.forward_rows(px, py, bnd, *band))
        b = cs.in_turns(lambda: wf.backward_rows_scan(px, py, ps, bnd, ones, *band),
                        lambda: wf.backward_rows(px, py, p, bnd, ones, *band))
        print(f"{name}: in turns scan, sweep, sweep, scan: fwd " + ", ".join(f"{t:.4f}" for t in f)
              + " ms; bwd " + ", ".join(f"{t:.4f}" for t in b) + " ms", flush=True)
    print(f"fused {cs.cuda_ms(lambda: wf.fused_rows(px, py, bnd)):.4f} ms", flush=True)
    print("failed checks:", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
