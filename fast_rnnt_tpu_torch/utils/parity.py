"""On-device parity gate (PyTorch port of ``fast_rnnt_tpu/utils/parity.py``).

The reference runs its backward round-trip self-check on every production
call, on the real device (tf_fast_rnnt_op.cc:110 enabling
mutual_information_cuda.cu:510-514,756-758).  A check per step would stall
the pipeline, so this module packages the same evidence as a gate that a
benchmark or a user runs on the card, before timing, at the shape that is
timed.  It runs on the device of its inputs; on CPU tensors both routes
are the plain versions and the gate checks the plain path alone.

The four checks, each metric beside its JAX counterpart:

  1. ``kernel_vs_plain`` (JAX ``fused_vs_xla``): ``rnnt_loss_simple_pruned``
     with the gradient of ``simple.sum() + pruned.sum()`` w.r.t. (am, lm),
     once as shipped (the CUDA kernels on a CUDA tensor) and once with
     ``set_default_impl("plain")`` and ``set_lattice_build_impl("plain")``
     on the same device.  ``range_agree_frac`` (JAX: the same name) is the
     share of utterances whose ranges agree;
     ``kernel_vs_plain_loss_rel_err`` and ``kernel_vs_plain_grad_rel_err``
     (JAX ``fused_vs_xla_loss_rel_err`` / ``_grad_rel_err``) compare those
     utterances.  ``range_flip_max_gap`` (no JAX counterpart: the JAX
     repository certifies it in ``benchmarks/fuzz_onchip.py``) is the
     largest window-score gap at any raw window-argmax flip between the two
     routes' stage-1 occupancies, ``range_flips`` their number.
  2. ``roundtrip_max_abs_err`` (the same name): the occupancy backward's
     conservation identity at the full input shape (the reference's
     .cu:510-514 check).
  3. ``golden_scores_max_abs_err``, ``golden_grads_max_abs_err`` and
     ``golden_cases`` (the same names): the path-enumeration vectors of
     ``tests/golden`` (float64 first principles, no recursion in their
     derivation), plain and banded, through the shipped route.
  4. ``bf16_loss_rel_err`` and ``bf16_occupancy_rel_err`` (the same
     names): the bf16-lattice mode against float32, and the occupancy
     conservation of a bf16 lattice.

A plain build on a CUDA tensor requires TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), the port's
fp32-faithful contract.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..ops import lattice, recursion
from ..ops.lattice import get_rnnt_logprobs, get_rnnt_logprobs_rows
from ..ops.losses import rnnt_loss_simple_pruned
from ..ops.pruning import _window_argmax, _window_scores
from ..ops.recursion import (
    _normalize_boundary,
    mutual_information_recursion,
    mutual_information_rows,
    occupancy_roundtrip_check,
)

__all__ = ["onchip_parity_gate", "enforce_parity"]

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests", "golden"
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def _rel_err(a, b) -> float:
    a, b = _np(a), _np(b)
    denom = np.maximum(np.abs(b), 1e-6)
    return float(np.max(np.abs(a - b) / denom))


def _abs_err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _scaled_err(a, b) -> float:
    """max |a - b| normalized by the global magnitude of b: the metric for
    gradient tensors, whose entries cross zero (pointwise relative error at
    a zero crossing is noise, not signal)."""
    b = _np(b)
    return _abs_err(a, b) / max(float(np.max(np.abs(b))), 1e-6)


@contextlib.contextmanager
def _routes(impl: Optional[str], build_impl: str) -> Iterator[None]:
    """Both switches set inside the block and restored after it."""
    prev = (recursion._DEFAULT_IMPL, lattice._LATTICE_BUILD_IMPL)
    try:
        recursion.set_default_impl(impl)
        lattice.set_lattice_build_impl(build_impl)
        yield
    finally:
        recursion.set_default_impl(prev[0])
        lattice.set_lattice_build_impl(prev[1])


def onchip_parity_gate(
    am: torch.Tensor,
    lm: torch.Tensor,
    symbols: torch.Tensor,
    boundary: torch.Tensor,
    s_range: int,
    golden_dir: Optional[str] = None,
) -> Dict[str, float]:
    """Run the four parity checks (module docstring) on the device of the
    inputs: am [B, T, C] and lm [B, S+1, C] float32, symbols [B, S] and
    boundary [B, 4] int.  Returns a flat dict of error metrics; see
    :func:`enforce_parity` for the pass/fail limits."""
    out: Dict[str, float] = {}
    B, T, _ = am.shape
    S = symbols.shape[1]
    dev = am.device
    bnd = _normalize_boundary(boundary, B, S, T, device=dev)

    # --- 1. the shipped route against the plain route ---------------------
    def loss_and_grads(lattice_dtype=None, grads=True):
        am_, lm_ = am.detach().clone(), lm.detach().clone()
        if grads:
            am_.requires_grad_(), lm_.requires_grad_()
        with torch.set_grad_enabled(grads):
            simple, pruned, ranges = rnnt_loss_simple_pruned(
                lm_, am_, symbols, 0, s_range, boundary, reduction="none",
                lattice_dtype=lattice_dtype,
            )
            g = torch.autograd.grad(simple.sum() + pruned.sum(), (am_, lm_)) if grads else ()
        return simple.detach(), pruned.detach(), ranges, *g

    @torch.no_grad()
    def stage1():
        px, py = get_rnnt_logprobs_rows(lm, am, symbols, 0, "regular", bnd)
        _, occ = mutual_information_rows(px, py, bnd, calc_gradients=True)
        return occ

    with _routes(None, "auto"):
        s_d, p_d, r_d, ga_d, gl_d = loss_and_grads()
        gx_d, gy_d = stage1()
    with _routes("plain", "plain"):
        s_x, p_x, r_x, ga_x, gl_x = loss_and_grads()
        gx_x, gy_x = stage1()

    # Two correct routes differ in the last float32 bits of the stage-1
    # occupancies, so a window argmax may flip where two windows' scores
    # near-tie, and the monotone repair then carries the flip into other
    # frames: whole-pipeline results legitimately differ on such
    # utterances.  Losses and gradients are compared on the utterances whose
    # ranges agree; the agreement must stay high (a kernel fault craters
    # it), and every raw flip must be a near-tie.
    agree = (r_d == r_x).reshape(B, -1).all(dim=1).cpu().numpy()
    out["range_agree_frac"] = float(agree.mean()) if B else 1.0
    if agree.any():
        m = torch.from_numpy(agree).to(dev)
        out["kernel_vs_plain_loss_rel_err"] = max(
            _rel_err(s_d[m], s_x[m]), _rel_err(p_d[m], p_x[m])
        )
        out["kernel_vs_plain_grad_rel_err"] = max(
            _scaled_err(ga_d[m], ga_x[m]), _scaled_err(gl_d[m], gl_x[m])
        )
    else:  # no agreement is itself a failure (range_agree_frac)
        out["kernel_vs_plain_loss_rel_err"] = float("inf")
        out["kernel_vs_plain_grad_rel_err"] = float("inf")
    K = r_d.shape[2]
    raw_d = _window_argmax(gx_d, gy_d, K)
    raw_x = _window_argmax(gx_x, gy_x, K)
    flips = raw_d != raw_x
    out["range_flips"] = int(flips.sum())
    if out["range_flips"]:
        scores = _window_scores(gx_x, gy_x, K)
        bi, ti = torch.nonzero(flips, as_tuple=True)
        gaps = (scores[raw_d[bi, ti].long(), bi, ti] - scores[raw_x[bi, ti].long(), bi, ti]).abs()
        out["range_flip_max_gap"] = float(gaps.max())
    else:
        out["range_flip_max_gap"] = 0.0
    del ga_x, gl_x, gx_x, gy_x, gx_d, gy_d

    with _routes(None, "auto"), torch.no_grad():
        # --- 2. occupancy round trip at the input shape -------------------
        px, py = get_rnnt_logprobs(lm, am, symbols, 0, "regular", bnd)
        _, (gx, gy) = mutual_information_recursion(px, py, bnd, calc_gradients=True)
        ones = torch.ones((B,), dtype=gx.dtype, device=dev)
        out["roundtrip_max_abs_err"] = float(occupancy_roundtrip_check(gx, gy, bnd, ones).max())

        # --- 3. golden path-enumeration vectors ---------------------------
        files = sorted(glob.glob(os.path.join(golden_dir or GOLDEN_DIR, "*.npz")))
        score_err = grad_err = 0.0
        for path in files:
            z = np.load(path)
            gpx = torch.from_numpy(z["px"].astype(np.float32)).to(dev)
            gpy = torch.from_numpy(z["py"].astype(np.float32)).to(dev)
            gb = torch.from_numpy(z["boundary"]).to(dev)
            if "lo" in z.files:
                s, (ggx, ggy) = mutual_information_rows(
                    gpx.movedim(1, 0).contiguous(), gpy.movedim(1, 0).contiguous(), gb,
                    lo=torch.from_numpy(z["lo"]).to(dev), s_range=int(z["K"]), calc_gradients=True,
                )
                ggx, ggy = ggx.movedim(0, 1), ggy.movedim(0, 1)
            else:
                s, (ggx, ggy) = mutual_information_recursion(gpx, gpy, gb, calc_gradients=True)
            score_err = max(score_err, _abs_err(s, z["scores"]))
            grad_err = max(grad_err, _abs_err(ggx, z["px_grad"]), _abs_err(ggy, z["py_grad"]))
        out["golden_scores_max_abs_err"] = score_err
        out["golden_grads_max_abs_err"] = grad_err
        out["golden_cases"] = len(files)

        # --- 4. the bf16-lattice mode --------------------------------------
        s_b, p_b, _ = loss_and_grads(torch.bfloat16, grads=False)
        out["bf16_loss_rel_err"] = max(_rel_err(s_b, s_d), _rel_err(p_b, p_d))
        _, (bgx, bgy) = mutual_information_recursion(
            px.to(torch.bfloat16), py.to(torch.bfloat16), bnd, calc_gradients=True
        )
        tot = bgx.float().sum((1, 2)) + bgy.float().sum((1, 2))
        expect = (bnd[:, 2] + bnd[:, 3]).float()
        out["bf16_occupancy_rel_err"] = float(((tot - expect).abs() / expect).max())
    return out


# Pass/fail limits: the JAX gate's, under the port's names.  Loss and
# gradient comparisons are relative (per-utterance losses are O(1000) at
# the bench shape; two float32 evaluation orders differ in the last few
# ulps of that magnitude).  The round trip is naturally scaled (seed 1);
# golden shapes are tiny, so absolute error is the sharp criterion there.
TOLERANCES = {
    "kernel_vs_plain_loss_rel_err": 1e-4,
    "kernel_vs_plain_grad_rel_err": 5e-3,  # gradients include ~0-crossing cells
    # a raw window-argmax flip between the routes must be a near-tie
    # (benchmarks/fuzz_onchip.py's TIE_EPS)
    "range_flip_max_gap": 1e-3,
    "roundtrip_max_abs_err": 1e-2,      # fp32, T=1000 lattices
    "golden_scores_max_abs_err": 1e-4,
    "golden_grads_max_abs_err": 5e-4,
    "bf16_loss_rel_err": 2e-2,          # bf16 storage rounding (~0.4% an arc)
    "bf16_occupancy_rel_err": 2e-2,
}

# Metrics that must stay at or above their limit: near-tie flips between the
# routes are legitimate in small numbers, a kernel fault craters agreement
# (the JAX gate's reasoning: ~1000 argmax decisions an utterance against
# ~1e-4 of noise leave a fair share of utterances with one flip; 0.5 stays
# clear of the healthy band).
MINIMUMS = {
    "range_agree_frac": 0.5,
}


def enforce_parity(parity: Dict[str, float]) -> None:
    """Raise FloatingPointError naming every gate metric past its limit
    (NaN counts as a failure)."""
    bad = {
        k: v
        for k, tol in TOLERANCES.items()
        if k in parity and not (float(v := parity[k]) <= tol)
    }
    bad.update(
        {
            k: v
            for k, tol in MINIMUMS.items()
            if k in parity and not (float(v := parity[k]) >= tol)
        }
    )
    if bad:
        lims = {k: TOLERANCES.get(k, MINIMUMS.get(k)) for k in bad}
        raise FloatingPointError(
            f"on-device parity gate FAILED: {bad} (limits: {lims}): the kernels "
            "give wrong numbers; timings are not certified"
        )
