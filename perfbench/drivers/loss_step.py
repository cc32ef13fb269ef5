"""Cells that time one pruned-loss step of the port: the value of
``simple_scale * simple + pruned_scale * pruned`` and its gradient with
respect to (am, lm), over the lattice batches of ``generate.py``.

The traffic's ``pipeline`` names the port's calls:

  * ``simple_pruned``: ``rnnt_loss_simple_pruned`` (one build, the fused
    stage-1 recursion, the ranges, stage 2 band-masked on the same lattice);
  * ``recipe``: icefall's unfused pipeline, ``rnnt_loss_smoothed`` with
    occupancies, ``get_rnnt_prune_ranges``, ``do_rnnt_pruning``, the
    logits ``am_p + lm_p`` and ``rnnt_loss_pruned``.

Both are called with ``reduction="none"`` and summed here, so that the
per-utterance losses of the timed call can be judged.  The answers of the
window's last cycle are kept: every batch's losses and ranges, and of the
cycle's last batch the gradients, the lattice rows that the build handed
on and the occupancies that the ranges were searched on (held, not
copied, so they count in the window's peak memory).  ``check`` holds
every batch of that cycle against ``reference/pruned_loss.py`` in float64
on the same inputs, and the windows exactly against the reference's
search over the program's own occupancies.
"""

from __future__ import annotations

import math

import torch

from .. import compare, generate, roofline
from ..reference import pruned_loss as rl

# faults a test or perfbench/control.py plants under the timed call
FAULTS = ("half_batch", "altered", "ranges_shifted")


def _shift_down(ranges):
    """Every window one symbol lower where it can go: a wrong window search."""
    return ranges - (ranges[:, :, :1] > 0).to(ranges.dtype)


def _control_stage1(frt, lm, am, sym, bnd, traffic):
    """The recipe's stage 1 one step below the stated float32: the port's
    smoothed build (its products at one TF32 pass, set by the caller), the
    lattice stored in bfloat16, and the reference's sweep in float32 in the
    place of the port's recursion, which has no such path of its own.
    (simple, occupancies, the lattice rows as the port's build gives them)."""
    px, py = frt.get_rnnt_logprobs_smoothed(lm, am, sym, 0, traffic["lm_only_scale"],
                                            traffic["am_only_scale"], boundary=bnd)
    px, py = (torch.where(torch.isinf(x), rl.NEG, x).to(torch.bfloat16).float() for x in (px, py))
    score = rl.recursion(px, py, bnd)
    gx, gy = torch.autograd.grad(score.sum(), (px, py), retain_graph=True)
    return -score, (gx, gy), (px.detach().transpose(0, 1), py.detach().transpose(0, 1))


def _pipeline(frt, name, b, s_range, traffic, low=None, shift=False):
    """The timed call: (simple, pruned, ranges, the occupancies that the
    ranges were searched on or None, the lattice rows where the call does
    not hand them to the build's wrapper); ``low`` (the control) stores
    the float32 parts that are no matrix product in bfloat16: the lattice,
    or the pruned logits."""
    lm, am, sym, bnd = b["lm"], b["am"], b["symbols"], b["boundary"]
    if name == "simple_pruned":
        return (*frt.rnnt_loss_simple_pruned(lm, am, sym, 0, s_range, bnd, reduction="none",
                                             lattice_dtype=low), None, None)
    if name == "recipe":
        rows = None
        if low is None:
            simple, (gx, gy) = frt.rnnt_loss_smoothed(
                lm, am, sym, 0, lm_only_scale=traffic["lm_only_scale"],
                am_only_scale=traffic["am_only_scale"], boundary=bnd, reduction="none",
                calc_gradients=True)
        else:
            simple, (gx, gy), rows = _control_stage1(frt, lm, am, sym, bnd, traffic)
        ranges = frt.get_rnnt_prune_ranges(gx, gy, bnd, s_range)
        if shift:
            ranges = _shift_down(ranges)
        am_p, lm_p = frt.do_rnnt_pruning(am, lm, ranges)
        logits = am_p + lm_p if low is None else (am_p + lm_p).to(low)
        pruned = frt.rnnt_loss_pruned(logits, sym, ranges, 0, bnd, reduction="none")
        return simple, pruned, ranges, (gx, gy), rows
    raise ValueError(f"unknown pipeline {name!r}")


class LossCell:
    def __init__(self, cfg, traffic, seed, device, fault=None, control=False):
        import fast_rnnt_tpu_torch as frt
        from fast_rnnt_tpu_torch.ops import losses

        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.frt, self.cfg, self.traffic, self.fault = frt, cfg, traffic, fault
        self.s_range = cfg["s_range"]
        # the control: one step below the stated float32, one TF32 pass in
        # the build's products and bfloat16 for the float32 that is no
        # product (the lattice, the pruned logits), on the port's own paths
        # and, where it has none (the recipe's stage 1), the reference's
        frt.set_matmul_precision("high" if control else cfg["matmul_precision"])
        self.low = torch.bfloat16 if control else None
        self.batches = generate.lattice_batches(cfg, traffic, seed, device)
        for b in self.batches:
            b["am"].requires_grad_(True)
            b["lm"].requires_grad_(True)
        self.n = len(self.batches)
        # the gradients of the cycle's last batch are kept: the seed orders
        # the batches, and the device memory in use is the same in every run
        self.sample = self.n - 1
        self.answers = [None] * self.n
        self.grads = self.lattice = self.occ = None
        self._restore = []
        self._capture_lattice(losses)
        if traffic["pipeline"] == "simple_pruned":
            self._capture_occupancies(losses)
        if fault == "ranges_shifted" and traffic["pipeline"] == "simple_pruned":
            ranges_rows = losses.get_rnnt_prune_ranges_rows
            self._patch(losses, "get_rnnt_prune_ranges_rows",
                        lambda *a, **k: _shift_down(ranges_rows(*a, **k)))
        for _ in range(2):  # every shape the window uses, twice
            for j in range(self.n):
                self.step(j)

    def _patch(self, mod, name, fn):
        self._restore.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def _capture_lattice(self, losses):
        """Keep the lattice rows that the port's build hands to the
        recursion inside the timed call, for the kept batch: the build is
        judged on its own output.  The wrapper adds one Python call and a
        test a step."""
        name = {"simple_pruned": "get_rnnt_logprobs_rows",
                "recipe": "get_rnnt_logprobs_smoothed_rows"}[self.traffic["pipeline"]]
        build = getattr(losses, name)
        self._keep = False

        def kept(*args, **kwargs):
            rows = build(*args, **kwargs)
            if self._keep:
                self.lattice = tuple(r.detach() for r in rows)
            return rows

        self._patch(losses, name, kept)

    def _capture_occupancies(self, losses):
        """Keep the occupancies that the port's window search reads inside
        ``rnnt_loss_simple_pruned``, which does not return them, for the
        kept batch, (B, S, T+1) and (B, S+1, T) views of its s-major rows."""
        search = losses.get_rnnt_prune_ranges_rows

        def kept(gx_rows, gy_rows, *args, **kwargs):
            if self._keep:
                self.occ = (gx_rows.detach().movedim(1, 0), gy_rows.detach().movedim(1, 0))
            return search(gx_rows, gy_rows, *args, **kwargs)

        self._patch(losses, "get_rnnt_prune_ranges_rows", kept)

    def step(self, j):
        b = self.batches[j]
        self._keep = j == self.sample
        if self._keep:  # the kept answers of the last cycle go first
            self.grads = self.lattice = self.occ = None
        tr = self.traffic
        shift = self.fault == "ranges_shifted"
        if self.fault == "half_batch":
            h = b["am"].shape[0] // 2
            half = {k: v[:h] for k, v in b.items()}
            s, p, r, _, _ = _pipeline(self.frt, tr["pipeline"], half, self.s_range, tr, self.low)
            pad = s.new_zeros(b["am"].shape[0] - h)
            s, p = torch.cat([s * 2, pad]), torch.cat([p * 2, pad])
            r = torch.cat([r, r.new_zeros((b["am"].shape[0] - h, *r.shape[1:]))])
        else:
            s, p, r, occ, rows = _pipeline(self.frt, tr["pipeline"], b, self.s_range, tr, self.low,
                                           shift)
            if self._keep and occ is not None:
                self.occ = tuple(o.detach() for o in occ)
            if self._keep and rows is not None:
                self.lattice = rows
        if self.fault == "altered":
            p = p * torch.cat([p.new_full((1,), 1.0 + 1e-3), p.new_ones(p.shape[0] - 1)])
        total = self.cfg["simple_scale"] * s.sum() + self.cfg["pruned_scale"] * p.sum()
        d_am, d_lm = torch.autograd.grad(total, (b["am"], b["lm"]))
        self.answers[j] = (s.detach(), p.detach(), r)
        if self._keep:
            self.grads = (d_am, d_lm)

    def sizes(self):
        return [tuple(int(v) for v in row) for b in self.batches for row in b["boundary"][:, 2:].tolist()]

    def work(self):
        """Each layer's needed (operations, bytes, operation peak) over one
        cycle of the batches."""
        sz, C, K = self.sizes(), self.cfg["C"], self.s_range
        return {
            "recursion": (*roofline.recursion_work(sz, K), roofline.FP32_FLOPS),
            "build": (*roofline.build_work(sz, C), roofline.TF32_FLOPS),
            "ranges": (*roofline.ranges_work(sz, K), roofline.FP32_FLOPS),
            "step": (*roofline.loss_step_work(sz, C), roofline.TF32_FLOPS),
        }

    def release(self):
        self.frt.set_matmul_precision("highest")
        for mod, name, fn in reversed(self._restore):
            setattr(mod, name, fn)
        self._restore = []

    def check(self, limits):
        tr = self.traffic
        worst = {"simple_rel": 0.0, "pruned_rel": 0.0}
        gaps = []
        for j in range(self.n):
            b = self.batches[j]
            s_p, p_p, r_p = self.answers[j]
            kept = j == self.sample
            am = b["am"].detach().double().requires_grad_(kept)
            lm = b["lm"].detach().double().requires_grad_(kept)
            sym, bnd = b["symbols"], b["boundary"]
            px, py = rl.simple_lattice(lm, am, sym, 0, bnd)
            if tr["pipeline"] == "recipe":
                pxs, pys = rl.smoothed_lattice(lm, am, sym, 0, tr["lm_only_scale"],
                                               tr["am_only_scale"], bnd)
            else:
                pxs, pys = px, py
            # the recursions run on detached lattices: each is swept once
            # forward and once back, and d_am, d_lm come from the lattices'
            # gradients through the builds alone
            lx, ly = (x.detach().requires_grad_(True) for x in (pxs, pys))
            simple = -rl.recursion(lx, ly, bnd)
            gx, gy = torch.autograd.grad(simple.sum(), (lx, ly))
            r_ref = rl.prune_ranges(-gx, -gy, bnd, self.s_range)
            # the pruned stage is judged on the program's own ranges, and
            # the ranges apart, by the blank occupancy their windows cover
            bx, by = (x.detach().requires_grad_(kept) for x in (px, py))
            with torch.set_grad_enabled(kept):
                pruned = -rl.recursion(*rl.band_lattice(bx, by, r_p), bnd)
            worst["simple_rel"] = max(worst["simple_rel"], compare.rel(s_p, simple))
            worst["pruned_rel"] = max(worst["pruned_rel"], compare.rel(p_p, pruned))
            gaps.append(compare.cover_gaps(-gy, r_ref, r_p, bnd))
            if kept:
                worst["lattice_err"] = compare.lattice_err(self.lattice, lx.detach(), ly.detach(), bnd)
                if self.occ is not None and self.occ[1].shape[0] == bnd.shape[0]:
                    # the window search is judged on the occupancies that
                    # the program searched, they against the reference's
                    # the search adds in float32 whatever the storage
                    ox, oy = (o.float() for o in self.occ)
                    r_own = rl.prune_ranges(ox, oy, bnd, self.s_range)
                    worst["ranges_mismatch"] = int((r_own != r_p.long()).sum())
                    worst["occ_err"] = compare.occ_err(oy, -gy, bnd)
                hx, hy = torch.autograd.grad(pruned.sum(), (bx, by))
                a, p = self.cfg["simple_scale"], self.cfg["pruned_scale"]
                g_am, g_lm = torch.autograd.grad(
                    (pxs, pys, px, py), (am, lm), (a * gx, a * gy, p * hx, p * hy))
                worst["d_am_l2"] = compare.l2_err(self.grads[0], g_am)
                worst["d_lm_l2"] = compare.l2_err(self.grads[1], g_lm)
            del px, py, pxs, pys, lx, ly, bx, by, simple, gx, gy, pruned, am, lm
        flat = [] if None in gaps else [g for batch in gaps for g in batch]
        # the worst utterance: a fault in one utterance's windows shows whole
        worst["ranges_cover_gap"] = max(flat) if flat else math.inf
        # every reading, the compared ones and those that no limit can hold
        # (perfbench/control.py records them)
        self.detail = {"readings": worst}
        # a number that could not be read (no occupancies kept) fails
        return {k: (worst.get(k, math.inf), lim) for k, lim in limits.items()}


def setup(cfg, traffic, seed, device, fault=None, control=False):
    return LossCell(cfg, traffic, seed, device, fault=fault, control=control)
