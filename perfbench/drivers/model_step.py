"""Cells that time one training step of icefall's pruned-transducer
conformer through the port's normal path: ``init_model`` ->
``make_train_step`` (Adam) -> ``pruned_transducer_loss`` -> the loss ops
(``rnnt_loss_smoothed`` with occupancies, ``get_rnnt_prune_ranges``,
``do_rnnt_pruning``, the joiner, ``rnnt_loss_pruned``), over speech batches
drawn here: each batch one duration bucket of the traffic, filled to
``max_duration`` seconds of audio.

A step is one ``make_train_step`` call, with no host read.  Each step the
driver copies the joiner's parameters (one ``torch.cat``), and holds,
without copying, what the step hands on: am and lm as the model gave them,
the occupancies that the windows were searched on, the windows and the
losses.  Before the cycle's last step (the judged one) it copies the
parameters and Adam's moments, on the device (one ``torch.cat`` into a
flat buffer made at set-up); after it the gradients (``.grad``) and the
parameters Adam made are there to read.  ``check``, after ``release``,
holds the window's last cycle against ``reference/icefall_conformer.py``:

  * ``simple_rel``, ``pruned_rel``: each step's losses against the
    reference's losses of the same am and lm, in float64, the pruned one on
    the step's windows with the joiner's parameters of the step; the worst
    step;
  * ``ranges_mismatch``: each step's windows against the reference's search
    over the occupancies the step searched (exact, as the c500 cells hold
    them), summed over the cycle;
  * ``grad_l2``, ``grad_l2_median``: the last step's gradient against the
    reference's float32 gradient on the kept parameters and the batch (the
    pruned stage on the program's windows), relative L2 over the held
    parameter tensors together, and of the median held tensor (a gradient
    of 0 reads 1);
  * ``update_rel_worst``: the parameters' change by the step against the
    change that the reference's Adam makes from the kept parameters and
    moments with the step's own gradients, relative L2 of the worst tensor
    (a tensor the step left unchanged reads 1): Adam's step;
  * ``update_ref_rel``, ``update_ref_rel_median``: the same with the
    reference's gradients, over the held tensors together and of the median
    one: the whole step, gradient and Adam, where Adam's moments carry the
    steps before.

A tensor is held where its reference gradient's norm is at least
``HELD_SHARE`` of the largest in its group (:func:`group`): below that the
gradient is small against the sums it is made of, and rounding sets it, as
in the conv modules' depthwise biases (BatchNorm removes each channel's
mean right after them) and the lower blocks' position terms.  The
gradient's worst held tensor is read, not compared: the bf16 backward sets
the conv modules' input side (``ln_in``, ``pw_in``) of the lower blocks,
whose gradient is ~1e-9 of the step's, to within 0.1-0.75 of the float32
one.  So is the worst tensor of the whole step: Adam gives each element a
step of the same size, so a part of a tensor whose gradient is 0 but for
rounding (the attention's key bias, which the softmax cancels) takes steps
as large as the rest, in directions of the rounding.  Read besides: the
whole model's ``update_rel``, the reference's losses of the whole model
(``model_simple_rel``, ``model_pruned_rel``, which move with the bf16
layers), and the share of the gradient's norm in the tensors left out, the
program's and the reference's (PERF.md section 2).

A run on a CPU device is a test's: it takes the configuration's and the
traffic's ``cpu`` sizes (the harness runs a cell only on a CUDA device).
"""

from __future__ import annotations

import gc
import math
from typing import List

import numpy as np
import torch

from .. import compare, generate, model_work, roofline
from ..reference import icefall_conformer as ref
from ..reference import pruned_loss as rl

# faults a test or perfbench/control.py plants under the timed call: half
# the batch, the pruned loss x 1.001, stage 1's lm_only_scale 1% high
FAULTS = ("half_batch", "altered", "lm_scale")
# a parameter tensor whose reference gradient's norm is less than this share
# of the largest in its group (group()) is set by rounding, and is left out
# of the gradient's and the whole step's numbers (module docstring)
HELD_SHARE = 1e-3


def group(name: str) -> str:
    """A parameter's group for ``HELD_SHARE``: its conformer block
    (``encoder.blocks.<i>``), or outside the blocks its own module."""
    parts = name.split(".")
    if parts[:2] == ["encoder", "blocks"]:
        return ".".join(parts[:3])
    return ".".join(parts[:-1])


def durations(traffic: dict) -> List[np.ndarray]:
    """Per batch the utterances' durations in seconds, from ``sizes_seed``:
    U[(1 - spread) c, (1 + spread) c] about the bucket's centre c, drawn
    until the next would pass ``max_duration``."""
    rng = generate.host_rng(traffic["sizes_seed"])
    out = []
    for c in traffic["centres"]:
        lo, hi = c * (1 - traffic["spread"]), c * (1 + traffic["spread"])
        d, total = [], 0.0
        while True:
            x = float(rng.uniform(lo, hi))
            if total + x > traffic["max_duration"]:
                break
            d.append(x)
            total += x
        out.append(np.array(d))
    return out


def speech_batches(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """The cycle's batches: features (B, T_in, F) N(0, 1) with padded frames
    0, feature_lens, symbols (B, S) U[1, V) with padding 0, symbol_lens;
    the batches and each batch's rows in an order drawn from ``seed``."""
    rng = generate.host_rng(seed)
    g = generate.card_generator(seed, device)
    sizes = durations(traffic)
    out = []
    for i in rng.permutation(len(sizes)):
        d = sizes[i][rng.permutation(len(sizes[i]))]
        t_in = np.rint(d * traffic["frames_per_second"]).astype(np.int64)
        s = np.rint(d * traffic["symbols_per_second"]).astype(np.int64)
        B, T_in, S = len(d), int(t_in.max()), int(s.max())
        t_lens = torch.from_numpy(t_in).to(device)
        s_lens = torch.from_numpy(s).to(device)
        feats = torch.randn((B, T_in, cfg["feature_dim"]), generator=g, device=device)
        feats = feats * (torch.arange(T_in, device=device)[None, :, None] < t_lens[:, None, None])
        sym = torch.randint(1, cfg["vocab_size"], (B, S), generator=g, device=device)
        sym = sym * (torch.arange(S, device=device)[None, :] < s_lens[:, None])
        out.append({"features": feats, "feature_lens": t_lens, "symbols": sym.to(torch.int32),
                    "symbol_lens": s_lens})
    return out


def transducer_config(cfg: dict):
    from fast_rnnt_tpu_torch.models import TransducerConfig

    d = cfg["d_model"]
    if cfg["decoder_dim"] != d or cfg["subsampling_channels"] != d or cfg["ff_dim"] % d:
        raise ValueError("the port's predictor embeds and its subsampling convs run at d_model, "
                         "and its feed-forward is a multiple of d_model")
    return TransducerConfig(
        recipe=cfg["recipe"], vocab_size=cfg["vocab_size"], feature_dim=cfg["feature_dim"],
        d_model=cfg["d_model"], num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
        ff_mult=cfg["ff_dim"] // cfg["d_model"], conv_kernel=cfg["conv_kernel"],
        predictor_context=cfg["context_size"], blank_id=cfg["blank_id"],
        dtype=getattr(torch, cfg["dtype"]))


def _half(batch: dict) -> dict:
    h = batch["features"].shape[0] // 2
    return {k: v[:h] for k, v in batch.items()}


class ModelCell:
    def __init__(self, cfg, traffic, seed, device, fault=None, control=False):
        from fast_rnnt_tpu_torch.models import (LossConfig, init_model, make_train_step,
                                                training)

        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        if torch.device(device).type == "cpu":
            cfg = {**cfg, **cfg["cpu"]}
            traffic = {**traffic, **traffic["cpu"]}
        self.cfg, self.traffic, self.fault, self.control = cfg, traffic, fault, control
        self.training = training
        self.model = init_model(transducer_config(cfg), device,
                                generator=torch.Generator().manual_seed(seed % (1 << 63)))
        self.params = [p for p in self.model.parameters()]
        self.names = [n for n, _ in self.model.named_parameters()]
        # one fused kernel for every parameter (the multi-tensor one takes
        # 8-28 ms of host time a step on the card's host)
        self.opt = torch.optim.Adam(self.params, lr=cfg["lr"], betas=tuple(cfg["betas"]),
                                    eps=cfg["eps"], weight_decay=0.0,
                                    fused=torch.device(device).type == "cuda")
        lm_scale = cfg["lm_scale"] * (1.01 if fault == "lm_scale" else 1.0)
        self.loss_cfg = LossConfig(s_range=cfg["s_range"], simple_scale=cfg["simple_loss_scale"],
                                   pruned_scale=1.0, lm_only_scale=lm_scale,
                                   am_only_scale=cfg["am_scale"])
        self.train = make_train_step(self.model, self.opt, self.loss_cfg)
        self.batches = speech_batches(cfg, traffic, seed, device)
        self.n = len(self.batches)
        self.sample = self.n - 1  # the judged step: the cycle's last batch
        self.kept = None
        # per step of the cycle what check() holds: am, lm, occupancies,
        # windows, losses and the joiner's parameters of the step
        self.held = [{} for _ in range(self.n)]
        self._cur = {}
        joiner = self.model.joiner.out
        self.joiner = [joiner.weight, joiner.bias]
        self.joiner_kept = torch.empty((self.n, sum(t.numel() for t in self.joiner)),
                                       device=device)
        self._restore = []
        self._capture()
        for _ in range(2):  # every shape the window uses, twice; Adam's moments exist after
            for j in range(self.n):
                self.step(j)
        self.live = [*self.params, *(self.opt.state[p][m] for m in ("exp_avg", "exp_avg_sq")
                                     for p in self.params)]
        self.flat = torch.empty(sum(t.numel() for t in self.live), device=device)
        self.kept = [x.view_as(t) for x, t in zip(self.flat.split([t.numel() for t in self.live]),
                                                   self.live)]
        # the set-up's objects (the imports and the model, ~280,000) leave the
        # collector's scans until release(): a full collection over them takes
        # ~280 ms on the card's host, and would fall in the window at random
        gc.freeze()

    def _patch(self, obj, name, fn):
        self._restore.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def _capture(self):
        """Hold, for the step, am and lm as the model gave them, the
        occupancies and the windows; the control stores am, lm and the
        joiner's logits in bfloat16 from there on (one step below the
        float32 that the configuration states for them)."""
        tr, model = self.training, self.model
        forward, join = model.forward, model.join
        search, pruned = tr.get_rnnt_prune_ranges, tr.rnnt_loss_pruned

        def low(x):
            return x.to(torch.bfloat16).float() if self.control else x

        def fwd(*args):
            am, lm, _, _, lens = forward(*args)
            self._cur["am_lm"] = (am.detach(), lm.detach())
            am, lm = low(am), low(lm)
            return am, lm, am, lm, lens

        def searched(px_grad, py_grad, *args, **kwargs):
            ranges = search(px_grad, py_grad, *args, **kwargs)
            self._cur["occ"] = (px_grad.detach(), py_grad.detach())
            self._cur["ranges"] = ranges
            return ranges

        def altered(*args, **kwargs):
            return pruned(*args, **kwargs) * (1.0 + 1e-3)

        self._patch(model, "forward", fwd)
        self._patch(model, "join", lambda am_p, lm_p: low(join(am_p, lm_p)))
        self._patch(tr, "get_rnnt_prune_ranges", searched)
        if self.fault == "altered":
            self._patch(tr, "rnnt_loss_pruned", altered)

    def step(self, j):
        b = self.batches[j]
        self._cur = self.held[j]
        with torch.no_grad():
            torch.cat([t.view(-1) for t in self.joiner], out=self.joiner_kept[j])
            if j == self.sample and self.kept is not None:
                # one copy on the device (torch._foreach_copy_ takes ~0.2 ms of
                # host time a tensor, over a thousand of them)
                torch.cat([t.view(-1) for t in self.live], out=self.flat)
        if self.fault == "half_batch":
            h = _half(b)
            m = self.train((h["features"], h["feature_lens"], h["symbols"], h["symbol_lens"]))
            m = {k: v * 2 for k, v in m.items()}
        else:
            m = self.train((b["features"], b["feature_lens"], b["symbols"], b["symbol_lens"]))
        self._cur["answers"] = m

    def work(self):
        """Over one cycle of the batches, the needed (operations, bytes,
        operation peak) of the model and its attention (perfbench/model_work.py)
        and of the loss chain's kernels (perfbench/roofline.py, as the c500
        cells count them: C the vocabulary, K the prune range)."""
        sizes = [(b["feature_lens"].tolist(), b["symbol_lens"].tolist()) for b in self.batches]
        work = model_work.step_work(self.cfg, sizes, self.cfg["s_range"],
                                    sum(p.numel() for p in self.params))
        st = [(s, model_work.frames(t)[1]) for t_in, s_in in sizes for t, s in zip(t_in, s_in)]
        C, K = self.cfg["vocab_size"], self.cfg["s_range"]
        work["recursion"] = (*roofline.recursion_work(st, K), roofline.FP32_FLOPS)
        work["build"] = (*roofline.build_work(st, C), roofline.TF32_FLOPS)
        work["ranges"] = (*roofline.ranges_work(st, K), roofline.FP32_FLOPS)
        return work

    def release(self):
        gc.unfreeze()
        for obj, name, fn in reversed(self._restore):
            if obj is self.model:
                delattr(obj, name)  # the instance's wrapper goes, the class's method is back
            else:
                setattr(obj, name, fn)
        self._restore = []

    def _losses(self, readings):
        """Each step's losses and windows against the reference's, on the
        step's own am, lm, occupancies and joiner parameters."""
        cfg = self.cfg
        worst = {"simple_rel": 0.0, "pruned_rel": 0.0}
        mismatch = 0
        shapes = [t.shape for t in self.joiner]
        for j, h in enumerate(self.held):
            b = self.batches[j]
            am, lm = (x.double() for x in h["am_lm"])
            B = am.shape[0]
            bnd = ref.boundary(ref.out_lengths(b["feature_lens"][:B]), b["symbol_lens"][:B])
            w, bias = self.joiner_kept[j].split([math.prod(sh) for sh in shapes])
            joiner = {"joiner.out.weight": w.view(shapes[0]).double(),
                      "joiner.out.bias": bias.view(shapes[1]).double()}
            with torch.no_grad():
                simple = ref.simple_loss(am, lm, b["symbols"][:B], bnd, cfg).sum()
                pruned = ref.pruned_loss(joiner, am, lm, b["symbols"][:B], h["ranges"], bnd,
                                         cfg).sum()
            for key, loss, want in (("simple_rel", "simple_loss", simple),
                                    ("pruned_rel", "pruned_loss", pruned)):
                worst[key] = max(worst[key], compare.rel(h["answers"][loss], want))
            # the windows against the search over the step's own occupancies
            ox, oy = (o.float() for o in h["occ"])
            r_own = rl.prune_ranges(ox, oy, bnd, cfg["s_range"])
            mismatch += int((r_own != h["ranges"].long()).sum())
        readings.update(worst, ranges_mismatch=mismatch)

    def _step(self, readings):
        """The last step in float32 against the reference's: the gradients
        and the update, by tensor and over the whole model."""
        cfg = self.cfg
        b = self.batches[self.sample]
        h = self.held[self.sample]
        k = len(self.params)
        kept_p, kept_m, kept_v = self.kept[:k], self.kept[k:2 * k], self.kept[2 * k:]
        kept = dict(zip(self.names, kept_p))
        with ref.exact_float32():
            s_m, p_m, grads = ref.loss_and_grads(
                kept, cfg, b["features"], b["feature_lens"], b["symbols"], b["symbol_lens"],
                h["ranges"])
        readings["model_simple_rel"] = compare.rel(h["answers"]["simple_loss"], s_m)
        readings["model_pruned_rel"] = compare.rel(h["answers"]["pruned_loss"], p_m)
        got = [p.grad for p in self.params]
        want = [grads[n] for n in self.names]
        ref_sq = [float((w ** 2).sum()) for w in want]
        got_sq = [float((g.double() ** 2).sum()) for g in got]
        top = {}
        for n, r in zip(self.names, ref_sq):
            top[group(n)] = max(top.get(group(n), 0.0), r)
        held = [i for i, n in enumerate(self.names)
                if ref_sq[i] >= HELD_SHARE ** 2 * top[group(n)]]
        out = sorted(set(range(k)) - set(held))
        readings["unheld"] = len(out)
        readings["unheld_grad_share"] = math.sqrt(sum(got_sq[i] for i in out) / sum(got_sq))
        readings["unheld_ref_grad_share"] = math.sqrt(sum(ref_sq[i] for i in out) / sum(ref_sq))
        leaves = {n: {"ref_share": math.sqrt(ref_sq[i] / sum(ref_sq)),
                      "share": math.sqrt(got_sq[i] / sum(got_sq)), "held": i in held}
                  for i, n in enumerate(self.names)}

        def summary(key, num, den, on):
            """Each tensor's error (kept in ``leaves``); over the tensors
            ``on``, the whole's, the worst tensor's (and its name) and the
            median tensor's."""
            errs = {self.names[i]: math.sqrt(num[i] / max(den[i], 1e-300)) for i in range(k)}
            for n, e in errs.items():
                leaves[n][key] = e
            errs = {self.names[i]: errs[self.names[i]] for i in on}
            name = max(errs, key=errs.get)
            whole = sum(num[i] for i in on), sum(den[i] for i in on)
            readings[key] = math.sqrt(whole[0] / max(whole[1], 1e-300))
            readings[key + "_worst"], readings[key + "_worst_of"] = errs[name], name
            readings[key + "_median"] = float(np.median(list(errs.values())))

        sq = [float(((g - w.to(g.dtype)) ** 2).sum()) for g, w in zip(got, want)]
        summary("grad_l2", sq, ref_sq, held)
        t = int(self.opt.state[self.params[0]]["step"])
        for key, g, on in (("update_rel", got, range(k)), ("update_ref_rel", want, held)):
            with torch.no_grad():
                after = ref.adam(kept_p, g, kept_m, kept_v, t, cfg["lr"], tuple(cfg["betas"]),
                                 cfg["eps"])
                num = [float(((p - a) ** 2).sum()) for p, a in zip(self.params, after)]
                den = [float(((a - p0) ** 2).sum()) for a, p0 in zip(after, kept_p)]
            summary(key, num, den, on)
        return leaves

    def check(self, limits):
        readings = {}
        self._losses(readings)
        leaves = None
        # the whole last step, where it ran on the whole batch
        b, h = self.batches[self.sample], self.held[self.sample]
        if h["ranges"].shape[0] == b["features"].shape[0]:
            leaves = self._step(readings)
        # every reading, the compared ones and those read only
        # (perfbench/control.py records them), and each tensor's
        self.detail = {"readings": readings, "leaves": leaves}
        # a number that could not be read (the step on part of the batch) fails
        return {k: (readings.get(k, math.inf), lim) for k, lim in limits.items()}


def setup(cfg, traffic, seed, device, fault=None, control=False):
    return ModelCell(cfg, traffic, seed, device, fault=fault, control=control)
