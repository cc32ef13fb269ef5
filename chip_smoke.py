#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fast_rnnt_tpu_torch/csrc``, checks
each kernel against its plain PyTorch version on the card (small ragged
shapes, with the recursion kernels also in bfloat16 and float16 storage,
the build kernels also on bf16 and f16 lm and am, the sweep pair seeded
with ones against the fused kernel bit for bit;
the smoothed build backward on 256 seeded draws in bf16 and at each
matmul precision, its plain version on the forward's residuals with
d_uni's weight rd bit for bit (``duni-sweep``; every torch draw of the
script comes from a seeded generator, and a failure names its case and
seed); the golden path-enumeration vectors; the headline shape, with the sweep
pair timed unbanded and banded), runs the parity
gate (``fast_rnnt_tpu_torch.utils.parity``) at the headline shape before
the first timing (``parity``: the shipped route against the plain route on
the card, each route's launches counted, ``enforce_parity``, then a run
with the fused kernel's occupancies scaled by 1.01 that must fail it),
holds the pruned lattice's three kernels (``csrc/pruned_rows.cu``) to
their plain version at the recipe's shape (B=8, T=12000, S=1200, K=5,
C=500: px, py and d_logits, with times, bounds and memory), then drives
these paths at B=30, T=1000, S=100,
C=500, s_range=5, on inputs made exactly as ``bench.py`` makes them
(seed 0), each with every launch count set to 0 just before and read just
after:

  * forward only: ``rnnt_loss_simple_pruned``; the losses agree with the
    plain path on the card, and no backward residual is kept;
  * training: ``bench.py``'s step, the gradient of ``0.5*simple + pruned``
    w.r.t. (am, lm); the gradients agree with the plain recursion's
    occupancies fed through the plain build backward;
  * the same step in the bf16-input mode (``bench.py``'s second row: bf16
    am and lm, a bf16 lattice), held to the float32 step on the same
    rounded inputs and ranges;
  * smoothed training: the same for ``rnnt_loss_smoothed_pruned``, in
    float32 and on bf16 am and lm with a bf16 lattice (the smoothed build
    kernels in their bf16 mode), each held to the plain path on the card;
  * the real-joiner recipe (``rnnt_loss_simple`` with occupancies,
    ``get_rnnt_prune_ranges``, ``do_rnnt_pruning``, the joiner
    ``am_p + lm_p``, ``rnnt_loss_pruned``), as shipped and split: with
    this additive joiner it is the training
    step's function, so loss and gradients are held to the training
    step's; then with bf16 pruned logits (a bf16 lattice in the recursion),
    held to the float32 recipe;
  * the unpruned ``rnnt_loss`` of full logits at B=4;
  * ``precision``: ``set_matmul_precision`` at "highest" (3xTF32), "high"
    (1xTF32) and "default" (one bf16 pass): the build kernels against
    their plain emulation at each level, their times, the lattices and
    the train step's loss against "highest", bf16 lm and am bit-equal
    across the levels, the forward builds beside their einsum at the same
    level; ``bench.py``'s train step with ``impl="plain"``
    (no kernel launched) and ``impl="cuda"`` (the six);
  * ``model-train``: the pruned transducer's training step
    (``models.make_train_step``) at the full width of ``TransducerConfig()``
    (6 conformer layers, d_model 256, vocab 500, bf16 compute) on
    ``benchmarks/harness.py``'s batch (B=8, T_in=1000, S=100, s_range=5,
    seed 0), AdamW(1e-3, weight_decay 1e-4): a first step with
    ``LossConfig(impl="plain")`` on a copy launches no loss kernel and
    gives the kernel step's simple loss to rel 1e-4; the nine loss kernels
    (the six and the pruned lattice's three) once each, the losses and their gradients w.r.t. the loss's inputs held to
    the plain versions on copies on the CPU (fed the card's ranges), 10
    more steps whose loss falls, then step time, audio-seconds/s, peak
    memory and the device-time split of the loss kernels and the model's
    layers under ``torch.profiler``;
  * ``model-converge``: ``bench.py``'s convergence run on the port (a tiny
    model overfit on a copy task in 300 AdamW steps), regular RNN-T with
    greedy search, and modified RNN-T with greedy (one symbol a frame)
    and modified beam search: loss falls 20x, decoders reach 95%;
  * ``alignment``: ``viterbi_alignment`` of the headline lattice on the
    card against its own result on the CPU;
  * serving, at the full width of ``bench.py``'s streaming config
    (``TransducerConfig(causal=True, attention_left_context=32)``, chunk
    32, max_len 256, weights from ``Generator().manual_seed(0)``), each
    run launching none of the port's kernels: ``stream-encoder`` (16
    ragged streams encoded chunk by chunk against offline, float32 and
    bf16 compute), ``serve`` (256 ragged streams through
    ``StreamServer(capacity=128)``, greedy, tokens equal to the offline
    ``greedy_search`` on the card or differing first at a near-tie of the
    offline logits), ``serve-beam`` (32 streams, beam 4, against
    ``modified_beam_search``), ``serve-converge`` (``model-converge``'s
    modified arm built causal, served greedy and beam: tokens equal to
    offline, accuracy 95%) and ``serve-time`` (the bf16 chunk step at
    capacities 8, 32 and 128, greedy, and beam 4 at 128: step time, RTF,
    streams at real time, launches, host reads, device busy);
  * ``profiling``: ``fast_rnnt_tpu_torch.utils.profiling`` on the card:
    the train step by ``benchmark_on_device`` beside ``cuda_ms`` with and
    without a head start, the forward's ``compiled_memory_mb`` beside the
    main path's counted peak, a ``trace_to`` run under
    ``annotate("train_step")`` into ``build/trace/`` that must hold the
    span and the six main-path kernels, and the bf16 chunk step at 32
    streams by ``benchmark_carried_on_device``;
  * audio in: ``data`` (the host C++ library built by g++ from
    ``fast_rnnt_tpu_torch/csrc/host`` into ``build/host/``; streamed fbank
    bit-equal to offline), ``serve-audio`` (32 synthetic waveforms fed to
    ``StreamServer(capacity=32)`` in 0.32 s pieces through one
    ``StreamingFbank`` each: tokens identical to the same server on
    offline ``fbank_cpu`` features), ``dp-train`` (8 synthetic 6-10 s
    utterances through ``fbank_cpu`` and ``RaggedBatcher``, the
    ``TransducerConfig()`` training step on two ranks of 4 utterances on
    the one card, worker processes of this script over gloo with CUDA
    tensors, then one rank on NCCL: the nine loss kernels once per rank
    per step, the all-reduced gradients equal to the sum of the shards'
    single-process gradients bit for bit, the loss falls, and on each gloo
    rank a ``collective_census`` of one step: three all-reduces, no other
    collective, no lattice-sized tensor moved),
    ``dtensor`` (bench.py's train step and the smoothed step at the
    headline shape on Shard(0) DTensors of a DeviceMesh, the losses
    partitioned by ``ops/kernels/partition.py``, ``--dtensor-worker``
    processes: one NCCL rank, bit-equal to the plain-tensor steps in the
    same process and all eight kernels launched; two gloo ranks sharing
    the card, 15 utterances each, held to the whole batch's plain step at
    the train tolerances, the trace hook at 15 on every kernel entry, and
    a ``collective_census`` of each step: the loss's scalar all-reduce,
    the smoothed step's two [C] unigram all-reduces, no lattice moved; am
    and lm sharded on C and resharded where gloo carries the all-to-all
    on CUDA tensors; step times, DTensor against plain tensors; the nine
    glue ops that reach no kernel, one rank bit-equal and two ranks equal
    to the whole batch's call; the sharded forced-alignment path,
    ``get_rnnt_logprobs`` then ``viterbi_alignment``, its scores and
    emission frames equal to the ``alignment`` phase's) and
    ``example`` (``examples/torch_train_and_decode.py`` at 300 steps on
    the card: greedy and beam token accuracy at least 0.95).

The occupancies of the ``calc_gradients`` calls come from the fused
kernel, a diagonal sweep, and stage 2 (the scores op and its backward)
runs the same kernel's forward and backward phases launched apart.  One
A/B arm is swapped in here, not in the package: ``split`` runs the
phases apart in the fused kernel's place, and must give the shipped
arm's bits.  It is timed in turns against the shipped arm.

Last it measures where the steps' time goes: device
time per kernel and the device's busy share under ``torch.profiler``, and
60 single-step samples of the forward step for each of seeds 0 and 1.

Every phase prints one line (the profile adds one line per kernel); any
failed check exits non-zero.  The last two
lines are a JSON object of per-kernel numbers and the JSON result
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result: there is no CPU fallback.
"""

import contextlib
import copy
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B, T, S, C = 30, 1000, 100, 500
S_RANGE = 5
REPS = 10
# the forward-only main path's peak device memory may not exceed the first
# slice's 156.1 MiB by more than 1 MiB, nor the memory allocated before it
# (its inputs) by more than 60.7 MiB (59.7 measured since the lm side runs
# in a kernel, + 1): it keeps no backward residual (D alone is 12 MB)
FWD_PEAK_MIB = 157.1
FWD_ABOVE_MIB = 60.7


class Failed(Exception):
    pass


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def make_inputs(seed=0):
    """bench.py's make_inputs, in numpy (bench.py itself imports JAX)."""
    rng = np.random.default_rng(seed)
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    t_end = np.clip(rng.integers(T // 2, T + 1, size=B), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=B), 2, S).astype(np.int32)
    boundary = np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], axis=1
    )
    return am, lm, symbols, boundary


# cycles of the device-side wait (torch.cuda._sleep, ~2 ms) that starts a
# kernel's timed run: the host enqueues the run's calls meanwhile, so a call
# whose wrapper takes longer on the host than its kernels on the card is
# timed by its kernels
HEAD_START = 4_000_000


def cuda_ms(fn, reps=REPS, inner=10, head_start=False):
    """Milliseconds per call of ``fn``: CUDA events around ``inner``
    back-to-back calls, divided by ``inner``; the median of ``reps`` such
    runs, after a warm-up run of ``inner`` calls (the first timer of a
    process otherwise reads the card before its clocks are up).  With
    ``head_start`` each run starts behind a device-side wait, so that the
    calls run back to back on the card, not at the host's pace (the
    kernels' times; a step's time keeps its host time)."""
    import torch

    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if head_start:
            torch.cuda._sleep(HEAD_START)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def cold_ms(fn, reps=REPS):
    """Milliseconds of one call of ``fn`` with the 50 MB L2 cache flushed
    before it (a 128 MB buffer written), as a step finds its inputs: CUDA
    events around the call alone, behind a device-side wait, median of
    ``reps``."""
    import torch

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return float(np.median(times))


def kernel_ms(fn, **kw):
    """``cuda_ms`` of a kernel (or its plain version or library call),
    behind a head start."""
    return cuda_ms(fn, head_start=True, **kw)


def in_turns(*steps):
    """CUDA-event ms of ``steps`` in turns, forward then back (a, b, b, a)."""
    order = list(steps) + list(steps)[::-1]
    return [cuda_ms(fn) for fn in order]


def _split_rows(px_rows, py_rows, boundary, lo=None, K=0, impl=None):
    """The sweep pair (forward, then the backward seeded with ones), in the
    fused kernel's place for the ``split`` arm."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import wavefront

    p, scores = wavefront.forward_rows(px_rows, py_rows, boundary, lo, K, impl=impl)
    gx, gy = wavefront.backward_rows(px_rows, py_rows, p, boundary, torch.ones_like(scores), lo, K,
                                     impl=impl)
    return scores, gx, gy


@contextlib.contextmanager
def arm(name):
    """``"shipped"``: the package as it is; ``"split"``: the calc_gradients
    calls run the sweep pair in place of the fused kernel."""
    from fast_rnnt_tpu_torch.ops.kernels import wavefront

    saved = wavefront.fused_rows
    if name == "split":
        wavefront.fused_rows = _split_rows
    try:
        yield
    finally:
        wavefront.fused_rows = saved


def armed(name, fn):
    """``fn`` run inside ``arm(name)``."""
    def run():
        with arm(name):
            return fn()
    return run


def finite_err(got, want, name, atol, rtol):
    """(max abs, max rel) error of ``got`` over the finite entries of
    ``want``; the -inf pattern must match exactly and
    |got - want| <= atol + rtol * |want| everywhere.  The relative error is
    taken where |want| > atol / rtol."""
    import torch

    got, want = got.double(), want.double()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise Failed(f"{name}: -inf pattern differs")
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise Failed(f"{name}: NaN")
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0, 0.0
    d = (got[fin] - want[fin]).abs()
    ref = want[fin].abs()
    bad = d > atol + rtol * ref
    if bad.any():
        raise Failed(f"{name}: max abs err {d.max().item():.3e} over atol {atol} + rtol {rtol}")
    # relative error where the rtol term of the bound dominates
    big = ref > atol / rtol
    rel = (d[big] / ref[big]).max().item() if big.any() else 0.0
    return d.max().item(), rel


def worst(*errs):
    return tuple(max(e[i] for e in errs) for i in range(2))


# gradients (d_lm, d_am, d_uni), kernel against plain, both fp32: the largest
# |difference| over the largest |plain value|
GRAD_TOL = 1e-4


def grad_err(got, want, name, tol=GRAD_TOL, step=0.0):
    """(max abs err, max abs err / max |want|); fails above ``tol`` or on a
    non-finite value.  With ``step``, each element may differ by ``step``
    of its |want| more (an output rounded to a narrow dtype), and the
    second number is the largest excess over that, over max |want|."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise Failed(f"{name}: non-finite gradient")
    if got.shape != want.shape:
        raise Failed(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if want.numel() == 0:
        return 0.0, 0.0
    diff = (got.double() - want.double()).abs()
    err = diff.max().item()
    rel = (diff - step * want.double().abs()).max().item() / max(want.abs().max().item(), 1e-30)
    if rel > tol:
        raise Failed(f"{name}: max abs err {err:.3e} is {rel:.3e} of max |plain| > {tol}")
    return err, rel


# training gradients against the plain reference, which runs its own fp32
# recursion: fp32 occupancies of a 1000-frame lattice carry ~3e-3 of
# round-off (p reaches |p| ~ 4e3, where a float32 step is 4.9e-4, and an
# occupancy is the exp of a difference of such values), in the plain
# version as much as in the kernels; the bound is the JAX package's own fp32
# occupancy bound (fast_rnnt_tpu/ops/recursion.py:867).  The build backward
# itself is held to GRAD_TOL on identical cotangents (kernels-headline).
TRAIN_GRAD_TOL = 1e-2


# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # fp32 FMA pipes, outside the tensor cores
TF32_FLOP_PER_S = 495e12  # tensor cores, dense
BF16_FLOP_PER_S = 989e12


def bound(nbytes, nflops, rate=FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of the bytes over the memory rate and the operations over their
    peak rate (fp32 FMAs unless ``rate`` says otherwise)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, nflops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def same_bits(got, want, name):
    """The ``split`` arm runs the fused kernel's own phases: its outputs must
    be the shipped arm's bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise Failed(f"{name}: the sweep pair's outputs differ from the fused kernel's")
    return "bit-equal"


def kernel_bounds(bnd, build_rate=3, esize=4, bf16_ops=False):
    """Bound of each kernel at this run's headline inputs: each input read
    once, each output written once, fp32 (4 bytes).  The build kernels need
    every frame; their products run on the tensor cores, float32 operands
    as three TF32 passes (``build_rate=3``, at the TF32 peak), bf16 operands
    as one pass at the bf16 peak (``build_rate=1``, ``esize=2``: am and lm
    read as bf16); ``build_rate=0`` gives the fp32-FMA bound of the earlier
    design, for comparison.  The recursion and ranges kernels read only the
    cells inside each utterance's boundary (s <= s_end, t <= t_end), and
    their per-cell operation counts are taken from the code (log-add: 7,
    occupancy: 10, window sum: 2).  ``bf16_ops``: the products at the bf16
    peak on float32 am and lm (the "default" matmul precision)."""
    if build_rate == 0:
        mm = dict(rate=FP32_FLOP_PER_S)
    elif esize == 2 or bf16_ops:
        mm = dict(rate=BF16_FLOP_PER_S / build_rate)
    else:
        mm = dict(rate=TF32_FLOP_PER_S / build_rate)
    x = esize / 4  # am and lm (and d_am, d_lm) bytes per element, over 4
    se = bnd[:, 2].double() - bnd[:, 0].double()
    te = bnd[:, 3].double() - bnd[:, 1].double()
    npx = float((se * (te + 1)).sum())
    npy = float(((se + 1) * te).sum())
    ncell = float(((se + 1) * (te + 1)).sum())
    px, py, p = S * B * (T + 1), (S + 1) * B * T, (S + 1) * B * (T + 1)
    am, lm, sym = B * T * C, B * (S + 1) * C, B * S
    gemm = 2 * B * T * (S + 1) * C
    return {
        "latbuild_fwd": bound(4 * (x * (am + lm) + sym + B + px + py), gemm, **mm),
        "wavefront_fwd": bound(4 * (npx + npy + 4 * B + p + B), 7 * ncell),
        "wavefront_bwd": bound(4 * (npx + npy + ncell + 5 * B + px + py), 10 * ncell),
        # fwd + bwd with p kept in scratch: px, py and the boundary in, the
        # scores and both occupancies out
        "wavefront_fused": bound(4 * (npx + npy + 4 * B + B + px + py), 17 * ncell),
        "ranges": bound(4 * (npx + npy + 4 * B + B * T), 2 * npy),
        # inputs lm, am, symbols, t_end, the residuals D and amax, dpx, dpy;
        # outputs d_am, d_lm
        "latbuild_bwd": bound(4 * (x * (lm + am) + sym + B + py + B * T + px + py + x * (am + lm)),
                              2 * gemm, **mm),
        "latbuild_fwd_parts": bound(4 * (x * (am + lm) + sym + B + C + px + 2 * py),
                                    gemm + 2 * B * T * C, **mm),
        # + uni, the residual duni and dnd in, d_uni out
        "latbuild_bwd_parts": bound(4 * (x * (lm + am) + sym + B + C + py + 2 * B * T + px + 2 * py
                                         + x * (am + lm) + C),
                                    2 * 2 * B * T * (S + 2) * C, **mm),
    }


# the bf16 build backward against its plain version, lattice_rows_bwd_plain
# on the same bf16 exps with everything after them float32 (the kernels'
# contract; the plain build's own autograd in bf16 rounds each VJP step and
# scatters with atomics, so it is neither exact nor repeatable): the kernel
# splits w into two bf16 parts (~2^-17), so a float32 output is held to
# BF16_CONTRACT_TOL of max and one written in bf16 to that plus one bf16
# step (2^-7) of each element.  The sound kernel measured 2.9e-7 of max at
# the headline shape on an H100; one that truncates w to a single bf16 part fails at
# 1.1e-3 (d_lm, kernels-small).
BF16_CONTRACT_TOL = 1e-5


def bf16_contract_err(got, want, name):
    """The bf16 build backward's (d_lm, d_am) against the plain VJP's."""
    import torch

    return worst(*(grad_err(g.float(), w, f"{name} {n}", BF16_CONTRACT_TOL,
                            2.0**-7 if g.dtype == torch.bfloat16 else 0.0)
                   for g, w, n in zip(got, want, ("d_lm", "d_am"))))


def smoothed_bwd_pair(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, name, level=None):
    """The smoothed build backward, kernel and plain version, the plain one
    on the forward's full residuals (D and duni, as the kernels take them)
    at matmul precision ``level`` (None: the current one).  d_uni's weight
    rd = -sum_s dnd / duni, which both sides round to bf16 or to the
    level's operand before d_uni's product, must be the same bits.
    Returns (kernel's (d_lm, d_am, d_uni), plain's, rd)."""
    from fast_rnnt_tpu_torch.ops.kernels import latbuild
    from fast_rnnt_tpu_torch.ops.lattice import _PREC_CODE

    prec = None if level is None else _PREC_CODE[level]
    got = latbuild.build_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, prec, return_rd=True)
    want = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, modified, uni, dnd, res[0],
                                           prec=level, duni=res[2], return_rd=True)
    n = rd_mismatch(got[3], want[3])
    if n:
        raise Failed(f"{name}: d_uni's weight rd differs from the plain version's in {n} of {want[3].numel()}")
    return got[:3], want[:3], got[3]


def rd_mismatch(a, b):
    """How many float32 elements of ``a`` and ``b`` differ in their bits."""
    import torch

    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def build_checks(dev, rng, bnd, Sc, Tc, modified, offset, Cc, seed):
    """The build kernels at a small ragged shape against their plain
    versions: the forward with its residuals, the backward through the
    autograd route for every rnnt_type (random cotangents, also on the -inf
    columns, which both sides drop), the smoothed build's forward and
    backward (the plain one on the forward's residuals, rd bit for bit),
    and the plain build's forward and backward on bf16 lm and am.  A random
    blank; with ``offset`` out-of-range symbols; ``Cc`` = 17 reads am from
    device memory, 32 stages whole am rows in shared memory.  The tensors
    are drawn on the card from a generator seeded with ``seed``.  Returns
    {kernel: max abs err}."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import latbuild

    Bc = bnd.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    lm = torch.randn(Bc, Sc + 1, Cc, device=dev, generator=gen)
    am = torch.randn(Bc, Tc, Cc, device=dev, generator=gen) * 2
    sym = torch.randint(1, Cc, (Bc, Sc), device=dev, dtype=torch.int32, generator=gen)
    if offset and Sc:
        # out-of-range symbols read 0 (the JAX package's one-hot gather); the
        # last one sits at the very end of am
        sym[0, 0], sym[-1, -1] = -1, Cc
    blank = int(rng.integers(Cc))
    rt = "modified" if modified else "regular"
    te = bnd[:, 3].contiguous() if not modified else torch.full((Bc,), -1, dtype=torch.int32, device=dev)
    T1 = Tc if modified else Tc + 1
    dpx = torch.randn(Sc, Bc, T1, device=dev, generator=gen)
    dpy = torch.randn(Sc + 1, Bc, Tc, device=dev, generator=gen)
    err = {}

    px_k, py_k = latbuild.lattice_rows(lm, am, sym, blank, rt, bnd)
    px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, blank, rt, bnd)
    e = [finite_err(px_k, px_p, "build px", 1e-4, 1e-5)[0],
         finite_err(py_k, py_p, "build py", 1e-4, 1e-5)[0]]
    px_r, py_r, _, _ = latbuild.build_fwd(lm, am, sym, te, blank, modified, save=True)
    e += [finite_err(px_r, px_p, "build px (residuals on)", 1e-4, 1e-5)[0],
          finite_err(py_r, py_p, "build py (residuals on)", 1e-4, 1e-5)[0]]
    err["latbuild_fwd"] = max(e)

    e = []
    for rtype in (("modified", "constrained") if modified else ("regular",)):
        lm_l, am_l = lm.clone().requires_grad_(), am.clone().requires_grad_()
        px_k, py_k = latbuild.lattice_rows(lm_l, am_l, sym, blank, rtype, bnd)
        g_lm, g_am = torch.autograd.grad([px_k, py_k], [lm_l, am_l], [dpx, dpy])
        dpy_eff = dpy + torch.cat([torch.zeros_like(dpy[:1]), dpx]) if rtype == "constrained" else dpy
        w_lm, w_am, _ = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy_eff, blank, modified)
        e += [grad_err(g_lm, w_lm, f"build bwd d_lm ({rtype})")[0],
              grad_err(g_am, w_am, f"build bwd d_am ({rtype})")[0]]
    err["latbuild_bwd"] = max(e)

    uni = torch.softmax(torch.randn(Cc, device=dev, generator=gen), 0) + 1e-3
    dnd = torch.randn(Sc + 1, Bc, Tc, device=dev, generator=gen)
    *out_k, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, uni, save=True)
    out_p = latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, blank, modified)
    err["latbuild_fwd_parts"] = max(
        finite_err(a, b, f"parts {n}", 1e-4, 1e-5)[0]
        for a, b, n in zip(out_k, out_p, ("px", "py", "normd"))
    )
    g_k, g_p, _ = smoothed_bwd_pair(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, "parts bwd")
    err["latbuild_bwd_parts"] = max(
        grad_err(a, b, f"parts bwd {n}")[0] for a, b, n in zip(g_k, g_p, ("d_lm", "d_am", "d_uni"))
    )

    # bf16 lm and am: the kernel rounds the exps as its plain version does,
    # and their products are exact in float32
    lm16, am16 = lm.bfloat16(), am.bfloat16()
    px_k, py_k = latbuild.lattice_rows(lm16, am16, sym, blank, rt, bnd)
    px_p, py_p = latbuild.lattice_rows_plain(lm16, am16, sym, blank, rt, bnd)
    err["latbuild_fwd/bfloat16"] = max(finite_err(px_k, px_p, "bf16 build px", 1e-4, 1e-5)[0],
                                       finite_err(py_k, py_p, "bf16 build py", 1e-4, 1e-5)[0])
    # the backward: the kernel's float32 d_lm, and both gradients through the
    # autograd route (in bf16), against the plain VJP
    want = latbuild.lattice_rows_bwd_plain(lm16, am16, sym, te, dpx, dpy, blank, modified)
    *_, res16 = latbuild.build_fwd(lm16, am16, sym, te, blank, modified, save=True)
    e = [bf16_contract_err(latbuild.build_bwd(lm16, am16, sym, te, blank, modified, res16, dpx, dpy),
                           want, "bf16 build bwd")[0]]
    lm_l, am_l = lm16.clone().requires_grad_(), am16.clone().requires_grad_()
    g = torch.autograd.grad(latbuild.lattice_rows(lm_l, am_l, sym, blank, rt, bnd), [lm_l, am_l], [dpx, dpy])
    if g[0].dtype != torch.bfloat16 or g[1].dtype != torch.bfloat16:
        raise Failed(f"bf16 build bwd: gradient dtypes {g[0].dtype} {g[1].dtype}")
    e.append(bf16_contract_err(g, want, "bf16 build bwd (autograd)")[0])
    err["latbuild_bwd/bfloat16"] = max(e)

    # the smoothed build on bf16 lm and am: its kernels and their plain
    # versions round as the Pallas smoothed build does (bf16 exps of the
    # float32 shift, bf16 w and rd in the backward); the backward to the
    # bf16 contract, d_uni (float32) to its 1e-5 of max.  The plain backward
    # takes the forward's residuals D and duni, as the kernels do: w =
    # dnorm / D and rd = -sum_s dnd / duni are rounded to bf16, and a D
    # recomputed in another summation order moves some w to the
    # neighbouring bf16 step (2.3e-5 of max on d_lm at the headline shape
    # on an H100, against 1e-5), an rd summed in another order over a
    # recomputed duni some rd (1.8e-4 of max on d_uni, kernels-small)
    *o16, r16 = latbuild.build_fwd(lm16, am16, sym, te, blank, modified, uni, save=True)
    err["latbuild_fwd_parts/bfloat16"] = max(
        finite_err(a, b, f"bf16 parts {n}", 1e-4, 1e-5)[0]
        for a, b, n in zip(o16, latbuild.lattice_rows_parts_plain(lm16, am16, sym, te, uni, blank, modified),
                           ("px", "py", "normd")))
    g, want, _ = smoothed_bwd_pair(lm16, am16, sym, te, blank, modified, r16, dpx, dpy, uni, dnd,
                                   "bf16 parts bwd")
    if g[1].dtype != torch.bfloat16 or want[1].dtype != torch.bfloat16:
        raise Failed(f"bf16 parts bwd: d_am dtypes {g[1].dtype} {want[1].dtype}")
    err["latbuild_bwd_parts/bfloat16"] = max(
        bf16_contract_err(g[:2], want[:2], "bf16 parts bwd")[0],
        grad_err(g[2], want[2], "bf16 parts bwd d_uni", BF16_CONTRACT_TOL)[0])

    # f16 lm and am run the float32 kernels on their casts (as the Pallas
    # build contracts them), the gradients cast back to f16
    lmh_l, amh_l = lm.half().requires_grad_(), am.half().requires_grad_()
    out = latbuild.lattice_rows(lmh_l, amh_l, sym, blank, rt, bnd)
    lm32, am32 = lmh_l.detach().float(), amh_l.detach().float()
    err["latbuild_fwd/float16"] = max(
        finite_err(a, b, f"f16 build {n}", 1e-4, 1e-5)[0]
        for a, b, n in zip(out, latbuild.lattice_rows_plain(lm32, am32, sym, blank, rt, bnd), ("px", "py")))
    g = torch.autograd.grad(out, [lmh_l, amh_l], [dpx, dpy])
    if g[0].dtype != torch.float16 or g[1].dtype != torch.float16:
        raise Failed(f"f16 build bwd: gradient dtypes {g[0].dtype} {g[1].dtype}")
    w_lm, w_am, _ = latbuild.lattice_rows_bwd_plain(lm32, am32, sym, te, dpx, dpy, blank, modified)
    err["latbuild_bwd/float16"] = max(grad_err(a.float(), b, f"f16 build bwd {n}", GRAD_TOL, 2.0**-10)[0]
                                      for a, b, n in zip(g, (w_lm, w_am), ("d_lm", "d_am")))
    return err


# duni-sweep: seeded draws of the smoothed build backward, each in bf16 and
# in float32 at each matmul precision
DUNI_DRAWS = 256
DUNI_CS = (17, 32, 33, 64, 500)
DUNI_MODES = ("bf16", "highest", "high", "default")


def duni_draw(dev, seed):
    """One seeded draw of the smoothed build backward's inputs, from
    ``default_rng(seed)`` (shapes, rnnt_type, blank, which symbols fall out
    of range) and a card generator seeded with ``seed`` (the tensors): B
    1-4, S 0-12, T 1-64, C in DUNI_CS, a random (also negative) blank."""
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Bc, Sc, Tc = int(rng.integers(1, 5)), int(rng.integers(0, 13)), int(rng.integers(1, 65))
    Cc, modified = int(rng.choice(DUNI_CS)), bool(rng.integers(2))
    blank = int(rng.integers(-Cc, Cc))
    lm = torch.randn(Bc, Sc + 1, Cc, device=dev, generator=gen)
    am = torch.randn(Bc, Tc, Cc, device=dev, generator=gen) * 2
    sym = torch.randint(1, Cc, (Bc, Sc), device=dev, dtype=torch.int32, generator=gen)
    if Sc and rng.integers(2):  # out-of-range symbols, the last at the very end of am
        sym[0, 0], sym[-1, -1] = -1, Cc
    te = torch.full((Bc,), -1, dtype=torch.int32, device=dev)
    if not modified:
        te = torch.randint(0, Tc + 1, (Bc,), device=dev, dtype=torch.int32, generator=gen)
    dpx = torch.randn(Sc, Bc, Tc if modified else Tc + 1, device=dev, generator=gen)
    dpy = torch.randn(Sc + 1, Bc, Tc, device=dev, generator=gen)
    dnd = torch.randn(Sc + 1, Bc, Tc, device=dev, generator=gen)
    uni = torch.softmax(torch.randn(Cc, device=dev, generator=gen), 0) + 1e-3
    case = f"seed {seed}: B={Bc} S={Sc} T={Tc} C={Cc} {'modified' if modified else 'regular'} blank {blank}"
    return (lm, am, sym, te, blank, modified, dpx, dpy, uni, dnd), case


def rd_steps(a, b, mode):
    """How many of the weights ``a`` and ``b`` d_uni's product takes as
    different operands: rounded to bf16 (bf16 mode, "default"), to TF32
    ("high"), or as they are ("highest", the 3xTF32 product)."""
    from fast_rnnt_tpu_torch.ops.lattice import _round_operand

    if mode == "bf16":
        return rd_mismatch(a.bfloat16().float(), b.bfloat16().float())
    return rd_mismatch(_round_operand(a, mode), _round_operand(b, mode))


def duni_sweep_phase(dev, draws=DUNI_DRAWS):
    """The smoothed build backward on ``draws`` seeded draws (``duni_draw``,
    seeds 0 .. draws-1), each on bf16 lm and am and on float32 ones at
    "highest", "high" and "default": the forward with residuals, then the
    backward kernel against ``lattice_rows_bwd_plain`` two ways.  On the
    kernels' contract (``smoothed_bwd_pair``: the forward's D and duni, rd
    in the prep kernel's order) rd must be the same bits and d_lm, d_am and
    d_uni within their limits (bf16: BF16_CONTRACT_TOL of max, d_am plus
    one bf16 step; float32: GRAD_TOL of max), or the phase fails naming the
    draw.  The earlier contract (the forward's D only: rd summed in
    torch's order over a recomputed denominator, as the checks held it
    before) is counted, not enforced: its d_uni failures, its first failing
    seed, and its rd that d_uni's product takes as a different operand.
    Also the kernel's rd against a float64 rd on the same residual, in
    float32 eps of sum_s |dnd| / duni (a float32 sum's round-off scale),
    beside torch's order's.  Returns the summary per mode."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import latbuild
    from fast_rnnt_tpu_torch.ops.lattice import _PREC_CODE

    t0 = time.perf_counter()
    stats = {m: dict(worst=0.0, worst_seed=None, old_fail=0, old_first=None, old_worst=0.0, old_steps=0,
                     old_rd_bits=0, ulp_kernel=0.0, ulp_torch=0.0) for m in DUNI_MODES}
    n_rd = 0
    for seed in range(draws):
        (lm, am, sym, te, blank, modified, dpx, dpy, uni, dnd), case = duni_draw(dev, seed)
        n_rd += am.shape[0] * am.shape[1]
        for mode in DUNI_MODES:
            st = stats[mode]
            bf16 = mode == "bf16"
            x_lm, x_am = (lm.bfloat16(), am.bfloat16()) if bf16 else (lm, am)
            level = None if bf16 else mode
            tol = BF16_CONTRACT_TOL if bf16 else GRAD_TOL
            name = f"duni-sweep {mode} {case}"
            *_, res = latbuild.build_fwd(x_lm, x_am, sym, te, blank, modified, uni, save=True,
                                         prec=None if bf16 else _PREC_CODE[mode])
            g_k, g_p, rd_k = smoothed_bwd_pair(x_lm, x_am, sym, te, blank, modified, res, dpx, dpy, uni, dnd,
                                               name, level)
            if bf16:
                bf16_contract_err(g_k[:2], g_p[:2], name)
            else:
                worst(*(grad_err(a, b, f"{name} {n}") for a, b, n in zip(g_k[:2], g_p[:2], ("d_lm", "d_am"))))
            rel = grad_err(g_k[2], g_p[2], f"{name} d_uni", tol)[1]
            if rel > st["worst"] or st["worst_seed"] is None:
                st["worst"], st["worst_seed"] = rel, seed
            # the earlier contract: D only
            old = latbuild.lattice_rows_bwd_plain(x_lm, x_am, sym, te, dpx, dpy, blank, modified, uni, dnd,
                                                  res[0], prec=level, return_rd=True)
            try:
                rel_old = grad_err(g_k[2], old[2], f"{name} d_uni (D only)", tol)[1]
            except Failed:
                diff = (g_k[2].double() - old[2].double()).abs().max().item()
                rel_old = diff / max(old[2].abs().max().item(), 1e-30)
                st["old_fail"] += 1
                if st["old_first"] is None:
                    st["old_first"] = seed
            st["old_worst"] = max(st["old_worst"], rel_old)
            st["old_steps"] += rd_steps(rd_k, old[3], mode)
            st["old_rd_bits"] += rd_mismatch(rd_k, old[3])
            # the kernel's rd and torch's order against float64 on the same
            # residual duni, in float32 eps of sum_s |dnd| / duni: the round-off
            # scale of a float32 sum of S+1 terms (at most ~S+1 of it)
            rd64 = -dnd.double().sum(dim=0) / res[2].double()
            ulp = torch.finfo(torch.float32).eps * dnd.double().abs().sum(dim=0) / res[2].double()
            rd_t = -dnd.sum(dim=0) / res[2]
            st["ulp_kernel"] = max(st["ulp_kernel"], ((rd_k.double() - rd64).abs() / ulp).max().item())
            st["ulp_torch"] = max(st["ulp_torch"], ((rd_t.double() - rd64).abs() / ulp).max().item())
    secs = time.perf_counter() - t0  # the last .item() waited for the card
    parts = []
    for mode, st in stats.items():
        tol = BF16_CONTRACT_TOL if mode == "bf16" else GRAD_TOL
        parts.append(
            f"{mode}: {draws} of {draws} pass, rd bit for bit in all {n_rd}, worst d_uni {st['worst']:.3e} of max "
            f"(seed {st['worst_seed']}, tol {tol}); on D only (rd in torch's order over a recomputed "
            f"denominator) d_uni fails {st['old_fail']} of {draws} (first seed {st['old_first']}, worst "
            f"{st['old_worst']:.3e} of max), rd taken as another operand {st['old_steps']} of {n_rd} (float32 "
            f"bits differ in {st['old_rd_bits']}); rd vs float64 max {st['ulp_kernel']:.2f} (kernel), "
            f"{st['ulp_torch']:.2f} (torch's order) float32 eps of sum |dnd| / duni")
    phase("duni-sweep", f"{draws} draws (seeds 0-{draws - 1}: default_rng(seed) and a card generator "
          f"manual_seed(seed); B 1-4, S 0-12, T 1-64, C in {list(DUNI_CS)}, regular/modified, random "
          f"blanks, out-of-range symbols) x bf16 lm/am and float32 at highest/high/default, {secs:.1f} s; "
          + "; ".join(parts))
    return stats


# recursion kernels in a narrow storage dtype: p and the scores are float32
# and held to the float32 tolerance; the occupancies are compared in the
# storage dtype, so their tolerance adds one step of it (two float32 values
# within 1e-4 relative may round to neighbouring steps)
STORAGE_STEP = {"float32": 0.0, "bfloat16": 2.0**-7, "float16": 2.0**-10}


def recursion_checks(px, py, bnd, lo, K, seed):
    """On one small case, in float32, bfloat16 and float16 storage: the
    sweep pair against its plain versions (p in every cell, a random seed
    per utterance holding 0 and a negative value), the pair seeded with
    ones against the fused kernel bit for bit, the fused kernel against its
    plain version, both deterministic.  The random seeds come from a
    generator seeded with ``seed``.  Returns {kernel or kernel/dtype: max
    abs err}."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import wavefront

    err = {}
    Bc = px.shape[1]
    ones = torch.ones(Bc, device=px.device)
    ag = torch.randn(Bc, device=px.device, generator=torch.Generator(device=px.device).manual_seed(seed)) * 2
    ag[0] = 0.0
    ag[-1] = -abs(ag[-1].item()) - 0.5
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).split(".")[1]
        sfx = "" if dt == torch.float32 else f"/{name}"
        occ_rtol = 1e-4 + STORAGE_STEP[name]
        x, y = px.to(dt), py.to(dt)
        sc_f, gx_f, gy_f = wavefront.fused_rows(x, y, bnd, lo, K)
        if sc_f.dtype != torch.float32 or gx_f.dtype != dt or gy_f.dtype != dt:
            raise Failed(f"fused ({name}): dtypes {sc_f.dtype} {gx_f.dtype} {gy_f.dtype}")
        if not all(torch.equal(a, b) for a, b in zip((sc_f, gx_f, gy_f), wavefront.fused_rows(x, y, bnd, lo, K))):
            raise Failed(f"fused ({name}): a second run gives other bits")
        # the plain version runs its own forward, whose p differs from the
        # kernel's in the last bits (a float32 step is 1.2e-4 at |p| ~ 2e3,
        # T = 1200), and an occupancy is the exp of a difference of p
        # values: its occupancies are held to 1e-3 relative (the bound of
        # the long-utterance GPU tests)
        sc_p, gx_p, gy_p = wavefront.fused_rows_plain(x, y, bnd, lo, K)
        err["wavefront_fused" + sfx] = max(
            finite_err(sc_f, sc_p, f"fused scores ({name})", 1e-4, 1e-5)[0],
            finite_err(gx_f, gx_p, f"fused px_grad ({name})", 1e-5, occ_rtol + 9e-4)[0],
            finite_err(gy_f, gy_p, f"fused py_grad ({name})", 1e-5, occ_rtol + 9e-4)[0],
        )
        # the sweep pair: the forward against its plain version in every
        # cell of p, the backward on the kernel's p with random seeds
        p_k, sc_k = wavefront.forward_rows(x, y, bnd, lo, K)
        p_p, sc_p = wavefront.forward_rows_plain(x, y, bnd, lo, K)
        err["wavefront_fwd" + sfx] = max(
            finite_err(p_k, p_p, f"sweep fwd p ({name})", 1e-4, 1e-5)[0],
            finite_err(sc_k, sc_p, f"sweep fwd scores ({name})", 1e-4, 1e-5)[0],
        )
        g_k = wavefront.backward_rows(x, y, p_k, bnd, ag, lo, K)
        if g_k[0].dtype != dt or g_k[1].dtype != dt:
            raise Failed(f"sweep bwd ({name}): dtypes {g_k[0].dtype} {g_k[1].dtype}")
        err["wavefront_bwd" + sfx] = max(
            finite_err(a, b, f"sweep bwd {n} ({name})", 1e-5, occ_rtol)[0]
            for a, b, n in zip(g_k, wavefront.backward_rows_plain(x, y, p_k, bnd, ag, lo, K),
                               ("px_grad", "py_grad")))
        again = (*wavefront.forward_rows(x, y, bnd, lo, K), *wavefront.backward_rows(x, y, p_k, bnd, ag, lo, K))
        if not all(torch.equal(a, b) for a, b in zip((p_k, sc_k, *g_k), again)):
            raise Failed(f"sweep pair ({name}): a second run gives other bits")
        pair = (sc_k, *wavefront.backward_rows(x, y, p_k, bnd, ones, lo, K))
        same_bits(pair, (sc_f, gx_f, gy_f), f"sweep pair vs fused ({name})")
    return err


def range_flips(k_starts, p_starts, scores, name, gap_tol=1e-3):
    """Compare two (B, T) window-start arrays by the near-tie rule: every
    frame where they differ must have window scores (``scores``, (K', B, T))
    within ``gap_tol`` of each other at the two starts.  Returns (number of
    flips, largest gap)."""
    import torch

    diff = k_starts != p_starts
    n = int(diff.sum())
    if n == 0:
        return 0, 0.0
    bi, ti = torch.nonzero(diff, as_tuple=True)
    ka = k_starts[bi, ti].long().clamp(0, scores.shape[0] - 1)
    kb = p_starts[bi, ti].long().clamp(0, scores.shape[0] - 1)
    gaps = (scores[ka, bi, ti] - scores[kb, bi, ti]).abs()
    gmax = gaps.max().item()
    if gmax > gap_tol:
        raise Failed(f"{name}: {n} range flips, largest window-score gap {gmax:.3e} > {gap_tol}")
    return n, gmax


def ranges_check(starts, gy, gx, K, bnd, step, name, gap_tol=1e-3):
    """The ranges kernels' repaired window starts ``starts`` (B, T) on the
    occupancies (gy, gx): they must be exactly the boundary padding and
    monotone repair (the plain version's) of the kernels' raw argmax,
    recomputed in their own summation order
    (``ranges.window_argmax_kernel_order``: each window's K rows added
    directly, in row order), and every frame where that raw argmax differs
    from the plain cumsum-difference one must be a near-tie
    (``range_flips``): the two searches sum in another order, and a raw flip
    cascades through the repair into other frames.  Returns (raw flips,
    largest gap, the first flips' (b, t))."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import ranges
    from fast_rnnt_tpu_torch.ops.pruning import (
        _window_argmax,
        _window_scores,
        adjust_pruning_lower_bound,
    )

    raw = ranges.window_argmax_kernel_order(gy, gx, K)
    t = torch.arange(raw.shape[1], device=raw.device)[None, :]
    pad = (bnd[:, 2:3] - K + 1).clamp(min=0).to(torch.int32)
    want = adjust_pruning_lower_bound(torch.where(t < bnd[:, 3:4] - 1, raw, pad), step)
    if not torch.equal(starts, want):
        n = int((starts != want).sum())
        raise Failed(f"{name}: {n} frames differ from the repair of the kernel's own window argmax")
    raw_p = _window_argmax(gx, gy, K)
    n, gap = range_flips(raw, raw_p, _window_scores(gx, gy, K), f"{name} (raw argmax, kernel vs plain order)")
    return n, gap, torch.nonzero(raw != raw_p)[:4].tolist()


def rand_case(rng, Bc, Sc, Tc, modified, banded, offset, constrained=False):
    """Random unmasked rows, a ragged boundary (non-zero begins when
    ``offset``) and, when ``banded``, random band starts; ``constrained``
    adds py of the next row to the (modified) px, as the constrained
    lattice does."""
    T1 = Tc if modified else Tc + 1
    px = (rng.normal(size=(Sc, Bc, T1)) * 2.0).astype(np.float32)
    py = (rng.normal(size=(Sc + 1, Bc, Tc)) * 2.0).astype(np.float32)
    if constrained:
        px = px + py[1:]
    se = rng.integers(Sc // 2, Sc + 1, size=Bc)
    te = np.maximum(rng.integers(Tc // 2, Tc + 1, size=Bc), 1)
    sb = rng.integers(0, se // 2 + 1) if offset else np.zeros(Bc, np.int64)
    tb = rng.integers(0, te // 3 + 1) if offset else np.zeros(Bc, np.int64)
    bnd = np.stack([sb, tb, se, te], axis=1).astype(np.int32)
    lo = None
    if banded:
        K = 3
        lo = np.sort(rng.integers(0, max(Sc - K + 2, 1), size=(Bc, Tc)), axis=1).astype(np.int32)
        return px, py, bnd, lo, K
    return px, py, bnd, lo, 0


# the recipe's pruned lattice (perfbench's c500.long-recipe): B, T, S, K, C
PRUNED_SHAPE = (8, 12000, 1200, 5, 500)
# px and py, d_logits against the plain version in float32: the card tests'
# tolerances (tests/test_torch_cuda.py): the kernels' log-sum-exp sums in
# another order than torch.logsumexp
PRUNED_TOL = {"px": (1e-5, 1e-6), "py": (1e-5, 1e-6), "d_logits": (1e-5, 1e-5)}


def pruned_lattice_phase(dev):
    """The pruned lattice's kernels (``csrc/pruned_rows.cu``) at the
    recipe's shape, float32, against ``pruned_lattice_plain`` on the same
    card tensors: px, py and d_logits at ``PRUNED_TOL`` with the -inf, +inf
    and NaN patterns equal; each kernel's device ms from the profiler, the
    plain forward's and backward's CUDA-event ms, the bytes' bounds, and a
    forward and backward's memory above its inputs with the cotangents
    s-major (as the recursion hands them back) and B-major (a copy in the
    backward).  Returns ({kernel: report entry}, {kernel: bound})."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import pruned

    Bp, Tp, Sp, Kp, Cp = PRUNED_SHAPE
    g = torch.Generator(device=dev).manual_seed(23)
    logits = torch.randn((Bp, Tp, Kp, Cp), generator=g, device=dev)
    sym = torch.randint(1, Cp, (Bp, Sp), generator=g, device=dev, dtype=torch.int32)
    lo = torch.randint(0, Sp + 2 - Kp, (Bp, Tp), generator=g, device=dev).sort(1).values
    rg = (lo[:, :, None] + torch.arange(Kp, device=dev)).to(torch.int32)
    te = torch.randint(Tp // 2, Tp + 1, (Bp,), generator=g, device=dev)
    se = torch.randint(Sp // 2, Sp + 1, (Bp,), generator=g, device=dev)
    zero = torch.zeros_like(te)
    bnd = torch.stack([zero, zero, se, te], 1).to(torch.int32)
    # cotangents laid out as the recursion's row gradients: s-major
    gx = torch.randn((Sp, Bp, Tp + 1), generator=g, device=dev).movedim(0, 1)
    gy = torch.randn((Sp + 1, Bp, Tp), generator=g, device=dev).movedim(0, 1)

    def fwd(fn):
        return fn(logits, sym, rg, 0, bnd, "regular")

    def fwd_bwd(fn, cx=gx, cy=gy):
        x = logits.detach().requires_grad_()
        px, py = fn(x, sym, rg, 0, bnd, "regular")
        (d,) = torch.autograd.grad((px, py), x, (cx, cy))
        return px, py, d

    got = [x.detach() for x in fwd_bwd(pruned.pruned_lattice)]
    want = [x.detach() for x in fwd_bwd(pruned.pruned_lattice_plain)]
    torch.cuda.synchronize()
    errs = {}
    for a, b, what in zip(got, want, ("px", "py", "d_logits")):
        if not torch.equal(torch.isposinf(a), torch.isposinf(b)):
            raise Failed(f"pruned-lattice {what}: +inf pattern differs")
        errs[what] = finite_err(a, b, f"pruned-lattice {what}", *PRUNED_TOL[what])
    del got, want

    def peak_above(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    gx_b, gy_b = gx.contiguous(), gy.contiguous()  # B-major: the backward copies them
    runs = {
        "kernels": lambda: fwd_bwd(pruned.pruned_lattice),
        "kernels, B-major cotangents": lambda: fwd_bwd(pruned.pruned_lattice, gx_b, gy_b),
        "plain": lambda: fwd_bwd(pruned.pruned_lattice_plain),
    }
    mem = {k: peak_above(fn) for k, fn in runs.items()}
    ms = {k: kernel_ms(fn) for k, fn in runs.items()}
    plain_fwd = kernel_ms(lambda: fwd(pruned.pruned_lattice_plain))
    kern_fwd = kernel_ms(lambda: fwd(pruned.pruned_lattice))
    del gx_b, gy_b
    prof = profile_step(runs["kernels"])
    if prof is None:
        raise Failed("pruned-lattice: the profiler saw no device activity")
    rows, _, _ = prof
    names = {"pruned_band": "::band_kernel<", "pruned_rows": "::rows_kernel<",
             "pruned_bwd": "::bwd_kernel<"}
    dev_ms = {}
    for name, tag in names.items():
        hit = [r for r in rows if tag in r[0]]
        if [r[2] for r in hit] != [1.0]:
            raise Failed(f"pruned-lattice: {name} launched {[r[2] for r in hit]} times a step, expected once")
        dev_ms[name] = hit[0][1] / 1e3
    # each input read once, each output written once: the logits and
    # d_logits, the rows, and [B, T, K] band values, normalisers, ranges and
    # the band's cotangents
    n_in, band = Bp * Tp * Kp * Cp * 4, Bp * Tp * Kp * 4
    n_rows = (Sp * Bp * (Tp + 1) + (Sp + 1) * Bp * Tp) * 4
    bounds = {
        "pruned_band": bound(n_in + 4 * band, 0),  # ranges in; px, py band values, lse out
        "pruned_rows": bound(2 * band + Bp * Tp * 4 + n_rows, 0),  # band values, lo in; rows out
        "pruned_bwd": bound(2 * n_in + 4 * band, 0),  # logits, lse, ranges, band cotangents in
    }
    plain = {"pruned_band": plain_fwd, "pruned_rows": plain_fwd, "pruned_bwd": ms["plain"] - plain_fwd}
    err = {"pruned_band": "px", "pruned_rows": "py", "pruned_bwd": "d_logits"}
    report = {name: dict(err=errs[err[name]][0], rel=errs[err[name]][1], tol=PRUNED_TOL[err[name]],
                         ms=dev_ms[name], plain_ms=plain[name]) for name in names}
    phase("pruned-lattice", f"get_rnnt_logprobs_pruned's kernels at the recipe's shape B={Bp} T={Tp} "
          f"S={Sp} K={Kp} C={Cp} float32 against the plain version on the card: "
          + "; ".join(f"{k} max abs err {v[0]:.3e} rel {v[1]:.3e} (tol {PRUNED_TOL[k]})"
                      for k, v in errs.items())
          + "; -inf, +inf and NaN patterns equal; kernel ms (profiler) "
          + ", ".join(f"{k} {dev_ms[k]:.4f} (bound {bounds[k][0]:.4f} by {bounds[k][1]})" for k in names)
          + f"; forward {kern_fwd:.4f} ms against the plain {plain_fwd:.4f}; forward and backward "
          + ", ".join(f"{k} {ms[k]:.4f} ms, {mem[k]:.1f} MiB above the inputs" for k in runs))
    return report, bounds


# the largest duration bucket of the conformer cell's traffic, 8 heads of 64
RELPOS_SHAPE = (45, 434, 8, 64)
# norm-wise errors ||got - want|| / ||want|| of (o, each gradient) in bf16,
# against the float64 statement of the kernels' function and against the
# plain version, which rounds qu k^T to bf16 before adding bd: about 2.5
# times this phase's readings on an H100 (2.9e-3, 2.7e-3; 4.4e-3, 4.7e-3:
# PERF.md row 12), below the planted faults' (5.7e-2 and 0.40)
RELPOS_TOL = {"o": 8e-3, "grad": 8e-3}
RELPOS_PLAIN_TOL = {"o": 1e-2, "grad": 1.2e-2}
RELPOS_NAMES = ("o", "dqu", "dk", "dv", "dbd_raw")
# the planted faults: dS set to 0 where P is below each of these
RELPOS_DROPS = (1e-2, 1e-3)
RELPOS_TIMEOUT_S = 600


def relpos_contract(qu, k, v, bd, mask, drop_below=None):
    """The attention kernels' function in float64: exact scores and
    softmax, the probabilities rounded to the inputs' dtype for the product
    with v (the rounding passed through by the gradient); ``drop_below``
    plants a fault, dS set to 0 wherever P < drop_below."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import relpos_attention as ra

    dt = qu.dtype
    ac = torch.einsum("bihd,bjhd->bhij", qu.double(), k.double())
    w = (ac + ra.rel_shift(bd.double())) * qu.shape[3] ** -0.5
    w = w.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(w, dim=-1)
    if drop_below is not None:
        small = p.detach() < drop_below
        w.register_hook(lambda ds: ds.masked_fill(small, 0))
    p = p + (p.to(dt).double() - p).detach()
    return torch.einsum("bhij,bjhd->bihd", p, v.double()).to(dt)


def relpos_worker(out_dir):
    """The ``relpos-attention`` phase in a process of its own (``chip_smoke.py
    --relpos-worker DIR``), so that its profiler and its memory touch
    no other phase: the attention kernels (``csrc/relpos_attention.cu``) at
    the conformer cell's largest bucket in bf16.  o and the gradients of qu,
    k, v and bd_raw held by their norm-wise errors against
    ``relpos_contract`` (``RELPOS_TOL``) and against ``relpos_attention_plain``
    on the same card tensors (``RELPOS_PLAIN_TOL``); the planted faults
    (``RELPOS_DROPS``) must fail ``RELPOS_TOL``; d(bd_raw) 0 where no score
    reads bd_raw; one launch of each kernel a step and B x H x T rows a
    forward by the wrapper's counters.  Then each kernel's device ms
    (profiler, per launch), the plain version's and a library yardstick's
    forward and forward-backward ms (CUDA events:
    ``scaled_dot_product_attention`` with the shifted, scaled and masked bd
    as a float bias, built outside the timing; the port never calls it), and
    the bounds.  Writes ``relpos.json`` into ``out_dir``."""
    import torch
    import torch.nn.functional as F

    from fast_rnnt_tpu_torch.ops.kernels import relpos_attention as ra

    dev = torch.device("cuda", 0)
    Bq, Tq, Hq, hd = RELPOS_SHAPE
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(25)
    _, k, v = torch.randn((Bq, Tq, 3, Hq, hd), generator=g, device=dev).to(dt).unbind(2)
    qu = torch.randn((Bq, Tq, Hq, hd), generator=g, device=dev).to(dt)
    L = 2 * Tq - 1 + (-(2 * Tq - 1) % 8)  # padded and stored (H, B, T, L) as the module makes it
    bd = (torch.randn((Hq, Bq, Tq, L), generator=g, device=dev) * hd ** 0.5).to(dt).transpose(0, 1)
    lens = torch.randint(Tq * 3 // 4, Tq + 1, (Bq,), generator=g, device=dev)
    lens[0] = Tq
    mask = torch.arange(Tq, device=dev)[None, :] < lens[:, None]
    do = torch.randn((Bq, Tq, Hq, hd), generator=g, device=dev).to(dt)

    def fwd(fn):
        return fn(qu, k, v, bd, mask)

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_() for x in (qu, k, v, bd)]
        o = fn(*xs, mask)
        return [o, *torch.autograd.grad(o, xs, do)]

    def norm_errs(got, want):
        return {n: float((a.double() - b.double()).norm() / b.double().norm())
                for n, a, b in zip(RELPOS_NAMES, got, want)}

    launches, rows = dict(ra.LAUNCHES), ra.ROWS
    got = [x.detach() for x in fwd_bwd(ra.relpos_attention)]
    step_launches = {n: ra.LAUNCHES[n] - launches[n] for n in launches}
    if step_launches != {"fwd": 1, "bwd_q": 1, "bwd_kv": 1} or ra.ROWS - rows != Bq * Hq * Tq:
        raise Failed(f"relpos-attention: a step launched {step_launches} and counted {ra.ROWS - rows} "
                     f"rows, expected one of each and {Bq * Hq * Tq}")
    for x, what in zip(got, RELPOS_NAMES):
        if not torch.isfinite(x).all():
            raise Failed(f"relpos-attention {what}: not finite")
    want = [x.detach() for x in fwd_bwd(relpos_contract)]
    plain = [x.detach() for x in fwd_bwd(ra.relpos_attention_plain)]
    errs = {"contract": norm_errs(got, want), "plain": norm_errs(got, plain),
            "plain_vs_contract": norm_errs(plain, want)}
    max_abs = {n: float((a.double() - b.double()).abs().max()) for n, a, b in zip(RELPOS_NAMES, got, want)}
    del plain
    for drop in RELPOS_DROPS:
        bad = [x.detach() for x in fwd_bwd(lambda *a: relpos_contract(*a, drop_below=drop))]
        errs[f"fault {drop}"] = norm_errs(bad, want)
    del bad, want
    with open(os.path.join(out_dir, "relpos.json"), "w") as f:
        json.dump({"errs": errs}, f)  # the readings, kept where a check below fails
    for which, tol in (("contract", RELPOS_TOL), ("plain", RELPOS_PLAIN_TOL)):
        for what, e in errs[which].items():
            if e > tol["o" if what == "o" else "grad"]:
                raise Failed(f"relpos-attention {what}: norm-wise error {e:.3e} against the {which} "
                             f"over {tol}; readings {errs}")
    for drop in RELPOS_DROPS:
        fault = errs[f"fault {drop}"]
        missed = [n for n in ("dqu", "dk", "dbd_raw") if fault[n] <= RELPOS_TOL["grad"]]
        if missed:
            raise Failed(f"relpos-attention: with dS dropped where P < {drop} the check passes "
                         f"{missed}: {fault}")
    reached = torch.zeros((Tq, L), dtype=torch.bool, device=dev)
    ra.rel_shift(reached[None, None])[0, 0].fill_(True)
    if got[4][:, :, ~reached].any():
        raise Failed("relpos-attention: d(bd_raw) is not 0 where no score reads bd_raw")
    del got

    c = hd ** -0.5
    bias = (ra.rel_shift(bd).float() * c).masked_fill(~mask[:, None, None, :], float("-inf")).to(dt)
    qh, kh, vh = (x.transpose(1, 2) for x in (qu, k, v))

    def sdpa(bias_, q_=qh, k_=kh, v_=vh):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias_, scale=c)

    def sdpa_fwd_bwd():
        xs = [x.detach().requires_grad_() for x in (qh, kh, vh, bias)]
        o = sdpa(xs[3], *xs[:3])
        return torch.autograd.grad(o, xs, do.transpose(1, 2))

    ms = {"plain_fwd": kernel_ms(lambda: fwd(ra.relpos_attention_plain)),
          "plain": kernel_ms(lambda: fwd_bwd(ra.relpos_attention_plain)),
          "kernels_fwd": kernel_ms(lambda: fwd(ra.relpos_attention)),
          "kernels": kernel_ms(lambda: fwd_bwd(ra.relpos_attention)),
          "library_fwd": kernel_ms(lambda: sdpa(bias)),
          "library": kernel_ms(sdpa_fwd_bwd)}
    prof = profile_step(lambda: fwd_bwd(ra.relpos_attention))
    if prof is None:
        raise Failed("relpos-attention: the profiler saw no device activity")
    dev_ms = {}
    for name, tag in (("relpos_fwd", "::fwd_tc<"), ("relpos_bwd_q", "::bq_tc<"),
                      ("relpos_bwd_kv", "::bkv_tc<")):
        hit = [r for r in prof[0] if tag in r[0]]
        if len(hit) != 1:
            raise Failed(f"relpos-attention: the profile holds {len(hit)} kernels named {tag}")
        dev_ms[name] = hit[0][1] / hit[0][2] / 1e3  # per launch
    # each kernel's inputs read once and outputs written once, its products
    # at the bf16 tensor-core peak: forward qu k^T and P v; the query-tile
    # backward recomputes S, forms dP and dqu (o and dO for D; dbd whole,
    # zeros included), the key-tile one S, dP, dv and dk
    n_x, n_bd, n_row = Bq * Tq * Hq * hd * 2, Bq * Hq * Tq * L * 2, Bq * Hq * Tq * 4
    prod = 2 * Bq * Hq * Tq * Tq * hd
    bounds = {"relpos_fwd": bound(4 * n_x + n_bd + Bq * Tq + n_row, 2 * prod, BF16_FLOP_PER_S),
              "relpos_bwd_q": bound(6 * n_x + 2 * n_bd + Bq * Tq + 2 * n_row, 3 * prod, BF16_FLOP_PER_S),
              "relpos_bwd_kv": bound(6 * n_x + n_bd + Bq * Tq + 2 * n_row, 4 * prod, BF16_FLOP_PER_S)}
    # the pair's backward with every input read and every output written once
    pair_bwd = bound(8 * n_x + 2 * n_bd + Bq * Tq + n_row, 5 * prod, BF16_FLOP_PER_S)
    err_of = {"relpos_fwd": ("o",), "relpos_bwd_q": ("dqu", "dbd_raw"), "relpos_bwd_kv": ("dk", "dv")}
    plain_ms = {"relpos_fwd": ms["plain_fwd"], "relpos_bwd_q": ms["plain"] - ms["plain_fwd"],
                "relpos_bwd_kv": ms["plain"] - ms["plain_fwd"]}
    library_ms = {"relpos_fwd": ms["library_fwd"], "relpos_bwd_q": ms["library"] - ms["library_fwd"],
                  "relpos_bwd_kv": ms["library"] - ms["library_fwd"]}
    report = {name: dict(err=max(max_abs[n] for n in err_of[name]),
                         norm_err=max(errs["contract"][n] for n in err_of[name]),
                         tol=RELPOS_TOL, ms=dev_ms[name], plain_ms=plain_ms[name],
                         library_ms=library_ms[name], launches=1) for name in dev_ms}
    with open(os.path.join(out_dir, "relpos.json"), "w") as f:
        json.dump({"errs": errs, "report": report, "bounds": bounds, "pair_bwd": pair_bwd, "timed": ms,
                   "keys": [int(lens.min()), Tq]}, f)


def relpos_attention_phase():
    """``relpos_worker`` in a process of its own; its readings and times
    printed.  Returns ({kernel: report entry}, {kernel: bound})."""
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        run_workers([["--relpos-worker", out_dir]], "relpos-attention", timeout=RELPOS_TIMEOUT_S)
        with open(os.path.join(out_dir, "relpos.json")) as f:
            res = json.load(f)
    Bq, Tq, Hq, hd = RELPOS_SHAPE
    errs, report, bounds = res["errs"], res["report"], {k: tuple(v) for k, v in res["bounds"].items()}

    def shown(d):
        return ", ".join(f"{k} {v:.3e}" for k, v in d.items())

    phase("relpos-attention", f"B={Bq} T={Tq} H={Hq} hd={hd} bf16, keys {res['keys'][0]}-{Tq}, in a process "
          f"of its own; norm-wise errors against the float64 contract: {shown(errs['contract'])} (tol "
          f"{RELPOS_TOL}); against the plain version: {shown(errs['plain'])} (tol {RELPOS_PLAIN_TOL}); "
          f"the plain version against the contract: {shown(errs['plain_vs_contract'])}; "
          + "; ".join(f"with dS dropped where P < {d}: {shown(errs[f'fault {d}'])}" for d in RELPOS_DROPS)
          + ", each failing; d(bd_raw) 0 off the band; one launch of each kernel a step; kernel ms "
          "(profiler, a launch) "
          + ", ".join(f"{k} {v['ms']:.4f} (bound {bounds[k][0]:.4f} by {bounds[k][1]})" for k, v in report.items())
          + f"; the backward's bound with each tensor moved once {res['pair_bwd'][0]:.4f} by "
          f"{res['pair_bwd'][1]}; CUDA-event ms " + ", ".join(f"{k} {v:.4f}" for k, v in res["timed"].items()))
    return report, bounds


def launch_counters():
    """Each kernel wrapper's launch count by its name in the ``kernels``
    line: {name: (the wrapper module's LAUNCHES dict, key)}."""
    from fast_rnnt_tpu_torch.ops.kernels import latbuild, pruned, ranges, relpos_attention, wavefront

    return {
        "wavefront_fwd": (wavefront.LAUNCHES, "fwd"),
        "wavefront_bwd": (wavefront.LAUNCHES, "bwd"),
        "latbuild_fwd": (latbuild.LAUNCHES, "fwd"),
        "ranges": (ranges.LAUNCHES, "ranges"),
        "latbuild_bwd": (latbuild.LAUNCHES, "bwd"),
        "latbuild_fwd_parts": (latbuild.LAUNCHES, "fwd_parts"),
        "latbuild_bwd_parts": (latbuild.LAUNCHES, "bwd_parts"),
        "wavefront_fused": (wavefront.LAUNCHES, "fused"),
        "pruned_band": (pruned.LAUNCHES, "band"),
        "pruned_rows": (pruned.LAUNCHES, "rows"),
        "pruned_bwd": (pruned.LAUNCHES, "bwd"),
        "relpos_fwd": (relpos_attention.LAUNCHES, "fwd"),
        "relpos_bwd_q": (relpos_attention.LAUNCHES, "bwd_q"),
        "relpos_bwd_kv": (relpos_attention.LAUNCHES, "bwd_kv"),
    }


def profile_step(step, reps=10):
    """Device time of one step by kernel, from ``torch.profiler`` over
    ``reps`` back-to-back steps: rows (kernel name, us per step, calls per
    step), largest first, the device's busy share of the window from the
    first kernel's start to the last one's end, and the host's reads of a
    device scalar per step (``aten::_local_scalar_dense``: each waits for
    the device).  None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    # device activity only: user annotations (the optimizer's step range)
    # are drawn on the device timeline too
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    per = {}
    for e in dev_events:
        us, n = per.get(e.name, (0.0, 0))
        per[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((k, us / reps, n / reps) for k, (us, n) in per.items()), key=lambda r: -r[1])
    reads = sum(e.name == "aten::_local_scalar_dense" for e in prof.events()) / reps
    return rows, busy / (spans[-1][1] - spans[0][0]), reads


def step_samples(step, n=60):
    """``n`` single-step samples after one warm-up: (median, q1, q3, p90)
    of CUDA-event ms around one call, and the median host wall ms of one
    call with its synchronise."""
    import torch

    step()
    torch.cuda.synchronize()
    dev, wall = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    q = np.percentile(dev, [50, 25, 75, 90])
    return tuple(float(x) for x in q), float(np.median(wall))



# --- the transducer model: a training step, convergence, forced alignment -----

# benchmarks/harness.py:116-127 (BASELINE.json config #5): the model's batch
MODEL_B, MODEL_T_IN, MODEL_S = 8, 1000, 100
# the port's own kernels, by the name the profiler gives their launches
LOSS_KERNELS = ("latbuild_", "image_kernel", "lm_parts_kernel", "ranges_", "sweep_kernel",
                "::band_kernel<", "::rows_kernel<", "::bwd_kernel<")


def model_batch(cfg, seed=0):
    """benchmarks/harness.py's model_train_step batch, in numpy."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(MODEL_B, MODEL_T_IN, cfg.feature_dim)).astype(np.float32)
    flens = np.full(MODEL_B, MODEL_T_IN, np.int32)
    syms = rng.integers(1, cfg.vocab_size, size=(MODEL_B, MODEL_S)).astype(np.int32)
    slens = np.full(MODEL_B, MODEL_S, np.int32)
    return feats, flens, syms, slens


@contextlib.contextmanager
def patched(module, **names):
    """``module``'s attributes replaced by ``names`` inside the block."""
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def rel_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def model_train_phase(dev, t, counted):
    """The full-width training step: one step under the launch counters
    (the nine loss kernels once each), its losses and their gradients
    w.r.t. the loss's inputs held to the plain versions on copies on the
    CPU (fed the card's ranges), 10 more steps, then step time, memory and
    the device-time split.  Returns the step's launch counts."""
    import torch

    from fast_rnnt_tpu_torch import rnnt_loss_pruned, rnnt_loss_simple
    from fast_rnnt_tpu_torch.models import LossConfig, TransducerConfig, init_model, make_train_step
    from fast_rnnt_tpu_torch.models import training

    cfg = TransducerConfig()
    batch = t(*model_batch(cfg))
    model = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    loss_cfg = LossConfig(s_range=S_RANGE)
    step = make_train_step(model, opt, loss_cfg)
    # the same first step with the losses' per-call impl="plain", on a copy
    # of the model and optimizer: no loss kernel runs, and its simple loss is
    # the kernel route's within rel 1e-4 (stage 2 may differ at near-tie
    # ranges)
    model_p = copy.deepcopy(model)
    opt_p = torch.optim.AdamW(model_p.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    step_p = make_train_step(model_p, opt_p, LossConfig(s_range=S_RANGE, impl="plain"))
    metrics_p, _, plain_first_ms, _, _ = counted(lambda: step_p(batch), "model-train (impl plain)", {})
    del model_p, opt_p, step_p

    # the loss's inputs, kept with their gradients by wrappers of the two
    # losses on the training module
    seen = {}

    def keep(name, fn, n_grad):
        def run(*args, **kw):
            for x in args[:n_grad]:
                x.retain_grad()
            seen[name] = (args, kw)
            return fn(*args, **kw)
        return run

    with patched(training, rnnt_loss_simple=keep("simple", training.rnnt_loss_simple, 2),
                 rnnt_loss_pruned=keep("pruned", training.rnnt_loss_pruned, 1)):
        metrics, launches, first_ms, peak_first, base = counted(
            lambda: step(batch), "model-train",
            {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
             "wavefront_bwd": 1, "ranges": 1, "pruned_band": 1, "pruned_rows": 1, "pruned_bwd": 1})
    (s_lm, s_am, sym), kw_s = seen["simple"][0][:3], seen["simple"][1]
    (logits, _, r_card), kw_p = seen["pruned"][0][:3], seen["pruned"][1]
    T_enc = s_am.shape[1]
    if tuple(logits.shape) != (MODEL_B, T_enc, S_RANGE, cfg.vocab_size) or T_enc != MODEL_T_IN // 4:
        raise Failed(f"model-train: logits {tuple(logits.shape)}, {T_enc} encoder frames")

    # the plain versions on the CPU, on copies of the same tensors
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw_s.items()}
    lm_c = s_lm.detach().cpu().requires_grad_()
    am_c = s_am.detach().cpu().requires_grad_()
    lg_c = logits.detach().cpu().requires_grad_()
    simple_c = rnnt_loss_simple(lm_c, am_c, sym.cpu(), **{**cpu, "calc_gradients": False})
    pruned_c = rnnt_loss_pruned(lg_c, sym.cpu(), r_card.cpu(),
                                **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw_p.items()})
    total_c = loss_cfg.simple_scale * simple_c + loss_cfg.pruned_scale * pruned_c
    total_c.backward()
    rels = {k: rel_err(metrics[k], v.detach()) for k, v in
            (("loss", total_c), ("simple_loss", simple_c), ("pruned_loss", pruned_c))}
    if max(rels.values()) > 1e-4:
        raise Failed(f"model-train: losses vs the plain versions on the CPU, rel err {rels} > 1e-4")
    rel_plain = {k: rel_err(metrics_p[k], metrics[k]) for k in ("simple_loss", "pruned_loss")}
    if rel_plain["simple_loss"] > 1e-4:
        raise Failed(f"model-train: LossConfig(impl='plain') step's simple loss rel err {rel_plain} > 1e-4")
    g_err = worst(*(grad_err(a.grad.cpu(), b.grad, f"model-train d {n}", TRAIN_GRAD_TOL)
                    for a, b, n in ((s_lm, lm_c, "simple_lm"), (s_am, am_c, "simple_am"),
                                    (logits, lg_c, "logits"))))
    del seen, s_lm, s_am, logits, lm_c, am_c, lg_c

    losses = torch.stack([metrics["loss"]] + [step(batch)["loss"] for _ in range(10)]).cpu()
    if not bool(torch.isfinite(losses).all()) or not losses[-1] < losses[0]:
        raise Failed(f"model-train: 11 steps on one batch, losses {losses.tolist()}")
    ms = cuda_ms(lambda: step(batch), reps=REPS, inner=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    audio_s = MODEL_B * MODEL_T_IN * 0.01
    phase("model-train", f"TransducerConfig() ({cfg.num_layers} layers, d_model {cfg.d_model}, d_joiner "
          f"{cfg.d_joiner}, vocab {cfg.vocab_size}, {cfg.dtype} compute, {n_params} float32 parameters), "
          f"B={MODEL_B} T_in={MODEL_T_IN} ({T_enc} encoder frames) S={MODEL_S} s_range={S_RANGE}, "
          f"AdamW(1e-3, weight_decay 1e-4), seed 0: launches {json.dumps(launches)}; loss "
          f"{metrics['loss'].item():.3f} (simple {metrics['simple_loss'].item():.3f}, pruned "
          f"{metrics['pruned_loss'].item():.3f}); the step with LossConfig(impl=\"plain\") on a copy: no "
          f"loss kernel launched, simple loss rel {rel_plain['simple_loss']:.3e} (tol 1e-4), pruned rel "
          f"{rel_plain['pruned_loss']:.3e}, first call {plain_first_ms:.1f} ms; rel err vs the plain "
          f"versions on the CPU on the same "
          f"inputs and ranges: total {rels['loss']:.3e} simple {rels['simple_loss']:.3e} pruned "
          f"{rels['pruned_loss']:.3e} (tol 1e-4); gradients w.r.t. simple_lm, simple_am and the "
          f"pruned logits max abs err {g_err[0]:.3e} ({g_err[1]:.3e} of max, tol {TRAIN_GRAD_TOL}); "
          f"losses over 11 steps {losses[0].item():.3f} -> {losses[-1].item():.3f}; step {ms:.3f} ms "
          f"(CUDA events, median of {REPS} single steps; first call {first_ms:.1f} ms), "
          f"{audio_s / (ms / 1e3):.1f} audio-seconds/s; peak {peak:.1f} MiB (first step {peak_first:.1f} "
          f"MiB, {base:.1f} MiB allocated before it)")

    prof = profile_step(lambda: step(batch))
    if prof is None:
        raise Failed("model-train: the profiler saw no device activity")
    rows, busy, _ = prof
    total = sum(r[1] for r in rows)
    loss_us = sum(r[1] for r in rows if any(k in r[0] for k in LOSS_KERNELS))
    phase("model-train", f"profile, torch.profiler, 10 steps: device busy {100 * busy:.1f}% of the device "
          f"window; kernel time {total:.1f} us per step ({100 * total / (ms * 1e3):.1f}% of the "
          f"{ms:.3f} ms step), {sum(r[2] for r in rows):.0f} launches per step: the nine loss kernels "
          f"{loss_us:.1f} us ({100 * loss_us / total:.1f}%), the model's layers, the loss's torch "
          f"glue and AdamW {total - loss_us:.1f} us ({100 * (total - loss_us) / total:.1f}%)")
    for kname, us, calls in rows[:25]:
        print(f"  {us:9.1f} us/step {calls:5.1f} calls/step {100 * us / total:5.1f}%  {kname[:90]}",
              flush=True)
    return launches, ms


CONVERGE_V, CONVERGE_B, CONVERGE_S, CONVERGE_FPS = 16, 16, 6, 8


def copy_accuracy(hyps, lens, syms):
    """Share of the copy task's symbols decoded in place."""
    hyps, lens = np.asarray(hyps), np.asarray(lens)
    Bc, Sc = syms.shape
    hits = sum(int((hyps[b, :min(int(lens[b]), Sc)] == syms[b, :min(int(lens[b]), Sc)]).sum())
               for b in range(Bc))
    return hits / (Bc * Sc)


def converge_arm(dev, rnnt_type, max_symbols_per_frame, **cfg_kw):
    """bench.py's training_convergence on the port: a tiny conformer
    transducer (``cfg_kw`` updates its config) overfit on a synthetic copy
    task (each symbol painted into 8 feature frames), 300 AdamW(3e-3)
    steps, then greedy search and modified beam search (beam 4) on the
    trained batch.  Returns (first loss, best of the last 10, greedy
    accuracy, beam accuracy, seconds, the model, (features, lengths,
    symbols))."""
    import torch

    from fast_rnnt_tpu_torch.models import (
        LossConfig, TransducerConfig, greedy_search, init_model, make_train_step, modified_beam_search,
    )

    V, Bc, Sc, fps = CONVERGE_V, CONVERGE_B, CONVERGE_S, CONVERGE_FPS
    rng = np.random.default_rng(0)
    syms = rng.integers(1, V, size=(Bc, Sc)).astype(np.int32)
    frames = np.repeat(np.eye(V, dtype=np.float32)[syms], fps, axis=1)
    frames = frames + 0.1 * rng.normal(size=frames.shape).astype(np.float32)
    feats = torch.tensor(frames, device=dev)
    flens = torch.full((Bc,), Sc * fps, dtype=torch.int32, device=dev)
    symbols = torch.tensor(syms, device=dev)
    slens = torch.full((Bc,), Sc, dtype=torch.int32, device=dev)
    cfg = TransducerConfig(vocab_size=V, feature_dim=V, d_model=64, d_joiner=64, num_layers=2,
                           num_heads=2, conv_kernel=7, dtype=torch.float32, **cfg_kw)
    model = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(model, opt, LossConfig(s_range=4, rnnt_type=rnnt_type))
    t0 = time.perf_counter()
    losses = torch.stack([step((feats, flens, symbols, slens))["loss"] for _ in range(300)]).cpu().numpy()
    wall = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise Failed(f"model-converge ({rnnt_type}): non-finite loss")

    greedy = copy_accuracy(*(x.cpu() for x in greedy_search(
        model, feats, flens, max_symbols_per_frame=max_symbols_per_frame, max_len=Sc + 2)), syms)
    beam = copy_accuracy(*(x.cpu() for x in modified_beam_search(model, feats, flens, beam=4,
                                                                  max_len=Sc + 2)), syms)
    return float(losses[0]), float(losses[-10:].min()), greedy, beam, wall, model, (feats, flens, syms)


def model_converge_phase(dev):
    """Two arms of the convergence run.  ``regular`` is bench.py's (regular
    RNN-T, greedy up to 4 symbols a frame): its loss must fall 20x and
    greedy reach 95%; its beam accuracy is reported, not held, since the
    beam's one emission per frame is not the topology it was trained in.
    ``modified`` trains the topology the beam search decodes (one symbol
    per frame, the JAX package's note at decoding.py:336-338): loss 20x,
    greedy (one symbol per frame) and beam both 95%."""
    for rnnt_type, cap, held in (("regular", 4, ("greedy",)), ("modified", 1, ("greedy", "beam"))):
        first, last, greedy, beam, wall = converge_arm(dev, rnnt_type, cap)[:5]
        drop = first / max(last, 1e-9)
        acc = {"greedy": greedy, "beam": beam}
        if drop < 20.0 or any(acc[k] < 0.95 for k in held):
            raise Failed(f"model-converge ({rnnt_type}): loss drop {drop:.1f}x (need 20x), accuracy "
                         f"{acc} (need 0.95 for {held})")
        phase("model-converge", f"{rnnt_type} RNN-T: vocab = features = {CONVERGE_V}, d 64, 2 layers, "
              f"2 heads, conv 7, float32, B={CONVERGE_B} S={CONVERGE_S}, {CONVERGE_FPS} frames a symbol, "
              f"300 AdamW(3e-3) steps in {wall:.1f} s: loss {first:.2f} -> {last:.4f} ({drop:.1f}x, need "
              f"20x); greedy ({cap} symbol{'s' if cap > 1 else ''} a frame) accuracy {greedy:.4f}; modified "
              f"beam search (beam 4) accuracy {beam:.4f}; held to 0.95: {', '.join(held)}")


def path_score(px, py, frames, se, te):
    """Score of the regular-lattice path that emits symbol s at frame
    ``frames[s]`` (numpy, one utterance)."""
    score, t = 0.0, 0
    for s in range(se + 1):
        end = te if s == se else frames[s]
        score += py[s, t:end].sum(dtype=np.float64)
        t = end
        if s < se:
            score += float(px[s, t])
    return score


def alignment_phase(dev, lm, am, sym, bnd):
    """``viterbi_alignment`` of the headline lattice on the card against
    its own result on the CPU: scores to rel 1e-5; emission frames equal,
    or, where they differ, the card's path scored on the CPU's lattice
    within 1e-4 of the CPU's best (a near-tie).  Returns the card's scores
    and frames (on the host) and its first call's ms, which the dtensor
    phase's sharded path is held to."""
    import torch

    from fast_rnnt_tpu_torch import viterbi_alignment
    from fast_rnnt_tpu_torch.ops.kernels import latbuild

    px_r, py_r = latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)
    px, py = px_r.movedim(1, 0).contiguous(), py_r.movedim(1, 0).contiguous()
    del px_r, py_r
    t0 = time.perf_counter()
    sc_d, fr_d, ind_d = viterbi_alignment(px, py, bnd)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    px_c, py_c, bnd_c = px.cpu(), py.cpu(), bnd.cpu()
    sc_c, fr_c, _ = viterbi_alignment(px_c, py_c, bnd_c)
    rel = ((sc_d.cpu().double() - sc_c.double()).abs() / sc_c.double().abs()).max().item()
    if not (rel <= 1e-5):
        raise Failed(f"alignment: scores rel err {rel:.3e} vs the CPU > 1e-5")
    if not torch.equal(ind_d.sum(2), (fr_d >= 0).to(ind_d.dtype)):
        raise Failed("alignment: the card's px indicator is not one arc per emitted symbol")
    differ = (fr_d.cpu() != fr_c).any(1).nonzero().flatten().tolist()
    gap = 0.0
    for b in differ:
        se, te = int(bnd_c[b, 2]), int(bnd_c[b, 3])
        args = (px_c[b].numpy(), py_c[b].numpy())
        got = path_score(*args, fr_d[b].cpu().numpy(), se, te)
        gap = max(gap, abs(got - float(sc_c[b])))
    if gap > 1e-4:
        raise Failed(f"alignment: emission frames differ from the CPU's on utterances {differ}, path "
                     f"score gap {gap:.3e} > 1e-4")
    phase("alignment", f"viterbi_alignment of the headline lattice [{B}, {S}, {T + 1}] on the card "
          f"({card_s * 1e3:.1f} ms, first call) against the CPU: scores rel err {rel:.3e} (tol 1e-5); "
          f"emission frames equal on {B - len(differ)} of {B} utterances, the rest near-ties (path score "
          f"gap {gap:.3e}, tol 1e-4)")
    return sc_d.cpu(), fr_d.cpu(), card_s * 1e3


# --- serving: the causal model streamed, and through StreamServer ------------

# bench.py:339-360 (streaming_bench): TransducerConfig(causal=True,
# attention_left_context=32) at full width, StreamingConfig(chunk=32,
# max_len=256), capacities 8, 32 and 128, beam 4 at 128
SERVE_CHUNK, SERVE_MAX_LEN, SERVE_LEFT = 32, 256, 32
SERVE_STREAMS, SERVE_CAPACITY, SERVE_BEAM_STREAMS = 256, 128, 32
SERVE_TIME = ((8, 0), (32, 0), (128, 0), (128, 4))  # (capacity, beam)
# streamed against offline encoder rows, in units of max |am|: float32 with
# TF32 off; bf16 compute, from the measured round-off (8.6e-3 on an H100:
# cuBLAS reduces keys of L + n = 40 frames and of T frames in other orders,
# and a bf16 step at the rows' top is 3.6e-3 of max |am|) with a margin
ENC_F32_TOL = 1e-5
ENC_BF16_TOL = 2e-2
# a stream whose served tokens differ from offline passes only at a near-tie
# of the offline logits: 1e-4 in float32, 2 bf16 steps of the winning logit
GAP_F32 = 1e-4
GAP_BF16_ULPS = 2


def serve_models(dev):
    """The bench's causal model from ``Generator().manual_seed(0)``, in bf16
    compute (``TransducerConfig``'s) and, over the same float32 parameters,
    in float32 compute."""
    import torch

    from fast_rnnt_tpu_torch.models import PrunedTransducer, TransducerConfig, init_model

    cfg = TransducerConfig(causal=True, attention_left_context=SERVE_LEFT)
    bf16 = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    f32 = PrunedTransducer(TransducerConfig(causal=True, attention_left_context=SERVE_LEFT,
                                            dtype=torch.float32)).to(dev)
    f32.load_state_dict(bf16.state_dict(), strict=True)
    return {"float32": f32, "bf16": bf16}


def serve_streams(n, feature_dim, seed=0):
    """``n`` utterances of 200 to 1,000 input frames (10 ms each) of
    normal features, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(200, 1001, size=n)
    return [rng.normal(size=(int(L), feature_dim)).astype(np.float32) for L in lengths]


def padded(utts, dev, multiple=1):
    """Zero-padded (B, T, F) features on ``dev`` (T a multiple of
    ``multiple``) and (B,) int32 lengths."""
    import torch

    T = -(-max(len(u) for u in utts) // multiple) * multiple
    feats = np.zeros((len(utts), T, utts[0].shape[1]), np.float32)
    for i, u in enumerate(utts):
        feats[i, : len(u)] = u
    return (torch.tensor(feats, device=dev),
            torch.tensor([len(u) for u in utts], dtype=torch.int32, device=dev))


def bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0**-126))) - 7)


def stream_encoder_phase(dev, models, counted):
    """16 ragged streams encoded chunk by chunk (``encode_stream``, the
    carried state) and offline by the same causal model: the streamed am
    rows of every real frame against the offline rows, in float32 compute
    (TF32 off) to ENC_F32_TOL of max |am| and in bf16 compute to
    ENC_BF16_TOL.  The path launches none of the port's kernels."""
    import torch

    from fast_rnnt_tpu_torch.models import encoder_stream_state

    cfg = models["bf16"].cfg
    utts = serve_streams(16, cfg.feature_dim)
    feats, flens = padded(utts, dev, SERVE_CHUNK)
    report = []
    for name, model in models.items():
        def run():
            with torch.no_grad():
                st = encoder_stream_state(model.cfg, feats.shape[0], dev)
                rows = []
                for i in range(feats.shape[1] // SERVE_CHUNK):
                    am, st = model.encode_stream(feats[:, i * SERVE_CHUNK:(i + 1) * SERVE_CHUNK], st)
                    rows.append(am)
                return torch.cat(rows, dim=1)

        streamed, _, first_ms, _, _ = counted(run, f"stream-encoder ({name})", {})
        with torch.no_grad():
            enc, out_lens = model.encoder(feats, flens)
            offline = model.am_proj(enc)
        real = torch.arange(offline.shape[1], device=dev)[None, :] < out_lens[:, None]
        if not bool(torch.isfinite(streamed[:, :offline.shape[1]][real]).all()):
            raise Failed(f"stream-encoder ({name}): non-finite streamed rows")
        d = (streamed[:, :offline.shape[1]] - offline).abs()[real]
        scale = offline.abs()[real].max().item()
        err = d.max().item() / scale
        tol = ENC_F32_TOL if name == "float32" else ENC_BF16_TOL
        share = (d > 0).float().mean().item()
        if not err <= tol:
            raise Failed(f"stream-encoder ({name}): streamed am rows {err:.3e} of max |am| from "
                         f"offline (tol {tol})")
        report.append(f"{name} compute: max abs err {d.max().item():.3e} ({err:.3e} of max |am| "
                      f"{scale:.3f}, tol {tol}), {100 * share:.1f}% of entries differ, mean abs err "
                      f"{d.mean().item():.3e}; {first_ms:.1f} ms for {feats.shape[1] // SERVE_CHUNK} "
                      f"chunks")
    phase("stream-encoder", f"TransducerConfig(causal=True, attention_left_context={SERVE_LEFT}) "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}), weights from Generator().manual_seed(0); "
          f"16 streams of {min(map(len, utts))}-{max(map(len, utts))} input frames (default_rng(0)), "
          f"chunk {SERVE_CHUNK}, streamed against offline am rows of every real frame; launches of "
          f"the port's kernels 0: " + "; ".join(report))


def greedy_replay(logits, n_frames, T, served, max_len, max_sym, blank):
    """Replay ``greedy_over_frames`` for one stream from the logits its
    offline run recorded at every trip ((trips, C), numpy): returns the
    offline tokens it decides and the gap at the first decision where the
    served tokens can have left them.

    A decision is a trip on a real frame with room to emit.  The served
    tokens equal the offline ones up to the first differing decision, so
    that decision is one of: an offline emission that the served tokens do
    not have next (served chose its next token or blank), an offline
    blank (served emitted its next token), or an offline emission that the
    served tokens match later (served chose blank).  The gap is the least,
    over every decision up to the first mismatch, of the offline winner's
    logit less the logit of the served alternative: it is no more than
    the gap at the first differing decision and no less than that trip's
    top-2 gap."""
    t = cnt = n = 0
    toks, gaps, mismatch = [], [], False
    for L in logits:
        if t >= T:
            break
        sym = int(np.argmax(L))
        decision = t < n_frames and len(toks) < max_len and cnt < max_sym
        take = decision and sym != blank
        if decision and not mismatch:
            nxt = served[n] if n < len(served) else None
            if take and nxt == sym:
                n += 1
                gaps.append((L[sym] - L[blank], L[sym]))
            elif take:
                alt = L[blank] if nxt is None else max(L[nxt], L[blank])
                gaps.append((L[sym] - alt, L[sym]))
                mismatch = True
            elif nxt is not None:
                gaps.append((L[blank] - L[nxt], L[blank]))
        if take:
            toks.append(sym)
            cnt += 1
        else:
            t, cnt = t + 1, 0
    return toks, (min(gaps) if gaps else (np.inf, 0.0))


def served_vs_offline(name, served, off_hyps, off_lens, near_tie):
    """Every stream's served tokens against its offline ones: the streams
    that differ, each passed by ``near_tie(b)`` (a gap within its bound) or
    failing the run.  Returns (equal streams, near-tie streams, largest
    near-tie gap)."""
    equal, ties, worst_gap = 0, [], 0.0
    for b in range(len(off_lens)):
        want = off_hyps[b, : off_lens[b]]
        if np.array_equal(served[b], want):
            equal += 1
            continue
        ok, gap, what = near_tie(b)
        if not ok:
            raise Failed(f"{name}: stream {b} differs from offline ({len(served[b])} against "
                         f"{len(want)} tokens) and is no near-tie: {what}")
        ties.append(b)
        worst_gap = max(worst_gap, gap)
    return equal, ties, worst_gap


def serve_phase(dev, models, counted):
    """SERVE_STREAMS ragged streams through ``StreamServer(capacity=
    SERVE_CAPACITY)`` with slot churn, greedy, in float32 compute (TF32 off)
    and in bf16 compute: every stream's tokens equal the port's offline
    ``greedy_search`` on the card, or differ first at a near-tie of the
    offline logits (``greedy_replay``).  Returns the bf16 run's (audio
    seconds per second, peak MiB)."""
    import torch

    from fast_rnnt_tpu_torch.models import StreamServer, StreamingConfig, greedy_search

    cfg = models["bf16"].cfg
    utts = serve_streams(SERVE_STREAMS, cfg.feature_dim)
    audio_s = sum(len(u) for u in utts) * 0.01
    feats, flens = padded(utts, dev)
    scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=SERVE_MAX_LEN)
    stats = {}
    for name, model in models.items():
        server = StreamServer(model, scfg, SERVE_CAPACITY)
        for i, u in enumerate(utts):
            server.submit(i, u)
        steps = [0]

        def run():
            out = {}
            while not server.idle:
                out.update(server.step())
                steps[0] += 1
            return out

        got, _, wall_ms, peak, base = counted(run, f"serve ({name})", {})
        if set(got) != set(range(SERVE_STREAMS)):
            raise Failed(f"serve ({name}): {SERVE_STREAMS - len(got)} streams never finished")
        if any(len(v) and (v.min() < 1 or v.max() >= cfg.vocab_size) for v in got.values()):
            raise Failed(f"serve ({name}): a token outside [1, {cfg.vocab_size})")
        stats[name] = (audio_s / (wall_ms / 1e3), peak, wall_ms, steps[0])

        # offline on the card, the joiner's logits of every trip recorded
        trips = []

        def join(a, l, real=model.join):
            out = real(a, l)
            trips.append(out[:, 0, 0, :])
            return out

        model.join = join
        try:
            off_h, off_l = greedy_search(model, feats, flens, max_len=SERVE_MAX_LEN)
        finally:
            del model.join
        off_h, off_l = off_h.cpu().numpy(), off_l.cpu().numpy()
        n_frames = ((flens + 3) // 4).cpu().numpy()
        T = int(n_frames.max())

        stacked = []

        def near_tie(b):
            if not stacked:
                stacked.append(torch.stack(trips, dim=1))  # (B, trips, C)
            logits = stacked[0][b].cpu().numpy()
            toks, (gap, win) = greedy_replay(logits, n_frames[b], T, list(got[b]), SERVE_MAX_LEN,
                                             scfg.max_symbols_per_frame, cfg.blank_id)
            if toks != list(off_h[b, : off_l[b]]):
                raise Failed(f"serve ({name}): the replay of stream {b} does not give its offline tokens")
            bound = GAP_F32 if name == "float32" else GAP_BF16_ULPS * bf16_ulp(win)
            return gap <= bound, gap, f"offline logit gap {gap:.3e} at the first differing decision " \
                                      f"(bound {bound:.3e})"

        equal, ties, gap = served_vs_offline(f"serve ({name})", got, off_h, off_l, near_tie)
        del trips, stacked
        tokens = int(off_l.sum())
        phase("serve", f"{name} compute: {SERVE_STREAMS} streams of {min(map(len, utts))}-"
              f"{max(map(len, utts))} input frames (default_rng(0), {audio_s:.1f} audio-seconds) "
              f"through StreamServer(capacity={SERVE_CAPACITY}, chunk={SERVE_CHUNK}, max_len="
              f"{SERVE_MAX_LEN}), greedy, in {steps[0]} steps and {wall_ms:.1f} ms "
              f"({stats[name][0]:.1f} audio-seconds/s, peak {peak:.1f} MiB, {base:.1f} MiB before); "
              f"launches of the port's kernels 0; tokens equal to the offline greedy_search on the "
              f"card on {equal} of {SERVE_STREAMS} streams ({tokens} offline tokens), near-ties "
              f"{len(ties)} (largest gap {gap:.3e}; bound "
              f"{'%g' % GAP_F32 if name == 'float32' else '%d bf16 steps of the winning logit' % GAP_BF16_ULPS})"
              + (f": streams {ties[:16]}" if ties else ""))
    return stats["bf16"]


class SortTap:
    """Stands in for ``torch`` in the decoding module and keeps the top
    ``keep`` scores of every sort (the beam's ranked candidates)."""

    def __init__(self, keep):
        import torch

        self._torch, self.keep, self.rows = torch, keep, []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def sort(self, x, *args, **kw):
        out = self._torch.sort(x, *args, **kw)
        self.rows.append(out[0][:, : self.keep])
        return out


def serve_beam_phase(dev, model, counted):
    """SERVE_BEAM_STREAMS ragged streams through ``StreamServer(capacity=
    SERVE_BEAM_STREAMS)`` with ``beam=4``, float32 compute: every stream's
    tokens equal the port's offline ``modified_beam_search`` on the card,
    or the offline beam of that stream has a near-tie (GAP_F32) between
    neighbouring ranks of its top beam+1 candidates at some frame, or
    between its final best two scores."""
    import torch

    from fast_rnnt_tpu_torch.models import StreamServer, StreamingConfig, decoding

    H = 4
    cfg = model.cfg
    utts = serve_streams(SERVE_BEAM_STREAMS, cfg.feature_dim)
    feats, flens = padded(utts, dev)
    server = StreamServer(model, StreamingConfig(chunk=SERVE_CHUNK, max_len=SERVE_MAX_LEN, beam=H),
                          SERVE_BEAM_STREAMS)
    for i, u in enumerate(utts):
        server.submit(i, u)
    got, _, wall_ms, peak, _ = counted(server.run, "serve-beam", {})
    if set(got) != set(range(SERVE_BEAM_STREAMS)):
        raise Failed("serve-beam: a stream never finished")

    tap, finals = SortTap(H + 1), []

    def best(scores, hyps, lens, real=decoding.beam_best):
        finals.append(scores.sort(dim=1, descending=True)[0][:, :2])
        return real(scores, hyps, lens)

    with patched(decoding, torch=tap, beam_best=best):
        off_h, off_l = decoding.modified_beam_search(model, feats, flens, beam=H, max_len=SERVE_MAX_LEN)
    off_h, off_l = off_h.cpu().numpy(), off_l.cpu().numpy()

    ranked = torch.stack(tap.rows, dim=1).cpu().numpy()  # (B, frames, H + 1)
    final_gap = (finals[0][:, 0] - finals[0][:, 1]).cpu().numpy()

    def near_tie(b):
        gaps = np.append((ranked[b, :, :-1] - ranked[b, :, 1:]).ravel(), final_gap[b])
        gap = float(np.min(gaps[np.isfinite(gaps)]))
        return gap <= GAP_F32, gap, f"least offline gap between neighbouring ranks {gap:.3e}"

    equal, ties, gap = served_vs_offline("serve-beam", got, off_h, off_l, near_tie)
    phase("serve-beam", f"float32 compute: {SERVE_BEAM_STREAMS} streams of {min(map(len, utts))}-"
          f"{max(map(len, utts))} input frames through StreamServer(capacity={SERVE_BEAM_STREAMS}, "
          f"chunk={SERVE_CHUNK}, beam={H}) in {wall_ms:.1f} ms (peak {peak:.1f} MiB); launches of the "
          f"port's kernels 0; tokens equal to the offline modified_beam_search on the card on {equal} "
          f"of {SERVE_BEAM_STREAMS} streams ({int(off_l.sum())} offline tokens), near-ties {len(ties)} "
          f"(largest gap {gap:.3e}, bound {GAP_F32})")


def serve_converge_phase(dev, counted):
    """``model-converge``'s modified arm built causal with
    ``attention_left_context=8``, its trained batch decoded through
    ``StreamServer(capacity=4)``, greedy (one symbol a frame) and beam 4:
    tokens equal to offline exactly (a trained model has no near-ties to
    excuse) and accuracy >= 0.95."""
    from fast_rnnt_tpu_torch.models import (
        StreamServer, StreamingConfig, greedy_search, modified_beam_search,
    )

    first, last, _, _, wall, model, (feats, flens, syms) = converge_arm(
        dev, "modified", 1, causal=True, attention_left_context=8)
    Sc = syms.shape[1]
    f_np = feats.cpu().numpy()
    acc = {}
    for name, beam in (("greedy", 0), ("beam", 4)):
        scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=Sc + 2, beam=beam, max_symbols_per_frame=1)
        server = StreamServer(model, scfg, capacity=4)
        for b in range(len(f_np)):
            server.submit(b, f_np[b])
        got, _, _, _, _ = counted(server.run, f"serve-converge ({name})", {})
        if beam:
            off_h, off_l = modified_beam_search(model, feats, flens, beam=4, max_len=Sc + 2)
        else:
            off_h, off_l = greedy_search(model, feats, flens, max_symbols_per_frame=1, max_len=Sc + 2)
        off_h, off_l = off_h.cpu().numpy(), off_l.cpu().numpy()
        differ = [b for b in range(len(f_np)) if not np.array_equal(got[b], off_h[b, : off_l[b]])]
        if differ:
            raise Failed(f"serve-converge ({name}): served tokens differ from offline on streams {differ}")
        hyps = np.zeros((len(f_np), Sc + 2), np.int32)
        lens = np.array([len(got[b]) for b in range(len(f_np))])
        for b in range(len(f_np)):
            hyps[b, : lens[b]] = got[b]
        acc[name] = copy_accuracy(hyps, lens, syms)
    drop = first / max(last, 1e-9)
    if min(acc.values()) < 0.95:
        raise Failed(f"serve-converge: served accuracy {acc} (need 0.95)")
    phase("serve-converge", f"model-converge's modified arm built causal (attention_left_context=8): "
          f"300 steps in {wall:.1f} s, loss {first:.2f} -> {last:.4f} ({drop:.1f}x); {len(f_np)} "
          f"streams through StreamServer(capacity=4, chunk={SERVE_CHUNK}): tokens equal to offline on "
          f"all streams, greedy (one symbol a frame) and beam 4; accuracy greedy {acc['greedy']:.4f}, "
          f"beam {acc['beam']:.4f} (need 0.95)")


def serve_time_phase(dev, model, run_stats):
    """The chunk step (``streaming_step``, bf16 compute, the bench's
    config) at each SERVE_TIME capacity: CUDA events, the median of 10
    single steps after a warm-up, each step from the same state (4 chunks
    in, so the attention window is full); launches, host reads and device
    busy per step from ``torch.profiler`` over 3 steps.  Returns the ms of
    each (capacity, beam)."""
    import torch

    from fast_rnnt_tpu_torch.models import StreamingConfig, streaming_init, streaming_step

    chunk_s = SERVE_CHUNK * 0.01
    rows, step_ms = [], {}
    for cap, beam in SERVE_TIME:
        scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=SERVE_MAX_LEN, beam=beam)
        rng = np.random.default_rng(0)
        feats = torch.tensor(rng.normal(size=(cap, SERVE_CHUNK, model.cfg.feature_dim))
                             .astype(np.float32), device=dev)
        lens = torch.full((cap,), SERVE_CHUNK, dtype=torch.int32, device=dev)
        state = streaming_init(model, scfg, cap)
        for _ in range(4):
            state, _ = streaming_step(model, scfg, state, feats, lens)

        def step():
            return streaming_step(model, scfg, state, feats, lens)

        ms = step_ms[cap, beam] = cuda_ms(step, reps=REPS, inner=1)
        prof = profile_step(step, reps=3)  # ~3,700 launches a step: the profiler's events are slow
        if prof is None:
            raise Failed(f"serve-time: the profiler saw no device activity at capacity {cap}")
        prows, busy, reads = prof
        kernel_us = sum(r[1] for r in prows)
        rows.append(f"capacity {cap} {'beam ' + str(beam) if beam else 'greedy'}: {1e3 * ms:.1f} us a "
                    f"chunk step (RTF {ms / 1e3 / chunk_s:.4f}, {int(cap * chunk_s / (ms / 1e3))} "
                    f"streams at real time), {sum(r[2] for r in prows):.0f} launches and {reads:.0f} "
                    f"host reads a step, {kernel_us:.1f} us of kernels, device busy {100 * busy:.1f}%")
    audio_per_s, peak, wall_ms, steps = run_stats
    phase("serve-time", f"bf16 compute, chunk {SERVE_CHUNK} ({1e3 * chunk_s:.0f} ms of audio), "
          f"max_len {SERVE_MAX_LEN}, random weights (greedy emits the cap of 4 symbols on nearly every "
          f"frame: up to 40 trips a step); median of {REPS} single steps (CUDA events), launches, host "
          f"reads and device busy from torch.profiler over 3 steps: " + "; ".join(rows)
          + f"; the {SERVE_STREAMS}-stream bf16 serve run: {audio_per_s:.1f} audio-seconds/s "
          f"({steps} steps in {wall_ms:.1f} ms), peak {peak:.1f} MiB")
    return step_ms


TRACE_DIR = os.path.join(HERE, "build", "trace")


def sweep_phase(name):
    """The phase (1 forward, 2 backward, 3 both) in a profiler's name of a
    ``sweep_kernel`` instantiation, or None for another kernel: the fourth
    template argument (``<St, kMod, kBand, kPh, kAt>``), ``3``,
    ``(Phases)3`` or ``kBoth``."""
    import re

    m = re.search(r"sweep_kernel<([^<>]*)>", name)
    if m is None:
        return None
    ph = re.sub(r"^\(\w+\)", "", m.group(1).split(",")[3].strip())
    return {"1": 1, "2": 2, "3": 3, "kFwd": 1, "kBwd": 2, "kBoth": 3}.get(ph)


def kernel_families(kernels):
    """Which of the six main-path kernel families a set of profiler kernel
    names holds (the smoothed build runs the same two build kernels)."""
    return {
        "latbuild_fwd": any("latbuild_fwd_kernel" in k for k in kernels),
        "latbuild_bwd": any("latbuild_bwd_" in k for k in kernels),
        "ranges": any("ranges_argmax_kernel" in k for k in kernels),
        "wavefront_fwd": any(sweep_phase(k) == 1 for k in kernels),
        "wavefront_bwd": any(sweep_phase(k) == 2 for k in kernels),
        "wavefront_fused": any(sweep_phase(k) == 3 for k in kernels),
    }


def profiling_phase(dev, am, lm, sym, bnd, fwd_peak, model, serve_ms):
    """``fast_rnnt_tpu_torch.utils.profiling`` on the card: ``bench.py``'s
    train step by ``benchmark_on_device`` beside ``cuda_ms`` without and
    with a head start; the forward step's ``compiled_memory_mb`` beside the
    main path's counted peak (``fwd_peak``: peak and MiB allocated before);
    a ``trace_to`` run of one train step under ``annotate("train_step")``
    into build/trace/, which must hold the span and the six main-path
    kernels; and the bf16 chunk step at 32 streams by
    ``benchmark_carried_on_device`` beside ``serve-time``'s figure."""
    import shutil

    import torch

    from fast_rnnt_tpu_torch import rnnt_loss_simple_pruned
    from fast_rnnt_tpu_torch.models import StreamingConfig, streaming_init, streaming_step
    from fast_rnnt_tpu_torch.utils import (
        annotate,
        benchmark_on_device,
        compiled_memory_mb,
        device_memory_stats,
        trace_to,
    )
    from fast_rnnt_tpu_torch.utils.profiling import benchmark_carried_on_device

    def forward(a, l, s, b):
        return rnnt_loss_simple_pruned(l, a, s, 0, S_RANGE, b, reduction="none")

    def train(a, l):  # bench.py's step
        simple, pruned, _ = forward(a, l, sym, bnd)
        return torch.autograd.grad(0.5 * simple.sum() + pruned.sum(), (a, l))

    am_g, lm_g = am.clone().requires_grad_(), lm.clone().requires_grad_()
    est_ms = 1e3 * benchmark_on_device(train, am_g, lm_g)
    events_ms = cuda_ms(lambda: train(am_g, lm_g))
    head_ms = cuda_ms(lambda: train(am_g, lm_g), head_start=True)

    torch._C._cuda_clearCublasWorkspaces()
    mem = compiled_memory_mb(forward, am, lm, sym, bnd)
    stats = device_memory_stats()

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    # the profiler keeps the device's activity inside the host's window of
    # the block, the two clocks matched approximately: a margin on each side
    # of the step keeps its first and last kernels in the window (a run
    # without it lost the step's backward kernels once in five)
    with trace_to(TRACE_DIR) as prof:
        time.sleep(0.05)
        with annotate("train_step"):
            train(am_g, lm_g)
        torch.cuda.synchronize()
        time.sleep(0.1)
    files = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    if len(files) != 1:
        raise Failed(f"profiling: trace_to wrote {files}, not one trace")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e.get("name", "") for e in events if e.get("cat") == "kernel"})
    seen = kernel_families(kernels)
    span = sum(e.get("name") == "train_step" for e in events)
    if not span or not all(seen.values()) or not any(e.name == "train_step" for e in prof.events()):
        raise Failed(f"profiling: the trace holds the train_step span {span} times and the kernels "
                     f"{seen}; its kernel names: {[k[:80] for k in kernels]}")

    # a hypothesis buffer the chain cannot fill (a full one stops emission,
    # and greedy then takes 8 trips a step, not up to 40), so that the
    # chained steps are serve-time's step
    cap = 32
    scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=4 * SERVE_MAX_LEN)
    rng = np.random.default_rng(0)
    feats = torch.tensor(rng.normal(size=(cap, SERVE_CHUNK, model.cfg.feature_dim))
                         .astype(np.float32), device=dev)
    lens = torch.full((cap,), SERVE_CHUNK, dtype=torch.int32, device=dev)
    state = streaming_init(model, scfg, cap)
    for _ in range(4):  # serve-time's starting state: the attention window full
        state, _ = streaming_step(model, scfg, state, feats, lens)
    carried_ms = 1e3 * benchmark_carried_on_device(
        lambda st, f, n: streaming_step(model, scfg, st, f, n)[0], state, feats, lens, iters=5)

    peak, base = fwd_peak
    phase("profiling", f"train step (bench.py's: grad of 0.5*simple + pruned, B={B} T={T} S={S} "
          f"C={C}): benchmark_on_device {est_ms:.4f} ms (median over 3 trials of the slope between "
          f"20 and 60 steps behind a head start sized from the host's enqueue time); cuda_ms "
          f"{events_ms:.4f} ms (10 steps, no head start); cuda_ms(head_start=True) {head_ms:.4f} ms "
          f"(10 steps behind a fixed {HEAD_START:,}-cycle wait).  Forward step compiled_memory_mb: "
          + ", ".join(f"{k} {v:.1f}" for k, v in mem.items()) + f" MiB, beside main-path's counted "
          f"peak {peak:.1f} MiB ({peak - base:.1f} MiB above what was allocated before it); "
          f"device_memory_stats " + ", ".join(f"{k} {v:.1f}" for k, v in stats.items()) + ".  "
          f"trace_to -> {os.path.relpath(files[0], HERE)}: the train_step span ({span} events) and "
          f"the kernels {sorted(seen)} ({len(kernels)} kernel names).  bf16 chunk step at {cap} "
          f"streams, greedy: benchmark_carried_on_device {carried_ms:.3f} ms (slope between 5 and 15 "
          f"chained steps, max_len {scfg.max_len}) beside serve-time's {serve_ms[cap, 0]:.3f} ms "
          f"(median of single steps from one state)")


# --- audio in: the host library, data-parallel training, serving audio -------

SAMPLE_RATE, HOP_S = 16000, 0.01
# the dp-train cell: 8 utterances of 6-10 s, two ranks of 4 on the one card
DP_UTTS, DP_WORLD, DP_STEPS, DP_TIMED = 8, 2, 3, 5
DP_TIMEOUT_S = 600
# all-reduces in one data-parallel step: the gradients (one float32 buffer),
# the float metrics (loss, simple_loss, pruned_loss) and the integer frame
# count, which all_reduce_sum buckets apart by dtype
DP_ALLREDUCES = 3
# serve-audio: 32 ragged streams fed in 0.32 s pieces (= SERVE_CHUNK frames)
AUDIO_STREAMS, AUDIO_PIECE_S = 32, 0.32
EXAMPLE_MIN_ACC = 0.95


def synth_wavs(n, lo_s, hi_s, rng):
    """``n`` synthetic waveforms of ``lo_s``-``hi_s`` seconds at 16 kHz:
    noise at 0.1 under a few tones."""
    out = []
    for n_samp in rng.integers(int(lo_s * SAMPLE_RATE), int(hi_s * SAMPLE_RATE) + 1, size=n):
        t = np.arange(int(n_samp), dtype=np.float32) / SAMPLE_RATE
        tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100.0, 4000.0, size=3))
        out.append((tones + 0.1 * rng.normal(size=len(t))).astype(np.float32))
    return out


def dp_batch(cfg):
    """The dp-train cell's global batch: DP_UTTS waveforms of 6-10 s from
    ``default_rng(0)`` through ``fbank_cpu`` (80 mels) and
    ``RaggedBatcher(pad_batch_to=8, quantum=64)``, 50-100 symbols each.
    Returns (batch, audio seconds, fbank seconds)."""
    from fast_rnnt_tpu_torch.data import RaggedBatcher, fbank_cpu

    rng = np.random.default_rng(0)
    wavs = synth_wavs(DP_UTTS, 6.0, 10.0, rng)
    syms = [rng.integers(1, cfg.vocab_size, size=int(s)).astype(np.int32)
            for s in rng.integers(50, 101, size=DP_UTTS)]
    t0 = time.perf_counter()
    feats = [fbank_cpu(w, n_mels=cfg.feature_dim) for w in wavs]
    fbank_s = time.perf_counter() - t0
    batches = list(RaggedBatcher(pad_batch_to=DP_UTTS, quantum=64).batches(feats, syms))
    if len(batches) != 1 or int((batches[0][1] > 0).sum()) != DP_UTTS:
        raise Failed(f"dp-train: the planner made {len(batches)} batches of the {DP_UTTS} utterances")
    return batches[0], sum(len(w) for w in wavs) / SAMPLE_RATE, fbank_s


def dp_worker(rank, world, out_dir, backend):
    """One rank of the dp-train cell (``chip_smoke.py --dp-worker``): the
    sum of the shards' single-process gradients on a copy of the model,
    then the data-parallel step on this rank's shard under the launch
    counters, DP_STEPS steps, one step under ``torch.profiler`` with shapes
    for ``collective_census``, DP_TIMED timed steps; writes rank<r>.json."""
    import copy

    import torch

    from fast_rnnt_tpu_torch.models import LossConfig, TransducerConfig, init_model, make_train_step
    from fast_rnnt_tpu_torch.models.training import pruned_transducer_loss
    from fast_rnnt_tpu_torch.ops.kernels import _build
    from fast_rnnt_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch
    from fast_rnnt_tpu_torch.parallel.sharding import all_reduce_sum
    from fast_rnnt_tpu_torch.utils import collective_census

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_distributed(f"file://{os.path.join(out_dir, 'store')}", world, rank, device="cuda",
                           backend=backend)
    mesh = make_mesh("cuda")
    got_backend = torch.distributed.get_backend()
    if mesh.size() != world or got_backend != backend:
        raise Failed(f"rank {rank}: mesh of {mesh.size()} ranks on {got_backend}")
    _build.load_library()
    dev = torch.device("cuda", 0)

    cfg = TransducerConfig()
    batch, _, _ = dp_batch(cfg)
    B = len(batch[0])
    model = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    loss_cfg = LossConfig(s_range=S_RANGE)
    ref = copy.deepcopy(model)

    def shard_grads(k):
        sl = slice(k * B // world, (k + 1) * B // world)
        ref.zero_grad(set_to_none=True)
        total, _ = pruned_transducer_loss(ref, *(torch.from_numpy(x[sl]).to(dev) for x in batch),
                                          loss_cfg)
        total.backward()
        return [p.grad.clone() for p in ref.parameters()]

    shards = [shard_grads(k) for k in range(world)]
    again = shard_grads(0)  # the same shard twice: is the single-process step deterministic?
    deterministic = all(torch.equal(a, b) for a, b in zip(shards[0], again))
    want = [sum(g) for g in zip(*shards)]
    del ref, again, shards

    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = make_train_step(model, opt, loss_cfg, mesh)
    local = shard_batch(batch, mesh)
    counters = launch_counters()
    for d, k in counters.values():
        d[k] = 0
    torch.cuda.synchronize()
    metrics = step(local)
    torch.cuda.synchronize()
    launches = {name: d[k] for name, (d, k) in counters.items() if d[k]}
    grads = [p.grad for p in model.parameters()]
    mismatched = [i for i, (g, w) in enumerate(zip(grads, want)) if not torch.equal(g, w)]
    max_diff = max(float((g - w).abs().max()) for g, w in zip(grads, want))
    top = max(float(w.abs().max()) for w in want)
    losses = [metrics["loss"].item()] + [step(local)["loss"].item() for _ in range(DP_STEPS - 1)]
    # the collectives of one step, by the profiler's events with their shapes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        step(local)
    t_enc = -(-local[0].shape[1] // 4)  # the encoder's frames: ceil(T_in / 4)
    census = collective_census(prof, lattice_dims=(t_enc, t_enc + 1))

    times = []
    for _ in range(DP_TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(local)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    grads = [p.grad for p in model.parameters()]
    reduce_ms = []
    for _ in range(DP_TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        all_reduce_sum(grads, mesh)
        b.record()
        b.synchronize()
        reduce_ms.append(a.elapsed_time(b))
    res = {
        "rank": rank, "world": world, "backend": got_backend, "shard": list(local[0].shape),
        "launches": launches, "deterministic": deterministic,
        "n_grads": len(grads), "mismatched": len(mismatched), "max_diff": max_diff, "top": top,
        "frames": int(metrics["frames"]), "losses": losses, "census": census, "census_t": t_enc,
        "step_ms": float(np.median(times)),
        "step_ms_all": times, "allreduce_ms": float(np.median(reduce_ms)),
        "grad_mib": sum(g.numel() * g.element_size() for g in grads) / 2**20,
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
    }
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def run_workers(args_per_rank, what, timeout=DP_TIMEOUT_S):
    """Start one ``chip_smoke.py`` worker process per argument list, all
    together; a rank that exits non-zero or outlives ``timeout`` fails
    the run (every worker is killed first)."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *map(str, a)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in args_per_rank]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise Failed(f"{what}: a worker outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise Failed(f"{what}: worker {r} exited {p.returncode}:\n{log[-4000:]}")


def data_phase():
    """The host library from the checkout's sources into build/host/, and
    the streamed fbank bit-equal to the offline one."""
    from fast_rnnt_tpu_torch import csrc
    from fast_rnnt_tpu_torch.data import StreamingFbank, fbank_cpu

    t0 = time.perf_counter()
    csrc.load_library()
    build_s = time.perf_counter() - t0
    path = csrc.library_path()
    if path.parent != csrc.BUILD_DIR or csrc.BUILD_DIR != type(path)(HERE) / "build" / "host":
        raise Failed(f"data: host library at {path}")
    rng = np.random.default_rng(1)
    wav = synth_wavs(1, 10.0, 10.0, rng)[0]
    t0 = time.perf_counter()
    ref = fbank_cpu(wav)
    off_ms = (time.perf_counter() - t0) * 1e3
    piece = int(AUDIO_PIECE_S * SAMPLE_RATE)
    splits = {"0.32 s": [piece] * (-(-len(wav) // piece)),
              "ragged": list(rng.integers(1, 4000, size=len(wav)))}
    for name, sizes in splits.items():
        sf, outs, pos = StreamingFbank(), [], 0
        for n in sizes:
            if pos >= len(wav):
                break
            outs.append(sf.process(wav[pos : pos + n]))
            pos += n
        got = np.concatenate(outs)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise Failed(f"data: streamed fbank ({name} pieces) differs from the offline fbank_cpu")
    phase("data", f"host library {os.path.relpath(path, HERE)} ({'built' if build_s > 0.05 else 'loaded'} "
          f"in {build_s:.2f} s); fbank_cpu of 10 s of 16 kHz audio: {ref.shape[0]} x {ref.shape[1]} in "
          f"{off_ms:.2f} ms on the host; StreamingFbank in 0.32 s and in ragged 1-3999-sample pieces "
          f"bit-equal to it")


def dp_train_phase(dev, model_ms):
    """The dp-train cell: two ranks on the one card (gloo over CUDA
    tensors: NCCL takes one rank per device), each on 4 of the 8
    utterances at TransducerConfig() width, DP_STEPS steps; then one rank
    on NCCL as a check of that branch of initialize_distributed."""
    import tempfile

    from fast_rnnt_tpu_torch.models import TransducerConfig

    cfg = TransducerConfig()
    batch, audio_s, fbank_s = dp_batch(cfg)
    want = {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
            "wavefront_bwd": 1, "ranges": 1, "pruned_band": 1, "pruned_rows": 1, "pruned_bwd": 1}
    results = {}
    for backend, world in (("gloo", DP_WORLD), ("nccl", 1)):
        with tempfile.TemporaryDirectory() as out_dir:
            run_workers([["--dp-worker", r, world, out_dir, backend] for r in range(world)],
                        f"dp-train ({backend}, {world} ranks)")
            ranks = []
            for r in range(world):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        for x in ranks:
            tag = f"dp-train ({backend}) rank {x['rank']}"
            if x["backend"] != backend or x["launches"] != want:
                raise Failed(f"{tag}: backend {x['backend']}, launches {x['launches']}, expected {want}")
            if x["mismatched"]:
                raise Failed(f"{tag}: {x['mismatched']} of {x['n_grads']} all-reduced gradients differ "
                             f"from the sum of the shards' single-process gradients (max abs diff "
                             f"{x['max_diff']:.3e} of max {x['top']:.3e}; the single-process step "
                             f"{'is' if x['deterministic'] else 'is not'} deterministic)")
            if not all(np.isfinite(x["losses"])) or not x["losses"][-1] < x["losses"][0]:
                raise Failed(f"{tag}: losses {x['losses']}")
            census = x["census"]
            if backend == "gloo" and (census["all-reduce"] != DP_ALLREDUCES or census["lattice_moves"]
                                      or any(v for k, v in census.items()
                                             if k not in ("all-reduce", "lattice_moves"))):
                raise Failed(f"{tag}: collective census of one step {census}, expected "
                             f"{DP_ALLREDUCES} all-reduces, no other collective and no lattice move "
                             f"(lattice dims {x['census_t']}, {x['census_t'] + 1})")
        if any(x["losses"] != ranks[0]["losses"] for x in ranks):
            raise Failed(f"dp-train ({backend}): the ranks' all-reduced losses differ")
        results[backend] = ranks
    g, n = results["gloo"], results["nccl"][0]
    step_ms = max(x["step_ms"] for x in g)
    rank_ms = ", ".join(f"{x['step_ms']:.3f}" for x in g)
    phase("dp-train", f"{DP_UTTS} synthetic utterances of 6-10 s ({audio_s:.1f} s of audio; fbank_cpu "
          f"{1e3 * fbank_s:.1f} ms on the host) -> RaggedBatcher(pad_batch_to={DP_UTTS}, quantum=64): one "
          f"batch {list(batch[0].shape)}; TransducerConfig() (bf16 compute), AdamW(1e-3, weight_decay "
          f"1e-4), s_range={S_RANGE}; {DP_WORLD} ranks on the one card over gloo with CUDA tensors, "
          f"shards {g[0]['shard']}: launches per rank per step {json.dumps(g[0]['launches'])}; all "
          f"{g[0]['n_grads']} all-reduced gradients equal to the sum of the two shards' single-process "
          f"gradients bit for bit on both ranks (single-process step deterministic: "
          f"{all(x['deterministic'] for x in g)}); losses over {DP_STEPS} steps "
          f"{g[0]['losses'][0]:.3f} -> {g[0]['losses'][-1]:.3f} ({g[0]['frames']} encoder frames); "
          f"step {step_ms:.3f} ms (CUDA events, median of {DP_TIMED}, slower rank; ranks {rank_ms}) "
          f"vs model-train's single-process B={MODEL_B} T_in={MODEL_T_IN} step {model_ms:.3f} ms; "
          f"gradient all-reduce of {g[0]['grad_mib']:.1f} MiB alone {max(x['allreduce_ms'] for x in g):.3f} "
          f"ms; {audio_s / (step_ms / 1e3):.1f} audio-seconds/s; peak {max(x['peak_mib'] for x in g):.1f} "
          f"MiB per rank; collective census of one step on each gloo rank "
          f"{json.dumps({k: v for k, v in g[0]['census'].items() if v})} (expected {DP_ALLREDUCES} "
          f"all-reduces: gradients, float metrics, frame count), no lattice move (dims "
          f"{g[0]['census_t']}, {g[0]['census_t'] + 1}).  One rank on NCCL: the same checks, launches {json.dumps(n['launches'])}, "
          f"gradients equal, step {n['step_ms']:.3f} ms, all-reduce {n['allreduce_ms']:.3f} ms")
    return {"gloo": g, "nccl": n, "step_ms": step_ms}


# --- batch-sharded DTensors: the losses over a DeviceMesh ---------------------

DT_WORLD = 2
# the smoothed step's scales: chip_smoke's smoothed-train's (the defaults)
DT_STEPS = ("train", "smoothed")
# launches of each step on each rank: train, the six main-path kernels; the
# smoothed step, all eight
DT_LAUNCHES = {
    "train": {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
              "wavefront_bwd": 1, "ranges": 1},
    "smoothed": {"latbuild_fwd_parts": 1, "latbuild_bwd_parts": 1, "latbuild_fwd": 1, "latbuild_bwd": 1,
                 "wavefront_fused": 1, "wavefront_fwd": 1, "wavefront_bwd": 1, "ranges": 1},
}
# the trace hook's kernel entries (the JAX package's names) in each step
DT_HOOK_KERNELS = {
    "train": {"latbuild_fwd", "latbuild_bwd", "mi_fused", "mi_fwd", "mi_bwd", "prune_ranges"},
    "smoothed": {"latbuild_parts_fwd", "latbuild_parts_bwd", "latbuild_fwd", "latbuild_bwd", "mi_fused",
                 "mi_fwd", "mi_bwd", "prune_ranges"},
}
# collectives of one step with its loss read back: the loss's scalar
# all-reduce; the smoothed step adds the [C] unigram's, forward and gradient
DT_ALLREDUCES = {"train": 1, "smoothed": 3}


def dt_step(name):
    """bench.py's train step (``name`` "train": the value and gradient of
    0.5*simple + pruned w.r.t. (am, lm), reduction "sum") or the smoothed
    one (0.5*smoothed + pruned), on plain tensors or DTensors alike:
    returns (loss, d_am, d_lm, ranges)."""
    import torch

    from fast_rnnt_tpu_torch import rnnt_loss_simple_pruned, rnnt_loss_smoothed_pruned

    def step(lm, am, sym, bnd):
        am, lm = am.detach().requires_grad_(), lm.detach().requires_grad_()
        if name == "train":
            s, p, r = rnnt_loss_simple_pruned(lm, am, sym, 0, S_RANGE, bnd, reduction="sum")
        else:
            s, p, r = rnnt_loss_smoothed_pruned(lm, am, sym, 0, S_RANGE, boundary=bnd, reduction="sum")
        loss = 0.5 * s + p
        return (loss.detach(), *torch.autograd.grad(loss, (am, lm)), r)

    return step


# the public glue ops, which reach no kernel, on Shard(0) DTensors (s-major
# rows Shard(1)) at the headline shape; get_rnnt_logprobs_joint at the joint
# phase's cut, B=4, whose [4, 1000, 101, 500] logits are 808 MB (at B=30,
# 6.1 GB)
DT_GLUE_BJ = 4
# against the whole batch's call, more than one rank: the port's unsharded
# tolerance in tests/test_torch_partition.py (PORT_TOL), atol + rtol|x|
DT_GLUE_TOL = 1e-6


def dtensor_glue(rank, world, shard, local, log, lm, am, sym, bnd, rg):
    """The nine glue ops on this rank's shards against the same op on the
    whole batch's plain tensors: outputs Shard on their batch axis, the hook
    at the per-shard batch, no kernel launched; one rank bit-equal, more
    ranks within DT_GLUE_TOL with -inf where the whole batch's is and
    integer outputs equal.  ``rg``: the whole batch's ranges.  Returns
    {op: max abs err}."""
    import torch

    from fast_rnnt_tpu_torch import ops
    from fast_rnnt_tpu_torch.ops.kernels import partition

    px_r, py_r = ops.get_rnnt_logprobs_rows(lm, am, sym, 0, "regular", bnd)
    px, py = px_r.movedim(1, 0).contiguous(), py_r.movedim(1, 0).contiguous()
    lo = rg[:, :, 0].contiguous()
    gen = torch.Generator(device=am.device).manual_seed(4)
    s_begin = torch.randint(0, S - S_RANGE + 2, (B, T), generator=gen, device=am.device, dtype=torch.int32)
    bj = DT_GLUE_BJ
    logits = am[:bj, :, None, :] + lm[:bj, None, :, :]
    # op -> arguments: (tensor, batch axis) to shard, anything else as it is
    calls = {
        "fix_for_boundary": ((px, 0), (bnd, 0)),
        "band_mask_rows_smajor": ((py_r, 1), (lo, 0), S_RANGE),
        "band_mask_rows": ((px, 0), (rg, 0)),
        "get_rnnt_logprobs_joint": ((logits, 0), (sym[:bj], 0), 0, (bnd[:bj], 0)),
        "roll_by_shifts": ((py.transpose(1, 2).contiguous(), 0), (lo, 0)),
        "scatter_window": ((am[:, :, :S_RANGE].contiguous(), 0), (lo, 0), S + 1),
        "adjust_pruning_lower_bound": ((s_begin, 0), S_RANGE),
        "viterbi_scores": ((px, 0), (py, 0), (bnd, 0)),
        "viterbi_alignment": ((px, 0), (py, 0), (bnd, 0)),
    }
    counters = launch_counters()
    for d, key in counters.values():
        d[key] = 0
    errs = {}
    for name, args in calls.items():
        fn = getattr(ops, name)
        want = fn(*(a[0] if isinstance(a, tuple) else a for a in args))
        sharded = [shard(*a) if isinstance(a, tuple) else a for a in args]
        log.clear()
        partition._TRACE_HOOK = lambda n, b: log.append((n, int(b)))
        got = fn(*sharded)
        partition._TRACE_HOOK = None
        n = (bj if name == "get_rnnt_logprobs_joint" else B) // world
        if sorted(set(log)) != [(name, n)]:
            raise Failed(f"dtensor glue rank {rank} {name}: hook {sorted(set(log))}, expected ({name!r}, {n})")
        ax = 1 if name == "band_mask_rows_smajor" else 0
        err = 0.0
        for i, (g, w) in enumerate(zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want)))):
            what = f"dtensor glue rank {rank} {name}[{i}]"
            if str(g.placements) != f"(Shard(dim={ax}),)":
                raise Failed(f"{what}: placements {g.placements}, expected Shard({ax})")
            g, w = local(g), w.narrow(ax, rank * n, n)
            if world == 1 or not w.is_floating_point():
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise Failed(f"{what}: not equal to the whole batch's call")
                continue
            fin = torch.isfinite(w)
            d = (g[fin] - w[fin]).abs()
            if not (torch.equal(torch.isneginf(g), torch.isneginf(w)) and torch.isfinite(g[fin]).all()
                    and (d <= DT_GLUE_TOL + DT_GLUE_TOL * w[fin].abs()).all()):
                raise Failed(f"{what}: max abs err {d.max().item():.3e} or -inf elsewhere than the whole "
                             f"batch's call (tol {DT_GLUE_TOL} + {DT_GLUE_TOL}|x|)")
            err = max(err, d.max().item() if d.numel() else 0.0)
        errs[name] = err
    launched = {n: d[key] for n, (d, key) in counters.items() if d[key]}
    if launched:
        raise Failed(f"dtensor glue rank {rank}: the glue ops launched {launched}")
    return errs


def dtensor_alignment(rank, world, shard, local, log, lm, am, sym, bnd):
    """The forced-alignment path, ``get_rnnt_logprobs`` (the build kernel)
    then ``viterbi_alignment``, on this rank's Shard(0) lm, am, symbols and
    boundary, and on the whole batch's plain tensors, each twice in turns
    (host clock to a synchronise): the build launched once a path, in the
    sharded one at the per-shard batch (the hook), the outputs Shard(0),
    the shard's scores and frames equal to the whole batch's.  Returns the
    shard's scores and emission frames, the hook and the times."""
    import torch

    from fast_rnnt_tpu_torch import get_rnnt_logprobs, viterbi_alignment
    from fast_rnnt_tpu_torch.ops.kernels import partition

    def path(lm_, am_, sym_, bnd_):
        px, py = get_rnnt_logprobs(lm_, am_, sym_, 0, "regular", bnd_)
        return viterbi_alignment(px, py, bnd_)

    k = B // world
    sharded = [shard(x) for x in (lm, am, sym, bnd)]
    counters = launch_counters()
    times = {"plain": [], "dtensor": []}
    out = {}
    for _ in range(2):
        for kind, args in (("plain", (lm, am, sym, bnd)), ("dtensor", sharded)):
            for d, key in counters.values():
                d[key] = 0
            log.clear()
            if kind == "dtensor":
                partition._TRACE_HOOK = lambda n, b: log.append((n, int(b)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[kind] = path(*args)
            torch.cuda.synchronize()
            times[kind].append(1e3 * (time.perf_counter() - t0))
            partition._TRACE_HOOK = None
            launches = {n: d[key] for n, (d, key) in counters.items() if d[key]}
            if launches != {"latbuild_fwd": 1}:
                raise Failed(f"dtensor alignment rank {rank} ({kind}): launches {launches}, expected the "
                             "build once")
    hook = sorted(set(log))
    seen = {n for n, _ in hook}
    if not {"get_rnnt_logprobs", "latbuild_fwd", "viterbi_alignment"} <= seen or {b for _, b in hook} != {k}:
        raise Failed(f"dtensor alignment rank {rank}: hook {hook}, expected the build and the alignment at "
                     f"the per-shard batch {k}")
    placements = [str(x.placements) for x in out["dtensor"]]
    if placements != ["(Shard(dim=0),)"] * 3:
        raise Failed(f"dtensor alignment rank {rank}: placements {placements}")
    sl = slice(rank * k, (rank + 1) * k)
    scores, frames, ind = (local(x) for x in out["dtensor"])
    if not all(torch.equal(a, b[sl]) for a, b in zip((scores, frames, ind), out["plain"])):
        raise Failed(f"dtensor alignment rank {rank}: scores, frames or indicator other than the whole "
                     "batch's plain path's")
    return {"scores": scores.tolist(), "frames": frames.tolist(), "hook": hook, "ms": times}


def dtensor_worker(rank, world, out_dir, backend):
    """One rank of the dtensor phase (``chip_smoke.py --dtensor-worker``):
    bench.py's train step and the smoothed step at the headline shape on
    this rank's Shard(0) DTensors of a ``world``-rank DeviceMesh, beside the
    same steps on the whole batch's plain tensors in this process: launches,
    the trace hook's per-shard batches, the losses, ranges and gradients
    against the plain step's, a ``collective_census`` of each step, and
    both timed by ``benchmark_on_device``; on two ranks also am and lm
    sharded on C (Shard(2)) where gloo carries the reshard.  Writes
    rank<r>.json."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from fast_rnnt_tpu_torch import get_rnnt_logprobs_rows, get_rnnt_logprobs_smoothed_rows
    from fast_rnnt_tpu_torch import mutual_information_rows
    from fast_rnnt_tpu_torch.ops.kernels import _build, partition, ranges
    from fast_rnnt_tpu_torch.ops.pruning import _window_scores
    from fast_rnnt_tpu_torch.parallel import initialize_distributed, make_mesh
    from fast_rnnt_tpu_torch.utils import benchmark_on_device, collective_census, from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize_distributed(f"file://{os.path.join(out_dir, 'store')}", world, rank, device="cuda",
                           backend=backend)
    mesh = make_mesh("cuda")
    got_backend = torch.distributed.get_backend()
    if mesh.size() != world or got_backend != backend:
        raise Failed(f"rank {rank}: mesh of {mesh.size()} ranks on {got_backend}")
    _build.load_library()
    dev = torch.device("cuda", 0)
    am, lm, sym, bnd = from_numpy(*make_inputs(0), device=dev)
    k = B // world
    sl = slice(rank * k, (rank + 1) * k)

    def shard(x, dim=0):
        n = x.shape[dim] // world
        local = x.narrow(dim, rank * n, n).contiguous()
        return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False)

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    log = []

    def record(name, b):
        log.append((name, int(b)))

    counters = launch_counters()
    res = {"rank": rank, "world": world, "backend": got_backend, "shard": k, "steps": {}}
    ranges_of = {}
    for name in DT_STEPS:
        step = dt_step(name)
        log.clear()
        partition._TRACE_HOOK = record  # on for the two counted runs only
        want = step(lm, am, sym, bnd)  # the whole batch, plain tensors
        if log:
            raise Failed(f"dtensor rank {rank}: the hook fired on plain tensors: {sorted(set(log))}")
        args = [shard(x) for x in (lm, am, sym, bnd)]
        for d, key in counters.values():
            d[key] = 0
        torch.cuda.synchronize()
        got = step(*args)
        loss = got[0].full_tensor()
        torch.cuda.synchronize()
        partition._TRACE_HOOK = None
        launches = {n: d[key] for n, (d, key) in counters.items() if d[key]}
        if launches != DT_LAUNCHES[name]:
            raise Failed(f"dtensor ({backend}) rank {rank} {name}: launches {launches}, expected "
                         f"{DT_LAUNCHES[name]}")
        hook = sorted(set(log))
        seen = {n for n, _ in hook}
        if not DT_HOOK_KERNELS[name] <= seen or {b for _, b in hook} != {k}:
            raise Failed(f"dtensor ({backend}) rank {rank} {name}: hook {hook}, expected the kernels "
                         f"{sorted(DT_HOOK_KERNELS[name])} at the per-shard batch {k}")
        placements = [str(x.placements) for x in got]
        if placements != ["(Partial(sum),)"] + ["(Shard(dim=0),)"] * 3:
            raise Failed(f"dtensor rank {rank} {name}: placements {placements}")
        g_am, g_lm, rng = (local(x) for x in got[1:])
        out = {"launches": launches, "hook": hook, "loss": loss.item(), "want_loss": want[0].item(),
               "placements": placements}
        if world == 1:
            # the same kernels on the same tensors: the same bits
            same = [torch.equal(a, b) for a, b in zip((loss, g_am, g_lm, rng), want)]
            if not all(same):
                raise Failed(f"dtensor (one rank) {name}: (loss, d_am, d_lm, ranges) bit-equal {same}")
            out["bit_equal"] = True
        else:
            rel = abs(loss.item() - want[0].item()) / abs(want[0].item())
            if rel > 1e-4:
                raise Failed(f"dtensor rank {rank} {name}: loss {loss.item()} vs {want[0].item()} rel "
                             f"{rel:.3e} > 1e-4")
            # the shard's ranges: the repair of the kernel's raw argmax of its
            # own stage-1 occupancies (the partitioned rows ops recomputed),
            # their raw flips against the whole batch's near-ties
            rows = (get_rnnt_logprobs_rows(*args[:3], 0, "regular", args[3]) if name == "train"
                    else get_rnnt_logprobs_smoothed_rows(*args[:3], 0, boundary=args[3]))
            _, (gx, gy) = mutual_information_rows(*rows, args[3], calc_gradients=True)
            gx, gy = local(gx), local(gy)
            lo = rng[:, :, 0].contiguous()
            n_tie, tie_gap, _ = ranges_check(lo, gy, gx, S_RANGE, bnd[sl], S_RANGE, f"dtensor {name} ranges")
            full = (get_rnnt_logprobs_rows(lm, am, sym, 0, "regular", bnd) if name == "train"
                    else get_rnnt_logprobs_smoothed_rows(lm, am, sym, 0, boundary=bnd))
            _, (gx_f, gy_f) = mutual_information_rows(*full, bnd, calc_gradients=True)
            n_flip, gap = range_flips(
                ranges.window_argmax_kernel_order(gy, gx, S_RANGE),
                ranges.window_argmax_kernel_order(gy_f, gx_f, S_RANGE)[sl],
                _window_scores(gx_f[:, sl], gy_f[:, sl], S_RANGE), f"dtensor {name} raw argmax vs whole batch")
            agree = (rng == want[3][sl]).all(dim=2).all(dim=1)
            ranges_of[name] = rng
            e = worst(grad_err(g_am[agree], want[1][sl][agree], f"dtensor {name} d_am", TRAIN_GRAD_TOL),
                      grad_err(g_lm[agree], want[2][sl][agree], f"dtensor {name} d_lm", TRAIN_GRAD_TOL))
            out.update(rel=rel, agree=int(agree.sum()), grad_err=e, ties=n_tie, tie_gap=tie_gap,
                       flips=n_flip, flip_gap=gap, ranges_equal=bool(torch.equal(rng, want[3][sl])))
        # the collectives of one step, its loss read back
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            step(*args)[0].full_tensor()
            torch.cuda.synchronize()
        census = collective_census(prof, lattice_dims=(T, T + 1))
        shapes = [[list(s) for s in e.input_shapes] for e in prof.events()
                  if e.name.startswith(("gloo:", "nccl:"))]
        # (one NCCL rank: the mean of the unigram needs no all-reduce)
        if backend == "gloo" and (census["all-reduce"] != DT_ALLREDUCES[name] or census["lattice_moves"]
                                  or any(v for c, v in census.items()
                                         if c not in ("all-reduce", "lattice_moves"))):
            raise Failed(f"dtensor ({backend}) rank {rank} {name}: collective census {census} (shapes "
                         f"{shapes}), expected {DT_ALLREDUCES[name]} all-reduces, no other collective "
                         f"and no lattice move (dims {T}, {T + 1})")
        out.update(census={c: v for c, v in census.items() if v}, shapes=shapes)
        # the host cost of DTensor dispatch: the sharded step against the
        # same step on this rank's plain tensors, in this process
        plain_args = [local(x) for x in args]
        out["dtensor_ms"] = 1e3 * benchmark_on_device(step, *args)
        out["plain_ms"] = 1e3 * benchmark_on_device(step, *plain_args)
        res["steps"][name] = out
        if name == "train":
            whole_ranges = want[3]

    # the public glue ops and the sharded forced-alignment path
    res["glue"] = dtensor_glue(rank, world, shard, local, log, lm, am, sym, bnd, whole_ranges)
    res["alignment"] = dtensor_alignment(rank, world, shard, local, log, lm, am, sym, bnd)

    if world == 1:
        # the kernels of both steps by the profiler's names
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for name in DT_STEPS:
                dt_step(name)(*(shard(x) for x in (lm, am, sym, bnd)))
            torch.cuda.synchronize()
        kernels = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
        res["families"] = kernel_families(kernels)
        if not all(res["families"].values()):
            raise Failed(f"dtensor (one rank): the profiler's kernel names hold {res['families']}: "
                         f"{sorted(n[:60] for n in kernels)}")
    else:
        # am and lm sharded on C, resharded to the batch (an all-to-all) and
        # their gradients back (another), where gloo carries the all-to-all
        # on CUDA tensors
        try:
            shard(torch.ones(world, world, device=dev), 1).redistribute(mesh, [Shard(0)]).to_local()
            res["non_batch"] = {"ran": True}
        except (RuntimeError, NotImplementedError) as exc:
            res["non_batch"] = {"ran": False, "reason": f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"}
        if res["non_batch"]["ran"]:
            step = dt_step("train")
            want = step(lm, am, sym, bnd)
            got = step(shard(lm, 2), shard(am, 2), shard(sym), shard(bnd))
            placements = [str(x.placements) for x in got]
            if placements != ["(Partial(sum),)", "(Shard(dim=2),)", "(Shard(dim=2),)", "(Shard(dim=0),)"]:
                raise Failed(f"dtensor rank {rank} non-batch: placements {placements}")
            loss = got[0].full_tensor().item()
            rel = abs(loss - want[0].item()) / abs(want[0].item())
            rng = local(got[3])
            if rel > 1e-4 or not torch.equal(rng, ranges_of["train"]):
                raise Failed(f"dtensor rank {rank} non-batch: loss rel {rel:.3e}, or ranges other than the "
                             "Shard(0) step's")
            # every rank's utterances whose ranges equal the whole batch's
            agree = torch.zeros(B, device=dev)
            agree[sl] = (rng == want[3][sl]).all(dim=2).all(dim=1).float()
            torch.distributed.all_reduce(agree)
            agree = agree > 0
            c = C // world
            e = worst(*(grad_err(local(g)[agree], w[agree][:, :, rank * c:(rank + 1) * c],
                                 f"dtensor non-batch {n}", TRAIN_GRAD_TOL)
                        for g, w, n in zip(got[1:3], want[1:3], ("d_am", "d_lm"))))
            res["non_batch"].update(rel=rel, grad_err=e, placements=placements, agree=int(agree.sum()))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def dtensor_phase(align):
    """The losses on batch-sharded DTensors at the headline shape: (a) one
    NCCL rank, bit-equal to the plain step, all eight kernels launched;
    (b) two gloo ranks sharing the card (NCCL takes one rank per device),
    B=30 split 15 + 15, held to the whole batch's plain step at the train
    tolerances, the hook at 15 on every kernel entry, no lattice moved;
    (c) am and lm sharded on C where gloo carries the reshard; (d) step
    times, DTensor against plain tensors; (e) the nine glue ops, one rank
    bit-equal and two ranks equal to the whole batch's call; (f) the
    sharded forced-alignment path, its scores and frames equal to the
    alignment phase's ``align`` (scores, frames, first call ms).  Returns
    each step's launches on a gloo rank."""
    import tempfile

    import torch

    results = {}
    for backend, world in (("nccl", 1), ("gloo", DT_WORLD)):
        with tempfile.TemporaryDirectory() as out_dir:
            run_workers([["--dtensor-worker", r, world, out_dir, backend] for r in range(world)],
                        f"dtensor ({backend}, {world} ranks)", timeout=DP_TIMEOUT_S)
            ranks = []
            for r in range(world):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        if any(x["backend"] != backend for x in ranks):
            raise Failed(f"dtensor: backends {[x['backend'] for x in ranks]}, expected {backend}")
        results[backend] = ranks
    one, two = results["nccl"][0], results["gloo"]
    if any(x["steps"][n]["loss"] != two[0]["steps"][n]["loss"] for x in two for n in DT_STEPS):
        raise Failed("dtensor: the gloo ranks' losses differ")
    nb = two[0]["non_batch"]
    nb_line = (f"am and lm Shard(2) on C, resharded to the batch: loss rel {nb['rel']:.3e}, ranges equal to "
               f"the Shard(0) step's, gradients on the {nb['agree']} utterances whose ranges equal the whole "
               f"batch's {nb['grad_err'][1]:.3e} of max (tol {TRAIN_GRAD_TOL}), gradients back as "
               f"{nb['placements'][1]}" if nb["ran"] else
               f"am and lm Shard(2) on C: not run on the card, gloo does not carry the reshard's "
               f"collective on CUDA tensors ({nb['reason']}); the case stands in the CPU tests "
               "(tests/test_torch_partition.py)")
    parts = []
    for n in DT_STEPS:
        a, g = one["steps"][n], [x["steps"][n] for x in two]
        parts.append(
            f"{n}: one NCCL rank bit-equal to the plain step (loss {a['loss']:.3f}), launches "
            f"{json.dumps(a['launches'])}, census {json.dumps(a['census'])}; two gloo ranks, loss "
            f"{g[0]['loss']:.3f} vs {g[0]['want_loss']:.3f} (rel {max(x['rel'] for x in g):.3e}, tol 1e-4), "
            f"utterances whose ranges equal the whole batch's {sum(x['agree'] for x in g)} of {B} (ranges "
            f"equal on both ranks: {all(x['ranges_equal'] for x in g)}; raw flips against the whole batch "
            f"{sum(x['flips'] for x in g)}, max gap {max(x['flip_gap'] for x in g):.3e}; flips of the "
            f"kernel's order against the plain search {sum(x['ties'] for x in g)}, max gap "
            f"{max(x['tie_gap'] for x in g):.3e}; tol 1e-3), gradients on those "
            f"{max(x['grad_err'][1] for x in g):.3e} of max (tol {TRAIN_GRAD_TOL}), hook at the per-shard "
            f"batch {g[0]['hook'][0][1]} on {len(g[0]['hook'])} entries, collectives per step "
            f"{json.dumps(g[0]['census'])} (shapes {g[0]['shapes']}); step ms by benchmark_on_device, "
            f"DTensor vs plain tensors: one rank (B={B}) {a['dtensor_ms']:.4f} vs {a['plain_ms']:.4f}, "
            f"gloo ranks (B={two[0]['shard']} each, both stepping on the card) "
            + ", ".join(f"{x['dtensor_ms']:.4f} vs {x['plain_ms']:.4f}" for x in g))
    phase("dtensor", f"B={B} T={T} S={S} C={C} s_range={S_RANGE} fp32, Shard(0) DTensors on a DeviceMesh; "
          f"kernel families by profiler name on one rank {json.dumps(one['families'])}; "
          + "; ".join(parts) + f"; no collective holds a lattice (dims {T}, {T + 1}); " + nb_line)
    # the sharded alignment path against the alignment phase's plain one
    sc_a, fr_a, first_ms = align
    runs = {"one NCCL rank": [one["alignment"]], "two gloo ranks": [x["alignment"] for x in two]}
    lines = []
    for what, al in runs.items():
        sc = torch.tensor([v for x in al for v in x["scores"]], dtype=sc_a.dtype)
        fr = torch.tensor([v for x in al for v in x["frames"]], dtype=fr_a.dtype)
        equal = int((fr == fr_a).all(1).sum())
        if equal != B or not torch.equal(sc, sc_a):
            raise Failed(f"dtensor alignment ({what}): emission frames equal on {equal} of {B} utterances, "
                         f"scores max abs diff {(sc - sc_a).abs().max().item():.3e}: both must equal the "
                         "alignment phase's")
        lines.append(f"{what} (B={B // len(al)} a rank) ms, sharded vs plain in turns: " + "; ".join(
            ", ".join(f"{d:.1f} vs {p:.1f}" for d, p in zip(x["ms"]["dtensor"], x["ms"]["plain"])) for x in al))
    glue = {n: max(x["glue"][n] for x in two) for n in two[0]["glue"]}
    phase("dtensor", f"the nine glue ops on Shard(0) DTensors (s-major rows Shard(1)) at B={B} T={T} S={S} "
          f"C={C} (get_rnnt_logprobs_joint at B={DT_GLUE_BJ}), no kernel launched, outputs Shard on their "
          f"batch axis, the hook at the per-shard batch: one NCCL rank bit-equal to the plain call; two gloo "
          f"ranks against the whole batch's call, max abs err {json.dumps(glue)} (tol {DT_GLUE_TOL} + "
          f"{DT_GLUE_TOL}|x|, integer outputs equal).  Sharded forced alignment, get_rnnt_logprobs (the "
          f"build kernel per shard, hook {json.dumps(two[0]['alignment']['hook'])} on a gloo rank) -> "
          f"viterbi_alignment of the headline lattice [{B}, {S}, {T + 1}]: scores equal and emission "
          f"frames equal on {B} of {B} utterances to the alignment phase's (its first call "
          f"{first_ms:.1f} ms); " + "; ".join(lines))
    return {n: two[0]["steps"][n]["launches"] for n in DT_STEPS}


def serve_audio_phase(dev, model, counted):
    """AUDIO_STREAMS ragged synthetic waveforms served by the bench's causal
    model (bf16) through ``StreamServer(capacity=AUDIO_STREAMS)``, fed in
    0.32 s pieces through one ``StreamingFbank`` per stream as the audio
    arrives, against the same server fed each whole waveform's offline
    ``fbank_cpu`` features: tokens identical.  Times the host's fbank and
    the chunk step per tick."""
    import torch

    from fast_rnnt_tpu_torch.data import StreamingFbank, fbank_cpu
    from fast_rnnt_tpu_torch.models import StreamServer, StreamingConfig

    scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=SERVE_MAX_LEN)
    wavs = synth_wavs(AUDIO_STREAMS, 2.0, 10.0, np.random.default_rng(2))
    audio_s = sum(len(w) for w in wavs) / SAMPLE_RATE
    offline = StreamServer(model, scfg, AUDIO_STREAMS)
    for i, w in enumerate(wavs):
        offline.submit(i, fbank_cpu(w, n_mels=model.cfg.feature_dim))
    want = offline.run()

    piece = int(AUDIO_PIECE_S * SAMPLE_RATE)

    def streamed():
        server = StreamServer(model, scfg, AUDIO_STREAMS)
        fbanks = [StreamingFbank(n_mels=model.cfg.feature_dim) for _ in wavs]
        for i in range(len(wavs)):
            server.submit(i, np.zeros((0, model.cfg.feature_dim), np.float32), final=False)
        pos, out, fb_ms, step_ms = 0, {}, [], []
        while not server.idle:
            t0 = time.perf_counter()
            live = [i for i, w in enumerate(wavs) if pos < len(w)]
            for i in live:
                server.extend(i, fbanks[i].process(wavs[i][pos : pos + piece]))
                if pos + piece >= len(wavs[i]):
                    server.finish(i)
            pos += piece
            t1 = time.perf_counter()
            out.update(server.step())
            torch.cuda.synchronize()
            if live:
                fb_ms.append((t1 - t0) * 1e3)
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return out, fb_ms, step_ms

    (got, fb_ms, step_ms), _, wall_ms, _, _ = counted(streamed, "serve-audio", {})
    bad = [i for i in range(len(wavs)) if not np.array_equal(got.get(i), want[i])]
    if bad:
        raise Failed(f"serve-audio: streams {bad} served from streamed fbank differ from the same "
                     f"server on offline fbank_cpu features")
    phase("serve-audio", f"{AUDIO_STREAMS} synthetic waveforms of 2-10 s ({audio_s:.1f} s of audio) "
          f"through StreamServer(capacity={AUDIO_STREAMS}), the bench's causal model in bf16, chunk "
          f"{SERVE_CHUNK}, fed in {AUDIO_PIECE_S} s pieces through one StreamingFbank per stream: every "
          f"stream's tokens ({sum(len(v) for v in got.values())} in all) identical to the same server on "
          f"each whole waveform's offline fbank_cpu features; no kernel launches; {len(step_ms)} ticks "
          f"in {wall_ms:.1f} ms ({audio_s / (wall_ms / 1e3):.1f} audio-seconds/s); host fbank of the "
          f"streams' pieces per tick median {np.median(fb_ms):.3f} ms (max {max(fb_ms):.3f}), the "
          f"server's chunk step with its synchronise median {np.median(step_ms):.3f} ms (max "
          f"{max(step_ms):.3f})")
    return float(np.median(fb_ms)), float(np.median(step_ms))


def example_phase():
    """examples/torch_train_and_decode.py at its defaults on the card: greedy
    and beam token accuracy each at least EXAMPLE_MIN_ACC."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.join(HERE, "examples", "torch_train_and_decode.py")],
                         capture_output=True, text=True, timeout=DP_TIMEOUT_S, cwd=HERE)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise Failed(f"example: exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    last = json.loads(res.stdout.strip().splitlines()[-1])
    if min(last["greedy_accuracy"], last["beam_accuracy"]) < EXAMPLE_MIN_ACC:
        raise Failed(f"example: accuracy {last} < {EXAMPLE_MIN_ACC}")
    losses = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    phase("example", f"examples/torch_train_and_decode.py ({last['steps']} steps, {last['ranks']} rank, on "
          f"the card) in {wall:.1f} s with its start-up: {losses[0].strip()} ... {losses[-1].strip()}; "
          f"greedy token accuracy {last['greedy_accuracy']:.3f}, beam (H=4) {last['beam_accuracy']:.3f} "
          f"(each >= {EXAMPLE_MIN_ACC})")


# the kernels of the main path: the parity gate's shipped route must launch
# each of them, its plain route none
MAIN_KERNELS = ("latbuild_fwd", "latbuild_bwd", "wavefront_fused", "wavefront_fwd", "wavefront_bwd",
                "ranges")


def parity_phase(am, lm, sym, bnd):
    """``onchip_parity_gate`` at the headline shape, with each route's
    launches counted, every metric printed beside its limit, then
    ``enforce_parity``; then the gate once more with the fused kernel's
    occupancies scaled by 1.01 (swapped in here, as ``arm()`` swaps the
    recursion), which must make ``enforce_parity`` raise.  The gate picks
    each call's route by its ``impl`` argument; the launches from one of its
    calls up to the next (a loss's backward included) count for the route
    of that call."""
    from fast_rnnt_tpu_torch.ops.kernels import wavefront
    from fast_rnnt_tpu_torch.utils import parity

    counters = launch_counters()
    routes = {}
    open_seg = []  # [route, counts at its start]

    def close():
        if open_seg:
            route, before = open_seg.pop()
            got = routes.setdefault(route, dict.fromkeys(counters, 0))
            for name, (d, k) in counters.items():
                got[name] += d[k] - before[name]

    def segment(fn):
        def run(*args, **kw):
            close()
            open_seg.append((kw.get("impl") or "shipped", {name: d[k] for name, (d, k) in counters.items()}))
            return fn(*args, **kw)
        return run

    names = ("rnnt_loss_simple_pruned", "get_rnnt_logprobs_rows", "mutual_information_rows",
             "get_rnnt_logprobs", "mutual_information_recursion")
    t0 = time.perf_counter()
    with patched(parity, **{n: segment(getattr(parity, n)) for n in names}):
        metrics = parity.onchip_parity_gate(am, lm, sym, bnd, S_RANGE)
        close()
    gate_s = time.perf_counter() - t0
    shipped, plain = routes["shipped"], routes["plain"]
    if set(routes) != {"shipped", "plain"}:
        raise Failed(f"parity: the gate's calls took the routes {sorted(routes)}")
    if any(shipped[k] == 0 for k in MAIN_KERNELS) or any(plain.values()):
        raise Failed(f"parity: launches on the shipped route {shipped}, on the plain route {plain}: "
                     f"the shipped route must launch each of {MAIN_KERNELS}, the plain route none")
    limits = {**parity.TOLERANCES, **parity.MINIMUMS}
    shown = "; ".join(f"{k} {v if isinstance(v, int) else format(v, '.3e')}" + (f" (limit {'>=' if k in parity.MINIMUMS else '<='} "
                                        f"{limits[k]})" if k in limits else "")
                      for k, v in metrics.items())
    parity.enforce_parity(metrics)  # FloatingPointError fails the run

    fused = wavefront.fused_rows

    def scaled(*args, **kw):
        n = wavefront.LAUNCHES["fused"]
        scores, gx, gy = fused(*args, **kw)
        if wavefront.LAUNCHES["fused"] > n:  # the kernel's occupancies only
            gx, gy = 1.01 * gx, 1.01 * gy
        return scores, gx, gy

    with patched(wavefront, fused_rows=scaled):
        bad = parity.onchip_parity_gate(am, lm, sym, bnd, S_RANGE)
    try:
        parity.enforce_parity(bad)
    except FloatingPointError:
        failed = sorted(k for k, v in bad.items() if k in limits and not (
            v >= limits[k] if k in parity.MINIMUMS else v <= limits[k]))
    else:
        raise Failed(f"parity: the gate passed with the fused kernel's occupancies scaled by 1.01: {bad}")
    phase("parity", f"onchip_parity_gate at B={B} T={T} S={S} C={C} s_range={S_RANGE} (seed 0) in "
          f"{gate_s:.1f} s: {shown}; launches on the shipped route {json.dumps(shipped)}, on the plain "
          f"route none; enforce_parity passed.  With the fused kernel's occupancies scaled by 1.01 it "
          f"raised on {failed} (" + ", ".join(f"{k} {bad[k]:.3e}" for k in failed) + ")")
    return metrics


LEVELS = ("highest", "high", "default")


def bounded_err(got, want, extra, name, atol=1e-4, rtol=1e-5):
    """finite_err's check with ``extra`` (broadcast to ``want``) added to each
    element's bound: max |got - want| over the finite entries."""
    import torch

    got, want = got.double(), want.double()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)) or torch.isnan(got).any():
        raise Failed(f"{name}: -inf pattern differs or NaN")
    fin = torch.isfinite(want)
    d = (got - want).abs()
    lim = atol + rtol * want.abs() + torch.as_tensor(extra, dtype=torch.float64, device=want.device)
    if (d[fin] > lim.expand_as(d)[fin]).any():
        raise Failed(f"{name}: max abs err {d[fin].max().item():.3e} over 1e-4 + 1e-5|x| + the rounding "
                     "flips' bound")
    return d[fin].max().item() if fin.any() else 0.0


def flip_bound(lm, am, level):
    """The build's rounded exp operands on the two routes: the kernel's own
    (``latbuild.round_exps``, its device code) against the plain emulation's
    (``torch.exp``, then the rounding).  Returns (how many differ, per cell
    (S+1, B, T) the bound on |log D_kernel - log D_plain| that follows:
    log(1 + dD / D) with dD the products' change from the differing
    operands, both operands taken at their larger value)."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import latbuild
    from fast_rnnt_tpu_torch.ops.lattice import _PREC_CODE, _round_operand

    ops = []
    for x in (lm, am):
        m = x.amax(2)
        ops.append((latbuild.round_exps(x, m, _PREC_CODE[level]),
                    _round_operand(torch.exp(x - m[..., None]), level)))
    n = int(sum((k != q).sum() for k, q in ops))
    if n == 0:
        return 0, 0.0
    (kl, pl), (ka, pa) = ops
    dD = (torch.einsum("bsc,btc->sbt", (kl - pl).abs(), torch.maximum(ka, pa))
          + torch.einsum("bsc,btc->sbt", torch.maximum(kl, pl), (ka - pa).abs()))
    return n, torch.log1p(dD / torch.einsum("bsc,btc->sbt", pl, pa))


def precision_phase(am, lm, sym, bnd, counted):
    """``set_matmul_precision`` at the headline shape, for each level: the
    build kernels (forward with residuals, backward; the smoothed build's
    forward and backward) against their plain emulation at that level (the
    lattices to 1e-4 + 1e-5|x| plus the bound that the differing rounded
    operands allow, printed beside their count; the gradients to GRAD_TOL of
    max, the backward on the forward's residual D, as the kernels take it),
    max |dpx| and |dpy| and the train step's loss against "highest", and
    the kernels' times beside the forward builds' library call at the same
    level (the einsum in float32, with TF32 allowed for "high", on bf16
    operands for "default"); bf16 lm and am bit-equal across the levels.
    Then ``bench.py``'s train step with ``impl="plain"`` (no kernel) and
    ``impl="cuda"`` (the six once each).  Returns ({kernel: {level: ms}},
    {forward build: {level: library ms}})."""
    import torch

    from fast_rnnt_tpu_torch import rnnt_loss_simple_pruned, set_matmul_precision
    from fast_rnnt_tpu_torch.ops.kernels import latbuild

    te = bnd[:, 3].contiguous()
    gen = torch.Generator(device=am.device).manual_seed(3)
    dpx = torch.randn((S, B, T + 1), device=am.device, generator=gen)
    dpy = torch.randn((S + 1, B, T), device=am.device, generator=gen)
    dnd = torch.randn((S + 1, B, T), device=am.device, generator=gen)
    lmp = torch.exp(lm - lm.amax(2, keepdim=True))
    uni = (lmp / lmp.sum(2, keepdim=True)).mean((0, 1)) + float(np.finfo(np.float32).tiny)
    lm16, am16 = lm.bfloat16(), am.bfloat16()
    # the forward builds' GEMM operands, for the library yardsticks
    amp = torch.exp(am - am.amax(2, keepdim=True))
    lhs = {"latbuild_fwd": lmp, "latbuild_fwd_parts": torch.cat([lmp, uni.expand(B, 1, C)], 1)}
    del lmp

    def library_ms(level, a):
        """The einsum of the build's product at ``level``: float32 operands
        with TF32 off ("highest") or allowed ("high"), bf16 operands
        ("default")."""
        if level == "default":
            a16, b16 = a.bfloat16(), amp.bfloat16()
            return kernel_ms(lambda: torch.einsum("bsc,btc->sbt", a16, b16))
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = level == "high"
        try:
            return kernel_ms(lambda: torch.einsum("bsc,btc->sbt", a, amp))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def bench_step(impl=None):
        a, l = am.clone().requires_grad_(), lm.clone().requires_grad_()
        s_, p_, r_ = rnnt_loss_simple_pruned(l, a, sym, 0, S_RANGE, bnd, reduction="none", impl=impl)
        loss = 0.5 * s_.sum() + p_.sum()
        return loss.detach(), torch.autograd.grad(loss, (a, l)), r_

    times = {k: {} for k in ("latbuild_fwd", "latbuild_bwd", "latbuild_fwd_parts", "latbuild_bwd_parts")}
    library = {k: {} for k in lhs}
    lines, ref = [], {}
    try:
        for level in LEVELS:
            set_matmul_precision(level)
            n_flip, fb = flip_bound(lm, am, level)
            fb_px = fb if isinstance(fb, float) else torch.cat([fb[:S], torch.zeros_like(fb[:S, :, :1])], 2)
            px_k, py_k, _, res = latbuild.build_fwd(lm, am, sym, te, 0, False, save=True)
            px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, 0, "regular", bnd)
            e_fwd = max(bounded_err(px_k, px_p, fb_px, f"{level} build px"),
                        bounded_err(py_k, py_p, fb, f"{level} build py"))
            g_k = latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy)[:2]
            g_p = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, 0, False, d=res[0])[:2]
            e_bwd = worst(*(grad_err(a, b, f"{level} build bwd {n}") for a, b, n in zip(g_k, g_p, ("d_lm", "d_am"))))
            *o_k, res_s = latbuild.build_fwd(lm, am, sym, te, 0, False, uni, save=True)
            o_p = latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, 0, False)
            e_pf = max(bounded_err(a, b, x, f"{level} parts {n}") for a, b, x, n in zip(
                o_k, o_p, (fb_px, fb, fb), ("px", "py", "normd")))
            del o_k, o_p
            gs_k, gs_p, _ = smoothed_bwd_pair(lm, am, sym, te, 0, False, res_s, dpx, dpy, uni, dnd,
                                              f"{level} parts bwd (seed 3)")
            e_pb = worst(*(grad_err(a, b, f"{level} parts bwd {n} (seed 3)")
                           for a, b, n in zip(gs_k, gs_p, ("d_lm", "d_am", "d_uni"))))
            # d_uni against the earlier contract (D only: rd in torch's order
            # over a recomputed denominator), reported, not held
            old = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, 0, False, uni, dnd, res_s[0])[2]
            e_old = (gs_k[2] - old).abs().max().item() / old.abs().max().item()
            e_new = (gs_k[2] - gs_p[2]).abs().max().item() / gs_p[2].abs().max().item()
            del g_k, g_p, gs_k, gs_p, old
            loss, _, _ = bench_step()
            if level == "highest":
                ref = dict(px=px_k, py=py_k, loss=loss)
            d_px = (px_k - ref["px"]).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
            d_py = (py_k - ref["py"]).abs().max().item()
            d_loss = rel_err(loss, ref["loss"])
            del px_k, py_k, px_p, py_p
            # bf16 lm and am ignore the level: the same bits at every one
            b16 = (*latbuild.lattice_rows(lm16, am16, sym, 0, "regular", bnd),
                   *latbuild.build_fwd(lm16, am16, sym, te, 0, False, uni)[:3])
            if level == "highest":
                ref["bf16"] = b16
            elif not all(torch.equal(a, b) for a, b in zip(b16, ref["bf16"])):
                raise Failed(f"precision: bf16 lm and am give other bits at {level!r} than at 'highest'")
            times["latbuild_fwd"][level] = kernel_ms(lambda: latbuild.build_fwd(lm, am, sym, te, 0, False))
            times["latbuild_bwd"][level] = kernel_ms(
                lambda: latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy))
            times["latbuild_fwd_parts"][level] = kernel_ms(
                lambda: latbuild.build_fwd(lm, am, sym, te, 0, False, uni))
            times["latbuild_bwd_parts"][level] = kernel_ms(
                lambda: latbuild.build_bwd(lm, am, sym, te, 0, False, res_s, dpx, dpy, uni, dnd))
            del res, res_s
            for k, a in lhs.items():
                library[k][level] = library_ms(level, a)
            flips = ("" if level == "highest" else
                     f"rounded operands differing between the routes {n_flip} of {B * (T + S + 1) * C}, "
                     f"their bound on |d log D| {0.0 if isinstance(fb, float) else fb.max().item():.3e} "
                     f"(added to the lattice tolerance); ")
            lines.append(
                f"{level}: {flips}vs plain emulation build fwd {e_fwd:.3e} (tol 1e-4 + 1e-5|x|) bwd "
                f"{e_bwd[1]:.3e} of max (tol {GRAD_TOL}), parts fwd {e_pf:.3e} bwd {e_pb[1]:.3e} of max (d_uni "
                f"{e_new:.3e}, rd bit for bit; on D only {e_old:.3e}); vs "
                f"highest max |dpx| {d_px:.3e} |dpy| {d_py:.3e}, train-step loss rel {d_loss:.3e}; kernel ms "
                + ", ".join(f"{k} {v[level]:.4f}" for k, v in times.items()) + "; library (einsum) ms "
                + ", ".join(f"{k} {v[level]:.4f}" for k, v in library.items()))
    finally:
        set_matmul_precision("highest")
    del ref, lm16, am16, dpx, dpy, dnd, amp, lhs

    six = {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
           "wavefront_bwd": 1, "ranges": 1}
    (loss_p, _, r_p), _, plain_ms, _, _ = counted(lambda: bench_step("plain"), "precision (impl plain)", {})
    (loss_c, _, r_c), got_c, _, _, _ = counted(lambda: bench_step("cuda"), "precision (impl cuda)", six)
    phase("precision", f"set_matmul_precision at B={B} T={T} S={S} C={C} (seed 0): " + "; ".join(lines)
          + f"; bf16 lm and am: px, py (and the smoothed build's) bit-equal across the three levels; "
          f"bench.py's train step with impl=\"plain\": no launch (first call {plain_ms:.1f} ms), with "
          f"impl=\"cuda\": {json.dumps(got_c)}; their losses rel {rel_err(loss_p, loss_c):.3e}, ranges "
          f"{'equal' if torch.equal(r_p, r_c) else 'differing at near-ties'}")
    return times, library


def headline_kernels(am, lm, sym, bnd):
    """Each kernel against its plain version at the main path's shapes, with
    CUDA-event times of both.  The tensors made here are freed on return, so
    that the main path's peak memory is its own."""
    import torch

    from fast_rnnt_tpu_torch.ops.kernels import latbuild, ranges, wavefront

    dev = am.device
    report = {}

    px_k, py_k = latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)
    px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, 0, "regular", bnd)
    e = worst(finite_err(px_k, px_p, "headline build px", 1e-4, 1e-5),
              finite_err(py_k, py_p, "headline build py", 1e-4, 1e-5))
    te = bnd[:, 3].contiguous()
    # the GEMM operands, for the library yardsticks (one cuBLAS call each)
    lmp = torch.exp(lm - lm.amax(2, keepdim=True))
    amp = torch.exp(am - am.amax(2, keepdim=True))
    report["latbuild_fwd"] = dict(
        err=e[0], rel=e[1], tol="1e-4 + 1e-5|x|",
        ms=kernel_ms(lambda: latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_plain(lm, am, sym, 0, "regular", bnd)),
        library_ms=kernel_ms(lambda: torch.einsum("bsc,btc->sbt", lmp, amp)),
        # the training forward, which also writes the residuals D and amax:
        # the residual's cost is the difference, a recompute's at least the
        # forward kernel's own time
        residuals_ms=kernel_ms(lambda: latbuild.build_fwd(lm, am, sym, te, 0, False, save=True)),
    )

    # build backward on random cotangents at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(2)
    dpx = torch.randn((S, B, T + 1), device=dev, generator=gen)
    dpy = torch.randn((S + 1, B, T), device=dev, generator=gen)
    dnd = torch.randn((S + 1, B, T), device=dev, generator=gen)
    _, _, _, res = latbuild.build_fwd(lm, am, sym, te, 0, False, save=True)
    g_k = latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy)[:2]
    g_p = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, 0, False)[:2]
    e = worst(*(grad_err(a, b, f"headline build bwd {n}") for a, b, n in zip(g_k, g_p, ("d_lm", "d_am"))))
    w = torch.randn((B, S + 1, T), device=dev, generator=gen)
    report["latbuild_bwd"] = dict(
        err=e[0], rel=e[1], tol=f"{GRAD_TOL} of max |plain|",
        ms=kernel_ms(lambda: latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, 0, False)),
        library_ms=kernel_ms(lambda: (torch.bmm(w.transpose(1, 2), lmp), torch.bmm(w, amp))),
    )
    del g_k, g_p, res

    # bf16 lm and am (the JAX package's bf16 mode): each build kernel against
    # its plain version (the backward: the plain build's autograd in bf16),
    # timed beside it and beside the same library calls on bf16 operands
    lm16, am16 = lm.bfloat16(), am.bfloat16()
    e16 = worst(*(finite_err(a, b, f"headline bf16 build {n}", 1e-4, 1e-5) for a, b, n in zip(
        latbuild.lattice_rows(lm16, am16, sym, 0, "regular", bnd),
        latbuild.lattice_rows_plain(lm16, am16, sym, 0, "regular", bnd), ("px", "py"))))
    lmp16, amp16, w16 = lmp.bfloat16(), amp.bfloat16(), w.bfloat16()
    report["latbuild_fwd"]["bf16"] = dict(
        err=e16[0], tol="1e-4 + 1e-5|x|",
        ms=kernel_ms(lambda: latbuild.lattice_rows(lm16, am16, sym, 0, "regular", bnd)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_plain(lm16, am16, sym, 0, "regular", bnd)),
        library_ms=kernel_ms(lambda: torch.einsum("bsc,btc->sbt", lmp16, amp16)),
    )
    _, _, _, res16 = latbuild.build_fwd(lm16, am16, sym, te, 0, False, save=True)
    e16 = bf16_contract_err(latbuild.build_bwd(lm16, am16, sym, te, 0, False, res16, dpx, dpy),
                            latbuild.lattice_rows_bwd_plain(lm16, am16, sym, te, dpx, dpy, 0, False),
                            "headline bf16 build bwd")
    report["latbuild_bwd"]["bf16"] = dict(
        err=e16[0], tol=f"{BF16_CONTRACT_TOL} of max |plain| (d_am + one bf16 step), measured "
                        f"{e16[1]:.3e}",
        ms=kernel_ms(lambda: latbuild.build_bwd(lm16, am16, sym, te, 0, False, res16, dpx, dpy)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_bwd_plain(lm16, am16, sym, te, dpx, dpy, 0, False)),
        library_ms=kernel_ms(lambda: (torch.bmm(w16.transpose(1, 2), lmp16), torch.bmm(w16, amp16))),
    )
    del res16, lm16, am16, lmp16, amp16, w16

    # the smoothed build, forward and backward, with the unigram LM that
    # lattice_rows_smoothed makes
    uni = (lmp / lmp.sum(2, keepdim=True)).mean((0, 1)) + float(np.finfo(np.float32).tiny)
    *o_k, res = latbuild.build_fwd(lm, am, sym, te, 0, False, uni, save=True)
    o_p = latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, 0, False)
    e = worst(*(finite_err(a, b, f"headline parts {n}", 1e-4, 1e-5)
                for a, b, n in zip(o_k, o_p, ("px", "py", "normd"))))
    lmp_x = torch.cat([lmp, uni.expand(B, 1, C)], 1)
    report["latbuild_fwd_parts"] = dict(
        err=e[0], rel=e[1], tol="1e-4 + 1e-5|x|",
        ms=kernel_ms(lambda: latbuild.build_fwd(lm, am, sym, te, 0, False, uni)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, 0, False)),
        library_ms=kernel_ms(lambda: torch.einsum("bsc,btc->sbt", lmp_x, amp)),
    )
    del o_k, o_p
    # the plain backward on the forward's residuals D and duni, d_uni's
    # weight rd bit for bit (``smoothed_bwd_pair``)
    g_k, g_p, _ = smoothed_bwd_pair(lm, am, sym, te, 0, False, res, dpx, dpy, uni, dnd,
                                    "headline parts bwd (seed 2)")
    e = worst(*(grad_err(a, b, f"headline parts bwd {n} (seed 2)")
                for a, b, n in zip(g_k, g_p, ("d_lm", "d_am", "d_uni"))))
    w = torch.randn((B, S + 2, T), device=dev, generator=gen)
    report["latbuild_bwd_parts"] = dict(
        err=e[0], rel=e[1], tol=f"{GRAD_TOL} of max |plain|, rd bit for bit",
        ms=kernel_ms(lambda: latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy, uni, dnd)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_bwd_plain(
            lm, am, sym, te, dpx, dpy, 0, False, uni, dnd, res[0], duni=res[2])),
        library_ms=kernel_ms(lambda: (torch.bmm(w.transpose(1, 2), lmp_x), torch.bmm(w, amp))),
    )
    del g_k, g_p, res

    # the smoothed build on bf16 lm and am (the Pallas smoothed build's
    # rounding), against its plain versions and beside the library calls on
    # bf16 operands
    lm16, am16 = lm.bfloat16(), am.bfloat16()
    *o_k, res16 = latbuild.build_fwd(lm16, am16, sym, te, 0, False, uni, save=True)
    e16 = worst(*(finite_err(a, b, f"headline bf16 parts {n}", 1e-4, 1e-5) for a, b, n in zip(
        o_k, latbuild.lattice_rows_parts_plain(lm16, am16, sym, te, uni, 0, False), ("px", "py", "normd"))))
    del o_k
    lmp_x16, amp16, w16 = lmp_x.bfloat16(), amp.bfloat16(), w.bfloat16()
    report["latbuild_fwd_parts"]["bf16"] = dict(
        err=e16[0], tol="1e-4 + 1e-5|x|",
        ms=kernel_ms(lambda: latbuild.build_fwd(lm16, am16, sym, te, 0, False, uni)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_parts_plain(lm16, am16, sym, te, uni, 0, False)),
        library_ms=kernel_ms(lambda: torch.einsum("bsc,btc->sbt", lmp_x16, amp16)),
    )
    g_k, g_p, _ = smoothed_bwd_pair(lm16, am16, sym, te, 0, False, res16, dpx, dpy, uni, dnd,
                                    "headline bf16 parts bwd (seed 2)")
    e16 = worst(bf16_contract_err(g_k[:2], g_p[:2], "headline bf16 parts bwd (seed 2)"),
                grad_err(g_k[2], g_p[2], "headline bf16 parts bwd d_uni (seed 2)", BF16_CONTRACT_TOL))
    del g_k, g_p
    report["latbuild_bwd_parts"]["bf16"] = dict(
        err=e16[0], tol=f"{BF16_CONTRACT_TOL} of max |plain| (d_am + one bf16 step), rd bit for bit, "
                        f"measured {e16[1]:.3e}",
        ms=kernel_ms(lambda: latbuild.build_bwd(lm16, am16, sym, te, 0, False, res16, dpx, dpy, uni, dnd)),
        plain_ms=kernel_ms(lambda: latbuild.lattice_rows_bwd_plain(
            lm16, am16, sym, te, dpx, dpy, 0, False, uni, dnd, res16[0], duni=res16[2])),
        library_ms=kernel_ms(lambda: (torch.bmm(w16.transpose(1, 2), lmp_x16), torch.bmm(w16, amp16))),
    )
    del res16, lm16, am16, lmp_x16, amp16, w16, w, dpx, dpy, dnd

    # the sweep pair (stage 2) against its plain versions: p in every cell,
    # the backward seeded with ones (the occupancies the ranges and stage 1
    # use) and with random seeds
    p_k, sc_k = wavefront.forward_rows(px_k, py_k, bnd)
    p_p, sc_p = wavefront.forward_rows_plain(px_k, py_k, bnd)
    e = worst(finite_err(p_k, p_p, "headline fwd p", 1e-4, 1e-5),
              finite_err(sc_k, sc_p, "headline fwd scores", 1e-4, 1e-5))
    del p_p
    report["wavefront_fwd"] = dict(
        err=e[0], rel=e[1], tol="1e-4 + 1e-5|x| in every cell of p",
        ms=kernel_ms(lambda: wavefront.forward_rows(px_k, py_k, bnd)),
        plain_ms=kernel_ms(lambda: wavefront.forward_rows_plain(px_k, py_k, bnd), inner=1),
    )
    ones = torch.ones(B, device=dev)
    ag = torch.rand(B, device=dev, generator=gen) * 4 - 2  # seeds in [-2, 2)
    gx_k, gy_k = wavefront.backward_rows(px_k, py_k, p_k, bnd, ones)
    gx_p, gy_p = wavefront.backward_rows_plain(px_k, py_k, p_k, bnd, ones)
    e = worst(finite_err(gx_k, gx_p, "headline bwd px_grad", 1e-5, 1e-4),
              finite_err(gy_k, gy_p, "headline bwd py_grad", 1e-5, 1e-4),
              *(finite_err(a, b, f"headline bwd {n} (random seeds)", 1e-5, 1e-4) for a, b, n in zip(
                  wavefront.backward_rows(px_k, py_k, p_k, bnd, ag),
                  wavefront.backward_rows_plain(px_k, py_k, p_k, bnd, ag), ("px_grad", "py_grad"))))
    report["wavefront_bwd"] = dict(
        err=e[0], rel=e[1], tol="1e-5 + 1e-4|x|, seeds 1 and random",
        ms=kernel_ms(lambda: wavefront.backward_rows(px_k, py_k, p_k, bnd, ones)),
        plain_ms=kernel_ms(lambda: wavefront.backward_rows_plain(px_k, py_k, p_k, bnd, ones), inner=1),
    )

    # the fused kernel: against its plain version, twice for its
    # determinism, and bit for bit against the sweep pair (its own phases).
    # The plain version runs its own forward: its p differs from the
    # kernel's by up to ~5e-3 at |p| ~ 4e3 (the fwd check above), and an
    # occupancy is the exp of a difference of three p values, so the
    # occupancies are held to the JAX package's fp32 occupancy bound, 1e-2
    # relative (fast_rnnt_tpu/ops/recursion.py:867)
    sc_f, gx_f, gy_f = wavefront.fused_rows(px_k, py_k, bnd)
    sc_fp, gx_fp, gy_fp = wavefront.fused_rows_plain(px_k, py_k, bnd)
    e = worst(finite_err(sc_f, sc_fp, "headline fused scores", 1e-4, 1e-5),
              finite_err(gx_f, gx_fp, "headline fused px_grad", 1e-5, 1e-2),
              finite_err(gy_f, gy_fp, "headline fused py_grad", 1e-5, 1e-2))
    del sc_fp, gx_fp, gy_fp
    if not all(torch.equal(a, b) for a, b in zip((sc_f, gx_f, gy_f), wavefront.fused_rows(px_k, py_k, bnd))):
        raise Failed("headline fused: a second run gives other bits")
    same_bits((sc_k, gx_k, gy_k), (sc_f, gx_f, gy_f), "headline sweep pair vs fused")
    del sc_f, gx_f, gy_f

    # under the main path's own stage-2 band: the ranges of these
    # occupancies, as the main path computes them
    lo = ranges.window_starts(gy_k, gx_k, S_RANGE, bnd, S_RANGE)
    bd = (lo, S_RANGE)
    pb, scb = wavefront.forward_rows(px_k, py_k, bnd, *bd)
    pb_p, scb_p = wavefront.forward_rows_plain(px_k, py_k, bnd, *bd)
    e_band = worst(finite_err(pb, pb_p, "headline banded fwd p", 1e-4, 1e-5),
                   finite_err(scb, scb_p, "headline banded fwd scores", 1e-4, 1e-5),
                   *(finite_err(a, b, f"headline banded bwd {n}", 1e-5, 1e-4) for a, b, n in zip(
                       wavefront.backward_rows(px_k, py_k, pb, bnd, ag, *bd),
                       wavefront.backward_rows_plain(px_k, py_k, pb, bnd, ag, *bd), ("px_grad", "py_grad"))))
    del pb_p, scb_p
    band_ms = (kernel_ms(lambda: wavefront.forward_rows(px_k, py_k, bnd, *bd)),
               kernel_ms(lambda: wavefront.backward_rows(px_k, py_k, pb, bnd, ones, *bd)))
    del pb

    # the pair seeded with ones against the fused kernel bit for bit, in
    # every storage dtype, unbanded and banded
    n_bits = 0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        x, y = px_k.to(dt), py_k.to(dt)
        for lb in ((), bd):
            pq, sq = wavefront.forward_rows(x, y, bnd, *lb)
            same_bits((sq, *wavefront.backward_rows(x, y, pq, bnd, ones, *lb)),
                      wavefront.fused_rows(x, y, bnd, *lb), f"headline sweep pair vs fused ({dt}, band {bool(lb)})")
            n_bits += 1
    del pq, sq, x, y

    # bf16 storage (the recipe's stage 2 runs in it): the sweep pair
    # against its plain versions as the float32 one is held, the fused
    # kernel against its plain version, and the times
    px16, py16 = px_k.bfloat16(), py_k.bfloat16()
    step16 = STORAGE_STEP["bfloat16"]
    p16_p, sc16_p = wavefront.forward_rows_plain(px16, py16, bnd)
    p16, sc16 = wavefront.forward_rows(px16, py16, bnd)
    e16 = {"sweep": max(
        finite_err(p16, p16_p, "headline bf16 sweep fwd p", 1e-4, 1e-5)[0],
        finite_err(sc16, sc16_p, "headline bf16 sweep fwd scores", 1e-4, 1e-5)[0],
        *(finite_err(a, b, f"headline bf16 sweep bwd {n}", 1e-5, 1e-4 + step16)[0]
          for a, b, n in zip(wavefront.backward_rows(px16, py16, p16, bnd, ones),
                             wavefront.backward_rows_plain(px16, py16, p16, bnd, ones),
                             ("px_grad", "py_grad"))))}
    del p16_p, sc16_p, p16, sc16
    o_k = wavefront.fused_rows(px16, py16, bnd)
    o_p = wavefront.fused_rows_plain(px16, py16, bnd)
    e16["fused"] = max(finite_err(o_k[0], o_p[0], "headline bf16 fused scores", 1e-4, 1e-5)[0],
                       *(finite_err(a, b, f"headline bf16 fused {n}", 1e-5, 1e-2 + step16)[0]
                         for a, b, n in zip(o_k[1:], o_p[1:], ("px_grad", "py_grad"))))
    del o_k, o_p
    bf16_ms = (kernel_ms(lambda: wavefront.backward_rows(
                   px16, py16, wavefront.forward_rows(px16, py16, bnd)[0], bnd, ones)),
               kernel_ms(lambda: wavefront.fused_rows(px16, py16, bnd)))
    del px16, py16
    fused_ab = in_turns(lambda: wavefront.fused_rows(px_k, py_k, bnd),
                        lambda: wavefront.backward_rows(px_k, py_k, wavefront.forward_rows(px_k, py_k, bnd)[0],
                                                        bnd, ones))

    def fmt(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    report["wavefront_fwd"]["note"] = f"(under the main path's stage-2 band K={S_RANGE}: {band_ms[0]:.4f} ms)"
    report["wavefront_bwd"]["note"] = (
        f"(under the main path's stage-2 band K={S_RANGE}: {band_ms[1]:.4f} ms; banded sweep pair vs plain "
        f"max abs err {e_band[0]:.3e}, random seeds in the backward; sweep pair seeded with ones == fused bit "
        f"for bit in {n_bits} runs, f32/bf16/f16, full and banded)")
    report["wavefront_fused"] = dict(
        err=e[0], rel=e[1], tol="1e-4 + 1e-5|x| scores, 1e-5 + 1e-2|x| occupancies; deterministic",
        ms=(fused_ab[0] + fused_ab[3]) / 2,
        plain_ms=kernel_ms(lambda: wavefront.fused_rows_plain(px_k, py_k, bnd), inner=1),
        note=(f"(in turns fused, sweep pair, sweep pair, fused {fmt(fused_ab)} ms; bf16 storage: sweep pair "
              f"{bf16_ms[0]:.4f} ms, fused {bf16_ms[1]:.4f} ms; max abs err vs plain: sweep pair "
              f"{e16['sweep']:.3e} (tol 1e-4 + 1e-5|x| p, 1e-5 + (1e-4 + 2^-7)|x| occupancies), fused "
              f"{e16['fused']:.3e} (1e-5 + (1e-2 + 2^-7)|x|))"),
    )
    # occupancy conservation: the occupancies of one utterance sum to its
    # path length.  fp32 occupancies of a long lattice carry ~1e-3 of
    # round-off in that sum, for the plain version as much as the kernel, so
    # the bound is the JAX package's own fp32 round-trip bound, 1e-2
    # (fast_rnnt_tpu/ops/recursion.py:867)
    expect = (bnd[:, 2] - bnd[:, 0] + bnd[:, 3] - bnd[:, 1]).double()

    def conservation(gx, gy):
        tot = gx.double().sum((0, 2)) + gy.double().sum((0, 2))
        return ((tot - expect).abs() / expect).max().item()

    cons = (conservation(gx_k, gy_k), conservation(gx_p, gy_p))
    if cons[0] > 1e-2:
        raise Failed(f"occupancy conservation off by {cons[0]:.3e} (rel)")

    n_flip, gap, _ = ranges_check(lo, gy_k, gx_k, S_RANGE, bnd, S_RANGE, "headline ranges")
    # bf16 occupancies (the bf16 steps' stage 1), read as they are stored
    gx16, gy16 = gx_k.bfloat16(), gy_k.bfloat16()
    n16, gap16, _ = ranges_check(ranges.window_starts(gy16, gx16, S_RANGE, bnd, S_RANGE), gy16, gx16,
                                 S_RANGE, bnd, S_RANGE, "headline ranges (bf16)")
    report["ranges"] = dict(
        err=max(gap, gap16), rel=0.0,
        tol="the repair of its own raw argmax exactly; window-score gap <= 1e-3 at each raw flip against "
            "the plain search",
        ms=kernel_ms(lambda: ranges.window_starts(gy_k, gx_k, S_RANGE, bnd, S_RANGE)),
        plain_ms=kernel_ms(lambda: ranges.window_starts_plain(gy_k, gx_k, S_RANGE, bnd, S_RANGE)),
        note=(f"(L2 flushed before each call {cold_ms(lambda: ranges.window_starts(gy_k, gx_k, S_RANGE, bnd, S_RANGE)):.4f}"
              f" ms; bf16 occupancies {kernel_ms(lambda: ranges.window_starts(gy16, gx16, S_RANGE, bnd, S_RANGE)):.4f}"
              f" ms, {n16} raw flips against the plain search (gap <= {gap16:.2e}))"),
    )
    del gx16, gy16
    return report, n_flip, cons


def main():
    import torch

    # --- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)

    sys.path.insert(0, HERE)
    from fast_rnnt_tpu_torch import (
        do_rnnt_pruning,
        get_rnnt_prune_ranges,
        rnnt_loss,
        rnnt_loss_pruned,
        rnnt_loss_pruned_simple,
        rnnt_loss_simple,
        rnnt_loss_simple_pruned,
        rnnt_loss_smoothed_pruned,
    )
    from fast_rnnt_tpu_torch.ops.kernels import _build, latbuild, ranges, wavefront
    from fast_rnnt_tpu_torch.ops.pruning import _window_argmax, _window_scores
    from fast_rnnt_tpu_torch.utils import from_numpy

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log = _build.BUILD_LOG.get("compiler_output", "")
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", f"{time.perf_counter() - t0:.1f} s -> {os.path.relpath(_build.BUILD_LOG['path'], HERE)}")
    for ln in usage:
        print("  ptxas: " + ln, flush=True)

    def t(*arrays):
        return from_numpy(*arrays, device=dev)

    # --- 3. each kernel against its plain version --------------------------
    rng = np.random.default_rng(1)
    cases = [
        (3, 6, 20, False, False, False), (3, 6, 20, True, False, False),
        (4, 7, 33, False, True, True), (4, 7, 33, True, True, True),
        (2, 0, 9, False, False, False), (2, 0, 9, True, False, True),
        (3, 9, 1200, False, False, True), (2, 5, 64, True, True, False),
    ]
    small = {"wavefront_fwd": 0.0, "wavefront_bwd": 0.0, "latbuild_fwd": 0.0}
    # every torch draw on the card comes from a generator seeded per case
    # (and numpy's from default_rng(1) in this order): a failing check names
    # its case and seed, and a rerun draws the same inputs
    for i, (Bc, Sc, Tc, modified, banded, offset) in enumerate(cases):
        px, py, bnd, lo, K = t(*rand_case(rng, Bc, Sc, Tc, modified, banded, offset))
        try:
            p_k, sc_k = wavefront.forward_rows(px, py, bnd, lo, K)
            p_p, sc_p = wavefront.forward_rows_plain(px, py, bnd, lo, K)
            small["wavefront_fwd"] = max(
                small["wavefront_fwd"],
                finite_err(p_k, p_p, "fwd p", 1e-4, 1e-5)[0],
                finite_err(sc_k, sc_p, "fwd scores", 1e-4, 1e-5)[0],
            )
            ag = torch.rand(Bc, device=dev, generator=torch.Generator(device=dev).manual_seed(100 + i)) + 0.5
            gx_k, gy_k = wavefront.backward_rows(px, py, p_k, bnd, ag, lo, K)
            gx_p, gy_p = wavefront.backward_rows_plain(px, py, p_p, bnd, ag, lo, K)
            small["wavefront_bwd"] = max(
                small["wavefront_bwd"],
                finite_err(gx_k, gx_p, "bwd px_grad", 1e-5, 1e-4)[0],
                finite_err(gy_k, gy_p, "bwd py_grad", 1e-5, 1e-4)[0],
            )
            if Sc >= 2:
                Kr = min(3, Sc + 1)
                step = 2 if modified else Kr
                st_k = ranges.window_starts(gy_k, gx_k, Kr, bnd, step)
                ranges_check(st_k, gy_k, gx_k, Kr, bnd, step, "ranges (small)")
        except Failed as e:
            raise Failed(f"{e} (kernels-small case {i} {cases[i]}, seed {100 + i})") from e
        for Cc in (17, 32):
            seed = 1000 * i + Cc
            try:
                errs = build_checks(dev, rng, bnd, Sc, Tc, modified, offset, Cc, seed)
            except Failed as e:
                raise Failed(f"{e} (kernels-small case {i} {cases[i]}, C={Cc}, seed {seed})") from e
            for name, err in errs.items():
                small[name] = max(small.get(name, 0.0), err)
    # the recursion kernels in every storage dtype on fresh draws of every
    # case, on the constrained lattice (banded and not) and over two
    # 128-row strips of the sweep (banded and not)
    rec_cases = cases + [(3, 6, 40, True, False, True, True), (3, 6, 40, True, True, True, True),
                         (2, 140, 60, False, False, True), (2, 140, 60, True, True, True)]
    for i, case in enumerate(rec_cases):
        px, py, bnd, lo, K = t(*rand_case(rng, *case))
        try:
            errs = recursion_checks(px, py, bnd, lo, K, 200 + i)
        except Failed as e:
            raise Failed(f"{e} (kernels-small recursion case {i} {case}, seed {200 + i})") from e
        for name, err in errs.items():
            small[name] = max(small.get(name, 0.0), err)
    phase("kernels-small", f"{len(cases)} ragged cases (regular/modified/constrained, banded, "
          f"non-zero begins, S=0, out-of-range symbols, random blanks, random cotangents) ok, the "
          f"recursion kernels also in bfloat16 and float16 storage; max abs err {json.dumps(small)} "
          f"(tol: lattices 1e-4 + 1e-5|x|, occupancies 1e-5 + 1e-4|x| (fused against its plain version, "
          f"which runs its own forward: 1e-5 + 1e-3|x|), in bf16/f16 storage plus one step of it, build "
          f"gradients {GRAD_TOL} of max |plain| (bf16 inputs {BF16_CONTRACT_TOL}, a bf16 output plus one "
          f"bf16 step), ranges flips near-ties); the sweep pair's p in every cell, its backward on random "
          f"seeds with 0 and a negative one; sweep pair seeded with ones == fused bit for bit, both "
          f"deterministic, in {len(rec_cases)} cases x 3 storage dtypes")

    # the smoothed build backward's d_uni on seeded draws, the plain version
    # on the kernels' exact contract and, counted, on the earlier one
    duni_sweep_phase(dev)

    # golden path-enumeration vectors (float64 enumeration, tests/golden)
    gfiles = sorted(glob.glob(os.path.join(HERE, "tests", "golden", "*.npz")))
    gerr = 0.0
    for path in gfiles:
        g = np.load(path)
        px = torch.from_numpy(g["px"].astype(np.float32)).permute(1, 0, 2).contiguous().to(dev)
        py = torch.from_numpy(g["py"].astype(np.float32)).permute(1, 0, 2).contiguous().to(dev)
        bnd = t(g["boundary"])
        lo, K = (t(g["lo"]), int(g["K"])) if "lo" in g.files else (None, 0)
        p_k, sc_k = wavefront.forward_rows(px, py, bnd, lo, K)
        gx_k, gy_k = wavefront.backward_rows(px, py, p_k, bnd, torch.ones_like(sc_k), lo, K)
        gerr = max(
            gerr,
            finite_err(sc_k.cpu(), torch.from_numpy(g["scores"]), "golden scores", 1e-5, 1e-5)[0],
            finite_err(gx_k.permute(1, 0, 2).cpu(), torch.from_numpy(g["px_grad"]),
                       "golden px_grad", 1e-5, 1e-4)[0],
            finite_err(gy_k.permute(1, 0, 2).cpu(), torch.from_numpy(g["py_grad"]),
                       "golden py_grad", 1e-5, 1e-4)[0],
        )
    if not gfiles:
        raise Failed("no golden vectors under tests/golden")
    phase("golden", f"{len(gfiles)} path-enumeration vectors ok; max abs err {gerr:.3e}")

    # the parity gate at the headline shape, before the first timing
    am_np, lm_np, sym_np, bnd_np = make_inputs(seed=0)
    am, lm, sym, bnd = t(am_np, lm_np, sym_np, bnd_np)
    parity_phase(am, lm, sym, bnd)

    # headline shape: each kernel against its plain version, with times
    report, n_flip, cons = headline_kernels(am, lm, sym, bnd)
    # the library yardsticks' cuBLAS workspaces (32 MiB for the float32
    # calls, 32 more for the bf16 ones) stay allocated: freed here, they are
    # no part of the paths' memory (the first slice's 156.1 MiB peak counted
    # the float32 one; FWD_ABOVE_MIB holds the forward without them)
    torch._C._cuda_clearCublasWorkspaces()
    bounds = kernel_bounds(bnd)  # of the inputs the kernels were timed on
    fp32_bounds, bf16_bounds = kernel_bounds(bnd, 0), kernel_bounds(bnd, 1, 2)
    for name in ("latbuild_fwd", "latbuild_bwd", "latbuild_fwd_parts", "latbuild_bwd_parts"):
        v = report[name]
        v["note"] = (f"(bound {bounds[name][0]:.4f} ms by {bounds[name][1]} in 3xTF32; with fp32 FMAs "
                     f"{fp32_bounds[name][0]:.4f} ms")
        if "bf16" in v:
            x = v.pop("bf16")
            v["note"] += (f"; bf16 lm and am: kernel {x['ms']:.4f} ms plain {x['plain_ms']:.4f} ms library "
                          f"{x['library_ms']:.4f} ms bound {bf16_bounds[name][0]:.4f} ms by "
                          f"{bf16_bounds[name][1]}, max abs err {x['err']:.3e} (tol {x['tol']})")
        v["note"] += ")"
    phase("kernels-headline", f"B={B} T={T} S={S} C={C}: " + "; ".join(
        f"{k} max abs err {v['err']:.3e} rel {v['rel']:.3e} (tol {v['tol']}) "
        f"kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms"
        + (f" library {v['library_ms']:.4f} ms" if "library_ms" in v else "")
        + (f" with residuals {v['residuals_ms']:.4f} ms" if "residuals_ms" in v else "")
        + (f" {v['note']}" if "note" in v else "")
        for k, v in report.items()
    ) + f"; ranges flips {n_flip}; occupancy conservation rel err kernel {cons[0]:.2e} "
      f"plain {cons[1]:.2e}")

    # the pruned lattice's kernels at the recipe's shape
    pruned_report, pruned_bounds = pruned_lattice_phase(dev)
    report.update(pruned_report)
    bounds.update(pruned_bounds)
    # icefall's relative-position attention at the conformer cell's largest bucket
    relpos_report, relpos_bounds = relpos_attention_phase()
    report.update(relpos_report)
    bounds.update(relpos_bounds)

    # --- 4. the paths: forward only, training, smoothed training ------------
    counters = launch_counters()

    def counted(fn, path, want):
        """Run ``fn`` once with every launch count set to 0 just before and
        read just after; the counts must be ``want`` (0 for the kernels not
        named).  Returns (result, counts, first-call ms, peak MiB, MiB
        allocated before)."""
        for d, k in counters.values():
            d[k] = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**20
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        got = {name: d[k] for name, (d, k) in counters.items()}
        if got != {name: want.get(name, 0) for name in counters}:
            raise Failed(f"{path}: launches {got}, expected {want}")
        return out, got, first, peak, base

    def step():
        return rnnt_loss_simple_pruned(lm, am, sym, 0, S_RANGE, bnd, reduction="none")

    (simple, pruned, rng_k), launches, first_ms, peak_mb, base_mb = counted(
        step, "main path (forward)",
        {"wavefront_fused": 1, "wavefront_fwd": 1, "latbuild_fwd": 1, "ranges": 1},
    )
    # the split arm: stage 1 through the sweep pair, the same bits
    out_x, _, _, peak_x, base_x = counted(
        armed("split", step), "main path (forward, split arm)",
        {"wavefront_fwd": 2, "wavefront_bwd": 1, "latbuild_fwd": 1, "ranges": 1},
    )
    same_fwd = same_bits(out_x, (simple, pruned, rng_k), "main path (split arm)")
    del out_x
    if peak_mb > FWD_PEAK_MIB or peak_mb - base_mb > FWD_ABOVE_MIB:
        raise Failed(f"forward-only peak {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB above what was "
                     f"allocated before it) > {FWD_PEAK_MIB} MiB or {FWD_ABOVE_MIB} MiB above: a residual "
                     "was kept")
    if simple.shape != (B,) or pruned.shape != (B,) or tuple(rng_k.shape) != (B, T, S_RANGE):
        raise Failed(f"shapes {simple.shape} {pruned.shape} {tuple(rng_k.shape)}")
    if not (torch.isfinite(simple).all() and torch.isfinite(pruned).all()):
        raise Failed("non-finite losses")
    if (pruned < simple - 1e-3 * simple.abs()).any():
        # the pruned lattice is a subset of the full one: its loss is larger
        raise Failed("pruned loss below the simple loss")

    # the plain path on the card, on the same inputs
    ones = torch.ones(B, device=dev)
    px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, 0, "regular", bnd)
    p_p, sc_p = wavefront.forward_rows_plain(px_p, py_p, bnd)
    gx_p, gy_p = wavefront.backward_rows_plain(px_p, py_p, p_p, bnd, ones)
    del p_p
    # the kernel path's stage-1 occupancies, recomputed outside the counted run
    px_k, py_k = latbuild.lattice_rows(lm, am, sym, 0, "regular", bnd)
    _, gx_k, gy_k = wavefront.fused_rows(px_k, py_k, bnd)
    del px_k, py_k
    # ranges, by the near-tie rule: (a) the main path's ranges are the
    # repair of the ranges kernel's raw argmax of its own occupancies, and
    # that argmax differs from the plain search's only at near-ties
    # (ranges_check); (b) where the two paths' occupancies (which differ in
    # the last float32 bits) pick different raw window argmaxes, the two
    # windows' scores are within 1e-3.  A raw flip cascades through the
    # monotone repair into other frames, so repaired ranges are compared
    # frame by frame only against the repair of the same raw argmax.
    lo_k = rng_k[:, :, 0].contiguous()
    n_tie, tie_gap, tie_at = ranges_check(lo_k, gy_k, gx_k, S_RANGE, bnd, S_RANGE, "main-path ranges")
    n_flip, gap = range_flips(
        _window_argmax(gx_k, gy_k, S_RANGE), _window_argmax(gx_p, gy_p, S_RANGE),
        _window_scores(gx_p, gy_p, S_RANGE), "main-path raw window argmax",
    )
    del gx_k, gy_k
    # stage 2 of the plain path on the kernel's ranges (near-tie rule)
    p2_p, sc2_p = wavefront.forward_rows_plain(px_p, py_p, bnd, lo_k, S_RANGE)
    rel_s = ((simple + sc_p).abs() / sc_p.abs()).max().item()
    rel_p = ((pruned + sc2_p).abs() / sc2_p.abs()).max().item()
    if rel_s > 1e-4 or rel_p > 1e-4:
        raise Failed(f"losses vs plain path: rel err simple {rel_s:.3e} pruned {rel_p:.3e} > 1e-4")
    step_ms = cuda_ms(step)
    ab_fwd = in_turns(armed("split", step), step)
    phase("main-path", f"rnnt_loss_simple_pruned B={B} T={T} S={S} C={C} s_range={S_RANGE} "
          f"fp32, forward only: launches {json.dumps(launches)}; loss rel err vs plain simple {rel_s:.3e} "
          f"pruned {rel_p:.3e}; raw window-argmax flips {n_flip} (max score gap {gap:.3e}); ranges = the "
          f"repair of the ranges kernel's raw argmax, which flips against the plain search's at {n_tie} "
          f"frames (max score gap {tie_gap:.3e}, tol 1e-3; first (b, t) {tie_at}); step {step_ms:.4f} ms "
          f"(CUDA events, median of {REPS} runs of 10 steps; first call {first_ms:.1f} ms); peak "
          f"{peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB above the inputs; bounds {FWD_PEAK_MIB}, "
          f"{FWD_ABOVE_MIB} above); "
          f"sum simple {simple.sum().item():.3f} pruned {pruned.sum().item():.3f}; "
          f"split arm {same_fwd}, peak "
          f"{peak_x:.1f} MiB ({peak_x - base_x:.1f} MiB above what was allocated before it); in turns (split, shipped, shipped, split) "
          + ", ".join(f"{x:.4f}" for x in ab_fwd) + " ms")

    # training: bench.py's step, the gradient of 0.5 * simple + pruned
    am_g, lm_g = am.clone().requires_grad_(), lm.clone().requires_grad_()

    # (the loss, per-utterance losses for the arms' comparison, gradients,
    # ranges); the loss is reduction="sum"'s, bit for bit
    def train_step():
        s, p, r = rnnt_loss_simple_pruned(lm_g, am_g, sym, 0, S_RANGE, bnd, reduction="none")
        loss = 0.5 * s.sum() + p.sum()
        return (loss.detach(), (0.5 * s + p).detach(), *torch.autograd.grad(loss, (am_g, lm_g)), r)

    (loss_t, l_t, g_am, g_lm, r_t), launches_t, first_t, peak_t, base_t = counted(
        train_step, "training",
        {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
         "wavefront_bwd": 1, "ranges": 1},
    )
    out_x, _, _, peak_tx, base_tx = counted(
        armed("split", train_step), "training (split arm)",
        {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fwd": 2, "wavefront_bwd": 2, "ranges": 1},
    )
    same_train = same_bits(out_x, (loss_t, l_t, g_am, g_lm, r_t), "training (split arm)")
    del out_x
    loss_f = 0.5 * simple.sum() + pruned.sum()
    rel_l = ((loss_t - loss_f).abs() / loss_f.abs()).item()
    if rel_l > 1e-6 or not torch.equal(r_t, rng_k):
        raise Failed(f"training loss {loss_t.item()} / ranges differ from the forward path's ({rel_l:.3e})")
    # plain reference: the plain recursion's occupancies (stage 2 on the
    # kernel path's ranges) as cotangents of the plain build backward
    g2x, g2y = wavefront.backward_rows_plain(px_p, py_p, p2_p, bnd, ones, lo_k, S_RANGE)
    del p2_p
    w_lm, w_am, _ = latbuild.lattice_rows_bwd_plain(
        lm, am, sym, bnd[:, 3], -(0.5 * gx_p + g2x), -(0.5 * gy_p + g2y), 0, False
    )
    e_t = worst(grad_err(g_am, w_am, "training d_am", TRAIN_GRAD_TOL),
                grad_err(g_lm, w_lm, "training d_lm", TRAIN_GRAD_TOL))
    g_train = (g_am, g_lm)  # the recipe phases are held to these
    del g_am, g_lm, w_am, w_lm, g2x, g2y, gx_p, gy_p, px_p, py_p
    train_ms = cuda_ms(train_step)
    ab_train = in_turns(armed("split", train_step), train_step)
    phase("train", f"grad of 0.5*simple + pruned (reduction sum) w.r.t. (am, lm), B={B} T={T} "
          f"S={S} C={C} s_range={S_RANGE} fp32: launches {json.dumps(launches_t)}; loss "
          f"{loss_t.item():.3f} (rel {rel_l:.1e} from the forward path's); gradients vs plain "
          f"max abs err {e_t[0]:.3e} ({e_t[1]:.3e} of max |plain|, tol {TRAIN_GRAD_TOL}); step "
          f"{train_ms:.4f} ms (CUDA events, median of {REPS} runs of 10 steps; first call "
          f"{first_t:.1f} ms); peak {peak_t:.1f} MiB ({peak_t - base_t:.1f} MiB above the inputs); "
          f"split arm {same_train}, peak {peak_tx:.1f} MiB ({peak_tx - base_tx:.1f} MiB above what was "
          f"allocated before it); in turns (split, shipped, shipped, split) "
          + ", ".join(f"{x:.4f}" for x in ab_train) + " ms")

    # the bf16-input mode (bench.py's second row, the JAX package's "production
    # mixed precision"): bf16 am and lm, a bf16 lattice; held to the float32
    # training step on the same bf16-rounded inputs.  The loss gap of a sound
    # run is 1.5e-5 relative (three runs on an H100); a bf16 lattice cast
    # that truncates in place of rounding is the fault the limit is set
    # against.  The gradients carry the bf16 occupancies' round-off (~1.1e-2
    # of max, as recipe-train-bf16's); the build backward's own precision is
    # held by BF16_CONTRACT_TOL.
    TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_TOL = 1e-4, 3e-2
    am16_g, lm16_g = am.bfloat16().requires_grad_(), lm.bfloat16().requires_grad_()

    def train_step_bf16():
        s, p, r = rnnt_loss_simple_pruned(lm16_g, am16_g, sym, 0, S_RANGE, bnd, reduction="sum",
                                          lattice_dtype=torch.bfloat16)
        loss = 0.5 * s + p
        return (loss.detach(), *torch.autograd.grad(loss, (am16_g, lm16_g)), r)

    (loss_b, *g_b, r_b), launches_b, first_b, peak_b, base_b = counted(
        train_step_bf16, "train-bf16",
        {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
         "wavefront_bwd": 1, "ranges": 1},
    )
    if g_b[0].dtype != torch.bfloat16 or g_b[1].dtype != torch.bfloat16:
        raise Failed(f"train-bf16: gradient dtypes {g_b[0].dtype} {g_b[1].dtype}")
    # the float32 reference prunes with the bf16 step's ranges: where bf16
    # occupancies move a window start (a near-tie), the pruned gradient moves
    # with it, by O(1), and that is no precision loss of the step
    am_r, lm_r = am16_g.detach().float().requires_grad_(), lm16_g.detach().float().requires_grad_()
    r_own = rnnt_loss_simple_pruned(lm_r.detach(), am_r.detach(), sym, 0, S_RANGE, bnd, reduction="sum")[2]
    n_moved = int((r_own != r_b).any(2).sum())
    s_r = rnnt_loss_simple(lm_r, am_r, sym, 0, bnd, reduction="sum")
    p_r = rnnt_loss_pruned_simple(lm_r, am_r, sym, r_b, 0, bnd, reduction="sum")
    loss_r = 0.5 * s_r + p_r
    g_r = torch.autograd.grad(loss_r, (am_r, lm_r))
    rel_b = ((loss_b - loss_r).abs() / loss_r.abs()).item()
    if not (torch.isfinite(loss_b) and rel_b <= TRAIN_BF16_LOSS_RTOL):
        raise Failed(f"train-bf16: loss {loss_b.item()} vs float32 {loss_r.item()}: rel {rel_b:.3e}")
    g_gap = worst(*(grad_err(a.float(), b, f"train-bf16 {n}", TRAIN_BF16_GRAD_TOL)
                    for a, b, n in zip(g_b, g_r, ("d_am", "d_lm"))))
    # the bf16 build kernel against its plain version on these inputs
    lm16, am16 = lm16_g.detach(), am16_g.detach()
    e_b = worst(*(finite_err(a, b, f"train-bf16 build {n}", 1e-4, 1e-5) for a, b, n in zip(
        latbuild.lattice_rows(lm16, am16, sym, 0, "regular", bnd),
        latbuild.lattice_rows_plain(lm16, am16, sym, 0, "regular", bnd), ("px", "py"))))
    del g_b, g_r, am_r, lm_r, lm16, am16
    train_bf16_ms = cuda_ms(train_step_bf16)
    phase("train-bf16", f"grad of 0.5*simple + pruned w.r.t. bf16 (am, lm), lattice_dtype bf16, B={B} T={T} "
          f"S={S} C={C} s_range={S_RANGE}: launches {json.dumps(launches_b)}; loss {loss_b.item():.3f} vs "
          f"float32 on the rounded inputs (pruned with these ranges; its own move {n_moved} frames) "
          f"{loss_r.item():.3f}: rel {rel_b:.3e} (tol {TRAIN_BF16_LOSS_RTOL}); "
          f"gradients (bf16) max abs diff {g_gap[0]:.3e} ({g_gap[1]:.3e} of max, tol {TRAIN_BF16_GRAD_TOL}); "
          f"bf16 build vs plain max abs err {e_b[0]:.3e} (tol 1e-4 + 1e-5|x|); step {train_bf16_ms:.4f} ms "
          f"(CUDA events, median of {REPS} runs of 10 steps; first call {first_b:.1f} ms); peak "
          f"{peak_b:.1f} MiB ({peak_b - base_b:.1f} MiB above the inputs)")
    del loss_r, s_r, p_r

    # smoothed training: rnnt_loss_smoothed_pruned, default scales
    def smoothed_step():
        s, p, r = rnnt_loss_smoothed_pruned(lm_g, am_g, sym, 0, S_RANGE, boundary=bnd,
                                            reduction="sum")
        loss = 0.5 * s + p
        return (loss.detach(), *torch.autograd.grad(loss, (am_g, lm_g)), r)

    (loss_s, g_am, g_lm, r_s), launches_s, first_s, peak_s, base_s = counted(
        smoothed_step, "smoothed training",
        {"latbuild_fwd_parts": 1, "latbuild_bwd_parts": 1, "latbuild_fwd": 1, "latbuild_bwd": 1,
         "wavefront_fused": 1, "wavefront_fwd": 1, "wavefront_bwd": 1, "ranges": 1},
    )
    # plain reference: autograd of the plain builds, fed the plain
    # recursion's occupancies (stage 2 on the kernel path's ranges)
    am_r, lm_r = am.clone().requires_grad_(), lm.clone().requires_grad_()
    pxs, pys = latbuild.lattice_rows_smoothed_plain(lm_r, am_r, sym, 0, 0.1, 0.1, bnd)
    px2, py2 = latbuild.lattice_rows_plain(lm_r, am_r, sym, 0, "regular", bnd)
    lo_s = r_s[:, :, 0].contiguous()
    with torch.no_grad():
        p_s, sc_s = wavefront.forward_rows_plain(pxs, pys, bnd)
        gxs, gys = wavefront.backward_rows_plain(pxs, pys, p_s, bnd, ones)
        del p_s
        p_2, sc_2 = wavefront.forward_rows_plain(px2, py2, bnd, lo_s, S_RANGE)
        gx2, gy2 = wavefront.backward_rows_plain(px2, py2, p_2, bnd, ones, lo_s, S_RANGE)
        del p_2
    loss_r = -(0.5 * sc_s.sum() + sc_2.sum())
    rel_ls = ((loss_s - loss_r).abs() / loss_r.abs()).item()
    if rel_ls > 1e-4:
        raise Failed(f"smoothed training loss rel err vs plain {rel_ls:.3e} > 1e-4")
    w_am, w_lm = torch.autograd.grad(
        [pxs, pys, px2, py2], [am_r, lm_r], [-0.5 * gxs, -0.5 * gys, -gx2, -gy2]
    )
    e_s = worst(grad_err(g_am, w_am, "smoothed training d_am", TRAIN_GRAD_TOL),
                grad_err(g_lm, w_lm, "smoothed training d_lm", TRAIN_GRAD_TOL))
    del g_am, g_lm, w_am, w_lm, pxs, pys, px2, py2, gxs, gys, gx2, gy2
    smoothed_ms = cuda_ms(smoothed_step)
    phase("smoothed-train", f"grad of 0.5*smoothed + pruned (rnnt_loss_smoothed_pruned, scales 0.1/0.1, "
          f"reduction sum) w.r.t. (am, lm): launches {json.dumps(launches_s)}; loss "
          f"{loss_s.item():.3f} (rel err vs plain {rel_ls:.3e}); gradients vs plain max abs err "
          f"{e_s[0]:.3e} ({e_s[1]:.3e} of max |plain|, tol {TRAIN_GRAD_TOL}); step {smoothed_ms:.4f} ms "
          f"(CUDA events, median of {REPS} runs of 10 steps; first call {first_s:.1f} ms); peak "
          f"{peak_s:.1f} MiB ({peak_s - base_s:.1f} MiB above the inputs)")

    # smoothed training in the bf16-input mode: bf16 am and lm, a bf16
    # lattice; the smoothed build kernels round as the Pallas smoothed build
    # does.  Held to the plain path on the card on the same inputs (the plain
    # builds, XLA-rounded, and the plain recursion on the kernel path's
    # ranges) at train-bf16's tolerances
    def smoothed_step_bf16():
        s, p, r = rnnt_loss_smoothed_pruned(lm16_g, am16_g, sym, 0, S_RANGE, boundary=bnd,
                                            reduction="sum", lattice_dtype=torch.bfloat16)
        loss = 0.5 * s + p
        return (loss.detach(), *torch.autograd.grad(loss, (am16_g, lm16_g)), r)

    (loss_sb, *g_sb, r_sb), launches_sb, first_sb, peak_sb, base_sb = counted(
        smoothed_step_bf16, "smoothed-train-bf16",
        {"latbuild_fwd_parts": 1, "latbuild_bwd_parts": 1, "latbuild_fwd": 1, "latbuild_bwd": 1,
         "wavefront_fused": 1, "wavefront_fwd": 1, "wavefront_bwd": 1, "ranges": 1},
    )
    if g_sb[0].dtype != torch.bfloat16 or g_sb[1].dtype != torch.bfloat16:
        raise Failed(f"smoothed-train-bf16: gradient dtypes {g_sb[0].dtype} {g_sb[1].dtype}")
    am_r, lm_r = am16_g.detach().clone().requires_grad_(), lm16_g.detach().clone().requires_grad_()
    pxs, pys = latbuild.lattice_rows_smoothed_plain(lm_r, am_r, sym, 0, 0.1, 0.1, bnd)
    px2, py2 = latbuild.lattice_rows_plain(lm_r, am_r, sym, 0, "regular", bnd)
    lo_sb = r_sb[:, :, 0].contiguous()
    with torch.no_grad():
        xs, ys, x2, y2 = (v.bfloat16() for v in (pxs, pys, px2, py2))
        p_s, sc_s = wavefront.forward_rows_plain(xs, ys, bnd)
        gxs, gys = wavefront.backward_rows_plain(xs, ys, p_s, bnd, ones)
        del p_s
        p_2, sc_2 = wavefront.forward_rows_plain(x2, y2, bnd, lo_sb, S_RANGE)
        gx2, gy2 = wavefront.backward_rows_plain(x2, y2, p_2, bnd, ones, lo_sb, S_RANGE)
        del p_2, xs, ys, x2, y2
    loss_r = -(0.5 * sc_s.sum() + sc_2.sum())
    rel_sb = ((loss_sb - loss_r).abs() / loss_r.abs()).item()
    if not (torch.isfinite(loss_sb) and rel_sb <= TRAIN_BF16_LOSS_RTOL):
        raise Failed(f"smoothed-train-bf16: loss {loss_sb.item()} vs plain {loss_r.item()}: rel {rel_sb:.3e}")
    w_am, w_lm = torch.autograd.grad(
        [pxs, pys, px2, py2], [am_r, lm_r],
        [-0.5 * gxs.float(), -0.5 * gys.float(), -gx2.float(), -gy2.float()])
    e_sb = worst(*(grad_err(a.float(), b.float(), f"smoothed-train-bf16 {n}", TRAIN_BF16_GRAD_TOL)
                   for a, b, n in zip(g_sb, (w_am, w_lm), ("d_am", "d_lm"))))
    del g_sb, w_am, w_lm, pxs, pys, px2, py2, gxs, gys, gx2, gy2, am_r, lm_r
    smoothed_bf16_ms = cuda_ms(smoothed_step_bf16)
    phase("smoothed-train-bf16", f"grad of 0.5*smoothed + pruned (rnnt_loss_smoothed_pruned, scales "
          f"0.1/0.1, reduction sum, lattice_dtype bf16) w.r.t. bf16 (am, lm): launches "
          f"{json.dumps(launches_sb)}; loss {loss_sb.item():.3f} vs the plain path on the card "
          f"{loss_r.item():.3f}: rel {rel_sb:.3e} (tol {TRAIN_BF16_LOSS_RTOL}); gradients (bf16) max abs "
          f"diff {e_sb[0]:.3e} ({e_sb[1]:.3e} of max, tol {TRAIN_BF16_GRAD_TOL}); step {smoothed_bf16_ms:.4f} "
          f"ms (CUDA events, median of {REPS} runs of 10 steps; first call {first_sb:.1f} ms); peak "
          f"{peak_sb:.1f} MiB ({peak_sb - base_sb:.1f} MiB above the inputs)")
    del loss_r

    # the real-joiner recipe, with the joiner am_p + lm_p: the training
    # step's function computed through the pruned logits
    def recipe_step(logits_dtype=None):
        simple, (gx, gy) = rnnt_loss_simple(lm_g, am_g, sym, 0, bnd, reduction="none",
                                            calc_gradients=True)
        r = get_rnnt_prune_ranges(gx, gy, bnd, S_RANGE)
        am_p, lm_p = do_rnnt_pruning(am_g, lm_g, r)
        logits = am_p + lm_p
        if logits_dtype is not None:
            logits = logits.to(logits_dtype)
        pruned = rnnt_loss_pruned(logits, sym, r, 0, bnd, reduction="none")
        loss = 0.5 * simple.sum() + pruned.sum()
        return (loss.detach(), (0.5 * simple + pruned).detach(), *torch.autograd.grad(loss, (am_g, lm_g)), r)

    # shipped: stage 1 fused, stage 2 the sweep pair; split: both stages
    # through the sweep pair (the shipped arm's bits)
    recipe_arms = {
        "shipped": {"wavefront_fused": 1, "wavefront_fwd": 1, "wavefront_bwd": 1},
        "split": {"wavefront_fwd": 2, "wavefront_bwd": 2},
    }
    recipe = {}
    for name, want in recipe_arms.items():
        (loss_r, l_r, *g_r, r_r), n_r, first_r, peak_r, base_r = counted(
            armed(name, recipe_step), f"recipe-train ({name})",
            {"latbuild_fwd": 1, "latbuild_bwd": 1, "ranges": 1, "pruned_band": 1, "pruned_rows": 1, "pruned_bwd": 1, **want})
        # stage 1 is the training step's (the split arm's gives the same
        # bits), so the ranges must be the training step's; the losses each
        # to rel 1e-4, and the batch sum
        agree = (r_r == r_t).flatten(1).all(1)
        if not bool(agree.all()):
            n = int((r_r != r_t).any(2).sum())
            raise Failed(f"recipe-train ({name}): ranges differ from train's at {n} frames")
        rel_r = ((l_r - l_t).abs() / l_t.abs())[agree].max().item()
        if bool(agree.all()):
            rel_r = max(rel_r, ((loss_r - loss_t).abs() / loss_t.abs()).item())
        if rel_r > 1e-4:
            raise Failed(f"recipe-train ({name}): loss rel err vs train {rel_r:.3e} > 1e-4")
        e_r = worst(*(grad_err(a[agree], b[agree], f"recipe-train ({name}) {n}", TRAIN_GRAD_TOL)
                      for a, b, n in zip(g_r, g_train, ("d_am", "d_lm"))))
        held = (f"ranges equal to train's on {int(agree.sum())} of {B} utterances; on those, loss rel err "
                f"vs train {rel_r:.3e} (tol 1e-4, each and, when all agree, the sum); gradients max abs "
                f"err {e_r[0]:.3e} ({e_r[1]:.3e} of max, tol {TRAIN_GRAD_TOL})")
        if name != "shipped":
            held += f"; vs the shipped arm {same_bits((loss_r, l_r, *g_r, r_r), recipe['shipped'][0], name)}"
        recipe[name] = ((loss_r, l_r, *g_r, r_r), n_r)
        ms_r = cuda_ms(armed(name, recipe_step))
        phase("recipe-train", f"{name} arm: rnnt_loss_simple (calc_gradients) -> get_rnnt_prune_ranges "
              f"-> do_rnnt_pruning -> am_p + lm_p -> rnnt_loss_pruned (reduction sum), grad of 0.5*simple "
              f"+ pruned w.r.t. (am, lm), B={B} T={T} S={S} C={C} s_range={S_RANGE} fp32: launches "
              f"{json.dumps(n_r)}; loss {loss_r.item():.3f}; {held}; step {ms_r:.4f} ms (CUDA events, "
              f"median of {REPS} runs of 10 steps; first call {first_r:.1f} ms); peak {peak_r:.1f} MiB "
              f"({peak_r - base_r:.1f} MiB above the inputs)")
    del g_r
    launches_recipe = recipe["shipped"][1]
    (loss_f32, _, *g_f32, r_f32), _ = recipe["shipped"]
    del recipe
    # the arms in turns, in one process
    ab_recipe = in_turns(armed("split", recipe_step), recipe_step)
    phase("recipe-train", "in turns (split, shipped, shipped, split): "
          + ", ".join(f"{x:.4f}" for x in ab_recipe) + " ms")

    # the mixed-precision form: bf16 pruned logits, so a bf16 lattice in the
    # stage-2 recursion kernels.  Held to the JAX package's bf16 bound (rtol
    # 5e-2, atol 0.1, tests/test_recursion.py:359-361) of the float32
    # recipe, and to the bounds below, set from the H100 readings (loss gap
    # 1.16e-5 relative, gradient gap 1.108e-2 of max, PERF.md)
    BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-3, 3e-2
    def recipe_step_bf16():
        return recipe_step(torch.bfloat16)

    (loss_b, l_b, *g_b, r_b), n_b, first_b, peak_b, base_b = counted(
        recipe_step_bf16, "recipe-train-bf16",
        {"latbuild_fwd": 1, "latbuild_bwd": 1, "wavefront_fused": 1, "wavefront_fwd": 1,
         "wavefront_bwd": 1, "ranges": 1, "pruned_band": 1, "pruned_rows": 1, "pruned_bwd": 1})
    if not (torch.isfinite(loss_b) and all(torch.isfinite(g).all() for g in g_b)):
        raise Failed("recipe-train-bf16: non-finite loss or gradient")
    if not torch.equal(r_b, r_f32):
        raise Failed("recipe-train-bf16: ranges differ from the float32 recipe's (same stage 1)")
    gap = (loss_b - loss_f32).abs().item()
    if gap > 0.1 + 5e-2 * loss_f32.abs().item() or gap > BF16_LOSS_RTOL * loss_f32.abs().item():
        raise Failed(f"recipe-train-bf16: loss {loss_b.item()} vs float32 {loss_f32.item()}: gap {gap:.3e}")
    g_gap = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(g_b, g_f32))
    if g_gap > BF16_GRAD_TOL:
        raise Failed(f"recipe-train-bf16: gradients {g_gap:.3e} of max from float32's > {BF16_GRAD_TOL}")
    del g_b, g_f32
    ms_b = cuda_ms(recipe_step_bf16)
    phase("recipe-train-bf16", f"the recipe with bf16 pruned logits (a bf16 lattice in the sweep pair): "
          f"launches {json.dumps(n_b)}; loss {loss_b.item():.3f} vs float32 {loss_f32.item():.3f}: gap "
          f"{gap:.3e} ({gap / loss_f32.abs().item():.3e} rel; tol 0.1 + 5e-2|x| and {BF16_LOSS_RTOL}|x|); "
          f"gradients vs float32 max abs diff {g_gap:.3e} of max (tol {BF16_GRAD_TOL}); step {ms_b:.4f} ms "
          f"(CUDA events, median of {REPS} runs of 10 steps; first call {first_b:.1f} ms); peak "
          f"{peak_b:.1f} MiB ({peak_b - base_b:.1f} MiB above the inputs)")

    # the unpruned loss of full logits [BJ, T, S+1, C] (808 MB at BJ = 4),
    # with occupancies and a backward, shipped (fused) and split; with the
    # joiner am + lm it equals the simple loss
    BJ = 4
    am_j, lm_j = am[:BJ].clone().requires_grad_(), lm[:BJ].clone().requires_grad_()
    sym_j, bnd_j = sym[:BJ].contiguous(), bnd[:BJ].contiguous()

    def joint_step():
        logits = am_j[:, :, None, :] + lm_j[:, None, :, :]
        loss, (gx, gy) = rnnt_loss(logits, sym_j, 0, bnd_j, reduction="sum", calc_gradients=True)
        return (loss.detach(), gx, gy, *torch.autograd.grad(loss, (am_j, lm_j)))

    joint = {}
    for name, want in (("shipped", {"wavefront_fused": 1}), ("split", {"wavefront_fwd": 1, "wavefront_bwd": 1})):
        out, n_j, first_j, peak_j, base_j = counted(armed(name, joint_step), f"joint ({name})", want)
        joint[name] = (out, n_j, first_j, peak_j - base_j)
    same_j = same_bits(joint["split"][0], joint["shipped"][0], "joint (split arm)")
    loss_j = joint["shipped"][0][0]
    simple_j = rnnt_loss_simple(lm[:BJ], am[:BJ], sym_j, 0, bnd_j, reduction="sum")
    rel_j = ((loss_j - simple_j).abs() / simple_j.abs()).item()
    if rel_j > 1e-4:
        raise Failed(f"joint: rnnt_loss of am + lm vs rnnt_loss_simple rel err {rel_j:.3e} > 1e-4")
    del am_j, lm_j, loss_j
    phase("joint", f"rnnt_loss on full logits [{BJ}, {T}, {S + 1}, {C}] fp32 (calc_gradients; grad w.r.t. "
          f"(am, lm) through the joiner am + lm): launches shipped {json.dumps(joint['shipped'][1])} split "
          f"{json.dumps(joint['split'][1])}; split arm {same_j} (loss, occupancies, gradients); loss vs "
          f"rnnt_loss_simple rel err {rel_j:.3e} (tol 1e-4); first call shipped {joint['shipped'][2]:.1f} ms "
          f"split {joint['split'][2]:.1f} ms; peak above the inputs shipped {joint['shipped'][3]:.1f} MiB "
          f"split {joint['split'][3]:.1f} MiB")
    del joint

    # the matmul precision levels of the build kernels, and the per-call
    # routes of the train step
    prec_times, prec_library = precision_phase(am, lm, sym, bnd, counted)
    # bounds at each level: the forward's products in one TF32 or bf16 pass
    # ("high", "default"); the backward's d_am and d_lm products stay 3xTF32
    one_pass = {"high": kernel_bounds(bnd, 1), "default": kernel_bounds(bnd, 1, bf16_ops=True)}
    prec_bounds = {name: {level: (bounds[name] if level == "highest" or "bwd" in name
                                  else one_pass[level][name])[0] for level in LEVELS}
                   for name in prec_times}

    # the transducer model's training step at full width, its convergence
    # and decoding on a copy task, and forced alignment of the headline lattice
    launches_model, model_ms = model_train_phase(dev, t, counted)
    model_converge_phase(dev)
    align = alignment_phase(dev, lm, am, sym, bnd)

    # serving: the causal model at full width streamed, served and timed
    models = serve_models(dev)
    stream_encoder_phase(dev, models, counted)
    run_stats = serve_phase(dev, models, counted)
    serve_beam_phase(dev, models["float32"], counted)
    serve_converge_phase(dev, counted)
    serve_ms = serve_time_phase(dev, models["bf16"], run_stats)
    profiling_phase(dev, am, lm, sym, bnd, (peak_mb, base_mb), models["bf16"], serve_ms)

    # audio in: the host library, serving from audio, two ranks, the example
    data_phase()
    serve_audio_phase(dev, models["bf16"], counted)
    del models
    torch.cuda.empty_cache()
    dp = dp_train_phase(dev, model_ms)
    dt_launches = dtensor_phase(align)
    example_phase()

    # --- 5. where the steps' time goes (measurements) ----------------------
    for name, fn in (("forward", step), ("train", train_step), ("train-bf16", train_step_bf16),
                     ("smoothed-train", smoothed_step), ("smoothed-train-bf16", smoothed_step_bf16),
                     ("recipe-train", recipe_step)):
        prof = profile_step(fn)
        if prof is None:
            raise Failed(f"profile of the {name} step: the profiler saw no device activity")
        rows, busy, _ = prof
        total = sum(r[1] for r in rows)
        in_ranges = [r for r in rows if "ranges_" in r[0]]
        phase("profile", f"{name} step, torch.profiler, 10 steps: device busy {100 * busy:.1f}% "
              f"of the device window; kernel time {total:.1f} us per step; the ranges kernels "
              f"{sum(r[1] for r in in_ranges):.1f} us in {sum(r[2] for r in in_ranges):.1f} launches per step")
        for kname, us, calls in rows:
            print(f"  {us:9.1f} us/step {calls:5.1f} calls/step {100 * us / total:5.1f}%  "
                  f"{kname[:90]}", flush=True)
    for seed in (0, 1):
        if seed:
            am, lm, sym, bnd = t(*make_inputs(seed))
        (med, q1, q3, p90), wall = step_samples(step)
        phase("step-samples", f"seed {seed}: 60 single-step CUDA-event samples, median "
              f"{med:.4f} ms (q1 {q1:.4f}, q3 {q3:.4f}, p90 {p90:.4f}); host wall per step "
              f"with its synchronise, median {wall:.4f} ms")

    # --- 6. results -----------------------------------------------------------
    sources = {
        "wavefront_fwd": ("fast_rnnt_tpu_torch/csrc/wavefront_fused.cu",
                          "fast_rnnt_tpu/ops/kernels/wavefront.py:224"),
        "wavefront_bwd": ("fast_rnnt_tpu_torch/csrc/wavefront_fused.cu",
                          "fast_rnnt_tpu/ops/kernels/wavefront.py:420"),
        "latbuild_fwd": ("fast_rnnt_tpu_torch/csrc/latbuild.cu",
                         "fast_rnnt_tpu/ops/kernels/latbuild.py:207"),
        "ranges": ("fast_rnnt_tpu_torch/csrc/ranges.cu",
                   "fast_rnnt_tpu/ops/kernels/ranges.py:64"),
        "latbuild_bwd": ("fast_rnnt_tpu_torch/csrc/latbuild_bwd.cu",
                         "fast_rnnt_tpu/ops/kernels/latbuild.py:290"),
        "latbuild_fwd_parts": ("fast_rnnt_tpu_torch/csrc/latbuild.cu",
                               "fast_rnnt_tpu/ops/kernels/latbuild.py:836"),
        "latbuild_bwd_parts": ("fast_rnnt_tpu_torch/csrc/latbuild_bwd.cu",
                               "fast_rnnt_tpu/ops/kernels/latbuild.py:920"),
        "wavefront_fused": ("fast_rnnt_tpu_torch/csrc/wavefront_fused.cu",
                            "fast_rnnt_tpu/ops/kernels/wavefront.py:623"),
        # the pruned lattice's kernels replace no Pallas kernel: the JAX
        # package's get_rnnt_logprobs_pruned is jnp
        "pruned_band": ("fast_rnnt_tpu_torch/csrc/pruned_rows.cu", None),
        "pruned_rows": ("fast_rnnt_tpu_torch/csrc/pruned_rows.cu", None),
        "pruned_bwd": ("fast_rnnt_tpu_torch/csrc/pruned_rows.cu", None),
        # nor the attention's: the JAX package's model leaves it to XLA
        "relpos_fwd": ("fast_rnnt_tpu_torch/csrc/relpos_attention.cu", None),
        "relpos_bwd_q": ("fast_rnnt_tpu_torch/csrc/relpos_attention.cu", None),
        "relpos_bwd_kv": ("fast_rnnt_tpu_torch/csrc/relpos_attention.cu", None),
    }
    # each kernel's launches from the first path that runs it
    path_launches = {}
    for counts in (launches, launches_t, launches_s, launches_recipe):
        for k, n in counts.items():
            if n:
                path_launches.setdefault(k, n)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches.get(name, report[name].get("launches")), "max_abs_err": report[name]["err"],
         **({"norm_err": report[name]["norm_err"]} if "norm_err" in report[name] else {}),
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": report[name].get("library_ms"),
         "model_train_launches": launches_model[name],
         "dp_train_launches": dp["gloo"][0]["launches"].get(name, 0),
         "dtensor_launches": {n: c.get(name, 0) for n, c in dt_launches.items()},
         **({"ms_by_precision": prec_times[name], "bound_ms_by_precision": prec_bounds[name]}
            if name in prec_times else {}),
         **({"library_ms_by_precision": prec_library[name]} if name in prec_library else {})}
        for name, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dp-worker"]:  # one rank of dp_train_phase
            sys.path.insert(0, HERE)
            dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
            sys.exit(0)
        if sys.argv[1:2] == ["--relpos-worker"]:  # relpos_attention_phase's process
            sys.path.insert(0, HERE)
            relpos_worker(sys.argv[2])
            sys.exit(0)
        if sys.argv[1:2] == ["--dtensor-worker"]:  # one rank of dtensor_phase
            sys.path.insert(0, HERE)
            dtensor_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
            sys.exit(0)
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
