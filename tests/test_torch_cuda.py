"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU (the kernels have no CPU or interpret mode) and
skip without one; run them there with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: tests/conftest.py sets JAX up, and the GPU machine
needs no JAX).
chip_smoke.py compares every kernel with its plain version at small
ragged shapes and at the headline shape, and drives the main path; the
cases here are the ones it does not cover: random shapes, very long
utterances (the sweep kernels at T = 12000 and 20000), the sweep kernels
over several strips, at S = 0 and banded, out-of-range symbols, the storage
dtypes at random shapes, float16 lm and am, the CUDA dtype, size and
gradient rules, the recursion's launches in the recipe, and the
forward-only build's memory; the smoothed build on bf16 lm and am; the
pruning-window kernels on edge and long shapes, in every storage dtype;
the transducer model's loss (its six kernel launches, against the same
model on the CPU), its decoders and the forced alignment on the card;
streaming and ``StreamServer`` on the card at the tiny causal width; the
route switches and the parity gate at a small shape; the pruned lattice's
kernels (px, py and d_logits in every dtype and RNN-T type, on edge shapes
and at the recipe's shape, and the rows handed to the recursion)."""

import numpy as np
import pytest
import torch

import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu_torch.ops.kernels import latbuild, pruned, ranges, wavefront
from fast_rnnt_tpu_torch.ops.pruning import _window_scores, adjust_pruning_lower_bound
from fast_rnnt_tpu_torch.utils import from_numpy

from ._torch_parity import (
    RANGES_EDGES,
    STREAM_TINY,
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    assert_ranges_match,
    band,
    loss_inputs,
    occupancies,
    pad_utts,
    pruned_inputs,
    ranges_boundary,
    ranges_edge_id,
    rows_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_latbuild_kernel_out_of_range_symbols(dev, rnnt_type):
    """A symbol outside [0, C) reads am = lm = 0, as in the plain build and
    the JAX package's one-hot gathers, and never reads outside its row
    (the last utterance's last symbol sits at the end of am)."""
    am, lm, sym, bnd = loss_inputs(3, B=3, T=70, S=9, C=33)
    sym[0, 0], sym[1, 4], sym[2, 8] = -1, 33, 10**6
    am, lm, sym, bnd = from_numpy(am, lm, sym, bnd, device=dev)
    a = latbuild.lattice_rows(lm, am, sym, 0, rnnt_type, bnd)
    base = "modified" if rnnt_type == "constrained" else rnnt_type
    px, py = latbuild.lattice_rows_plain(lm, am, sym, 0, base, bnd)
    if rnnt_type == "constrained":
        px = px + py[1:]
    assert_lattice_close(a[0], px)
    assert_lattice_close(a[1], py)


def test_dtype_policy_and_build_gradient_on_cuda(dev):
    """float64 on the card raises; the training step's gradient runs the
    build's backward kernel and matches autograd of the plain route on the
    same card."""
    px, py, bnd = from_numpy(*rows_inputs(6, B=2, S=3, T=8), device=dev)
    with pytest.raises(TypeError):
        ft.mutual_information_rows(px.double(), py.double(), bnd)
    am, lm, sym, b = from_numpy(*loss_inputs(7, B=2, T=8, S=3, C=6), device=dev)
    grads = []
    for route in ("kernel", "plain"):
        am_l, lm_l = am.clone().requires_grad_(), lm.clone().requires_grad_()
        if route == "kernel":
            before = latbuild.LAUNCHES["bwd"]
            s, p, r = ft.rnnt_loss_simple_pruned(lm_l, am_l, sym, 0, 2, b)
            (0.5 * s + p).backward()
            assert latbuild.LAUNCHES["bwd"] == before + 1
        else:  # the plain build on the card, the same recursion kernels and ranges
            px_l, py_l = (x.contiguous() for x in latbuild.lattice_rows_plain(lm_l, am_l, sym, 0, "regular", b))
            bn = b.contiguous()
            s = -ft.mutual_information_rows(px_l, py_l, bn, calc_gradients=True)[0].mean()
            p = -ft.mutual_information_rows(px_l, py_l, bn, lo=r[:, :, 0], s_range=2).mean()
            (0.5 * s + p).backward()
        grads.append((am_l.grad, lm_l.grad))
    for a, w in zip(*grads):
        assert_close(a, w, 1e-5, 1e-4)


def _build_grad_case(dev, rng, B, S, T, C, modified, seed):
    """Random build inputs and cotangents, drawn on the card from a
    generator seeded with ``seed`` (the blank from ``rng``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lm = torch.randn(B, S + 1, C, device=dev, generator=g)
    am = torch.randn(B, T, C, device=dev, generator=g) * 3
    sym = torch.randint(-1, C + 1, (B, S), device=dev, dtype=torch.int32, generator=g)  # some out of range
    blank = int(rng.integers(-C, C))
    te = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if not modified:
        te = torch.randint(0, T + 1, (B,), device=dev, dtype=torch.int32, generator=g)
    dpx = torch.randn(S, B, T if modified else T + 1, device=dev, generator=g)
    dpy = torch.randn(S + 1, B, T, device=dev, generator=g)
    return lm, am, sym, blank, te, dpx, dpy


def _smoothed_extras(dev, S, B, T, C, seed, floor=0.0):
    """The smoothed build's unigram row (a softmax, + ``floor``) and its
    cotangent dnd, drawn from a generator seeded with ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    uni = torch.softmax(torch.randn(C, device=dev, generator=g), 0) + floor
    return uni, torch.randn(S + 1, B, T, device=dev, generator=g)


def _assert_grads(got, want, case=""):
    for g, w, n in zip(got, want, ("d_lm", "d_am", "d_uni")):
        if w is not None:
            tol = 1e-4 * max(float(w.abs().max()), 1e-30)  # chip_smoke's GRAD_TOL
            err = float((g - w).abs().max())
            assert err <= tol, f"{case}: {n} max abs err {err:.3e} > {tol:.3e}"


def _assert_bf16_contract(got, want, case=""):
    """The bf16 build backward's (d_lm, d_am) against the plain VJP on the
    same bf16 exps (float32): 1e-5 of max, an output in bf16 plus one bf16
    step of each element (chip_smoke's BF16_CONTRACT_TOL)."""
    for g, w, n in zip(got[:2], want[:2], ("d_lm", "d_am")):
        step = 2.0**-7 if g.dtype == torch.bfloat16 else 0.0
        excess = float(((g.double() - w.double()).abs() - step * w.double().abs()).max())
        tol = 1e-5 * max(float(w.abs().max()), 1e-30)
        assert excess <= tol, f"{case}: {n} excess {excess:.3e} > {tol:.3e}"


def _smoothed_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, case, level=None):
    """The smoothed build backward, kernel and plain version, the plain one
    on the forward's full residuals (D and duni, as the kernels take them)
    at matmul precision ``level`` (None: the current one): d_uni's weight
    rd must be the same bits on both sides.  Returns their (d_lm, d_am,
    d_uni)."""
    from fast_rnnt_tpu_torch.ops.lattice import _PREC_CODE

    prec = None if level is None else _PREC_CODE[level]
    got = latbuild.build_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, prec, return_rd=True)
    want = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, modified, uni, dnd, res[0],
                                           prec=level, duni=res[2], return_rd=True)
    n = int((got[3].view(torch.int32) != want[3].view(torch.int32)).sum())
    assert n == 0, f"{case}: rd differs from the plain version's in {n} of {want[3].numel()}"
    return got[:3], want[:3]


@pytest.mark.parametrize("seed", range(8))
def test_build_backward_kernels_match_plain_on_random_shapes(dev, seed):
    """The build backward, plain and smoothed, at random shapes: S = 0,
    C not a multiple of the 128-column d_am tile, T beyond a 64-frame prep
    block,
    random t_end, random (also negative) blanks, out-of-range symbols."""
    rng = np.random.default_rng(200 + seed)
    B, S, T = int(rng.integers(1, 5)), int(rng.integers(0, 70)), int(rng.integers(1, 700))
    C, modified = int(rng.integers(2, 140)), bool(rng.integers(2))
    case = f"seed {200 + seed}: B={B} S={S} T={T} C={C} modified={modified}"
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, modified, 200 + seed)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, save=True)
    _assert_grads(latbuild.build_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy),
                  latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, modified), case)
    uni, dnd = _smoothed_extras(dev, S, B, T, C, 1200 + seed)
    *out, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, uni, save=True)
    for a, b in zip(out, latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, blank, modified)):
        assert_close(a, b, 1e-4, 1e-5, case)
    _assert_grads(*_smoothed_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, case), case)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_build_matches_plain_on_random_shapes(dev, seed):
    """bf16 lm and am at random shapes (odd C included: the am rows are then
    no 16-byte multiples and the kernels stage them another way): px and py
    against the plain bf16 build to 1e-4 + 1e-5|x| (the exps rounded alike,
    their products exact in float32); the backward kernel's float32 d_lm
    and the bf16 gradients of the autograd route against the plain VJP."""
    rng = np.random.default_rng(300 + seed)
    B, S, T = int(rng.integers(1, 5)), int(rng.integers(0, 70)), int(rng.integers(1, 700))
    C, modified = int(rng.integers(2, 140)), bool(rng.integers(2))
    case = f"seed {300 + seed}: B={B} S={S} T={T} C={C} modified={modified}"
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, modified, 300 + seed)
    lm, am = lm.bfloat16(), am.bfloat16()
    rt = "modified" if modified else "regular"
    zero = torch.zeros_like(te)
    bnd = torch.stack([zero, zero, torch.full_like(te, S), te.clamp(min=0)], 1)
    for a, b in zip(latbuild.lattice_rows(lm, am, sym, blank, rt, bnd),
                    latbuild.lattice_rows_plain(lm, am, sym, blank, rt, bnd)):
        assert a.dtype == torch.float32
        assert_close(a, b, 1e-4, 1e-5, case)
    want = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, modified)
    lm_l, am_l = lm.clone().requires_grad_(), am.clone().requires_grad_()
    got = torch.autograd.grad(latbuild.lattice_rows(lm_l, am_l, sym, blank, rt, bnd), [lm_l, am_l], [dpx, dpy])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    _assert_bf16_contract(got, want, case)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, save=True)
    got = latbuild.build_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy)
    assert got[0].dtype == torch.float32
    _assert_bf16_contract(got, want, case)


def test_build_backward_kernel_long_utterance(dev):
    """T = 12000: the d_lm GEMM walks all frames in-block (750 K steps) and
    sums 376 row-sum partials."""
    rng = np.random.default_rng(9)
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, 2, 12, 12000, 37, False, 9)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, False, save=True)
    _assert_grads(latbuild.build_bwd(lm, am, sym, te, blank, False, res, dpx, dpy),
                  latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, False), "seed 9")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_kernels_wide_vocabulary_and_many_symbols(dev, dtype):
    """C = 2100: the forward's 64-frame am tile no longer fits in shared
    memory, so its fragments and gathers read device memory; S = 150: the
    rows s span two 128-row N tiles in the forward (the residuals written
    by the first) and in the d_lm product.  px and py to 1e-4 + 1e-5|x|,
    the gradients (through the residuals) against the plain VJP as at the
    smaller shapes; float32 also the smoothed build."""
    rng = np.random.default_rng(41)
    B, S, T, C = 2, 150, 130, 2100
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, False, 41)
    lm, am = lm.to(dtype), am.to(dtype)
    zero = torch.zeros_like(te)
    bnd = torch.stack([zero, zero, torch.full_like(te, S), te], 1)
    for a, b in zip(latbuild.lattice_rows(lm, am, sym, blank, "regular", bnd),
                    latbuild.lattice_rows_plain(lm, am, sym, blank, "regular", bnd)):
        assert_close(a, b, 1e-4, 1e-5)
    lm_l, am_l = lm.clone().requires_grad_(), am.clone().requires_grad_()
    got = torch.autograd.grad(latbuild.lattice_rows(lm_l, am_l, sym, blank, "regular", bnd), [lm_l, am_l],
                              [dpx, dpy])
    assert got[0].dtype == dtype and got[1].dtype == dtype
    want = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, False)
    (_assert_grads if dtype == torch.float32 else _assert_bf16_contract)(got, want, "seed 41")
    if dtype == torch.float32:
        uni, dnd = _smoothed_extras(dev, S, B, T, C, 1041)
        *out, res = latbuild.build_fwd(lm, am, sym, te, blank, False, uni, save=True)
        for a, b in zip(out, latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, blank, False)):
            assert_close(a, b, 1e-4, 1e-5, "seed 41")
        _assert_grads(*_smoothed_bwd(lm, am, sym, te, blank, False, res, dpx, dpy, uni, dnd, "seed 41"),
                      "seed 41")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_backward_many_symbols(dev, dtype):
    """S = 2000 (any S runs): the prep forms w in passes of 256 rows s, and
    with C = 5 more symbols fall in the one d_am block than its list of
    1,024 holds (it walks the rest).  The gradients against the plain VJP:
    float32 to 1e-4 of max, bf16 to its float32 contract; float32 also the
    smoothed build, whose extra row S+1 falls in the last pass."""
    rng = np.random.default_rng(43)
    B, S, T, C = 2, 2000, 70, 5
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, False, 43)
    lm, am = lm.to(dtype), am.to(dtype)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, False, save=True)
    got = latbuild.build_bwd(lm, am, sym, te, blank, False, res, dpx, dpy)
    want = latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, blank, False)
    if dtype == torch.bfloat16:
        _assert_bf16_contract(got, want, "seed 43")
        return
    _assert_grads(got, want, "seed 43")
    uni, dnd = _smoothed_extras(dev, S, B, T, C, 1043)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, False, uni, save=True)
    _assert_grads(*_smoothed_bwd(lm, am, sym, te, blank, False, res, dpx, dpy, uni, dnd, "seed 43"), "seed 43")


def test_forward_only_build_launches_no_backward_and_keeps_no_residual(dev):
    """Without a gradient the build writes no D: the forward-only loss
    allocates exactly what it did with the residuals switched off, and no
    backward kernel runs."""
    am, lm, sym, b = from_numpy(*loss_inputs(8, B=3, T=300, S=20, C=64), device=dev)
    before = dict(latbuild.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    px, py = latbuild.lattice_rows(lm, am, sym, 0, "regular", b)
    peak_fwd = torch.cuda.max_memory_allocated() - base
    del px, py
    torch.cuda.reset_peak_memory_stats()
    te = b[:, 3].contiguous()
    out = latbuild.build_fwd(lm, am, sym, te, 0, False, save=True)
    peak_res = torch.cuda.max_memory_allocated() - base
    d_bytes = out[3][0].numel() * 4 + out[3][1].numel() * 4
    assert peak_res - peak_fwd >= d_bytes  # the residuals are what training adds
    ft.rnnt_loss_simple_pruned(lm, am, sym, 0, 3, b)
    assert latbuild.LAUNCHES["bwd"] == before["bwd"]
    assert latbuild.LAUNCHES["fwd"] == before["fwd"] + 3  # two builds here, one in the loss


@pytest.mark.parametrize("seed", range(12))
def test_kernels_match_plain_on_random_shapes(dev, seed):
    """Random ragged shapes: T up to 2200, S = 0 and 1, width-1 and
    full-width bands, one-utterance batches."""
    rng = np.random.default_rng(100 + seed)
    B, S, T = int(rng.integers(1, 6)), int(rng.integers(0, 13)), int(rng.integers(1, 2200))
    modified, offset = bool(rng.integers(2)), bool(rng.integers(2))
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=offset)
    K = int(rng.integers(1, S + 2)) if rng.integers(2) else 0
    lo = band(seed, B, S, T, K) if K else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd, lo, K)
    g = torch.Generator(device=dev).manual_seed(100 + seed)
    ag = torch.randn(B, device=dev, generator=g)
    p_k, s_k = wavefront.forward_rows(px, py, bnd, lo, K)
    assert_loss_close(s_k, s_p)
    assert_close(p_k, p_p, 1e-4, 1e-5)
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ag, lo, K),
                    wavefront.backward_rows_plain(px, py, p_k, bnd, ag, lo, K)):
        assert_close(a, b, 1e-5, 1e-4)
    if S >= 1 and not K:
        gx, gy = wavefront.backward_rows(px, py, p_k, bnd, torch.ones(B, device=dev))
        Kr = int(rng.integers(1 if modified else 2, S + 2)) if S >= 1 else 1
        step = 2 if modified else Kr
        assert_ranges_match(
            ranges.window_starts(gy, gx, Kr, bnd, step),
            ranges.window_starts_plain(gy, gx, Kr, bnd, step),
            _window_scores(gx, gy, Kr),
        )
    C = int(rng.integers(2, 70))
    lm = torch.randn(B, S + 1, C, device=dev, generator=g)
    am = torch.randn(B, T, C, device=dev, generator=g) * 3
    sym = torch.randint(0, C, (B, S), device=dev, dtype=torch.int32, generator=g)
    rt = "modified" if modified else "regular"
    blank = int(rng.integers(C))
    px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, blank, rt, bnd)
    for a, b in zip(latbuild.lattice_rows(lm, am, sym, blank, rt, bnd), (px_p, py_p)):
        assert_close(a, b, 1e-4, 1e-5)
    if modified:
        px_c, _ = latbuild.lattice_rows(lm, am, sym, blank, "constrained", bnd)
        assert_close(px_c, px_p + py_p[1:], 1e-4, 1e-5)


@pytest.mark.parametrize("modified", [False, True])
def test_wavefront_kernels_long_utterance(dev, modified):
    """T = 12000 (the ROADMAP's longest scaling shape): the sweep pair over
    12,013 diagonals."""
    px, py, bnd = from_numpy(*rows_inputs(9, B=2, S=12, T=12000, modified=modified), device=dev)
    p_k, s_k = wavefront.forward_rows(px, py, bnd)
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd)
    assert_loss_close(s_k, s_p)
    ones = torch.ones(2, device=dev)
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ones),
                    wavefront.backward_rows_plain(px, py, p_k, bnd, ones)):
        assert_close(a, b, 1e-5, 1e-3)


@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("modified", [False, True])
def test_sweep_pair_at_20000_frames(dev, modified, banded):
    """T = 20000, past any row kept in shared memory: the sweep pair against the
    plain version run in float64 (scores 1e-4 + 1e-5|x|; occupancies at
    3e-3, the long-utterance bound of the fused kernel's test), with seeds
    that hold 0 and a negative value.  p, in every cell: float32 round-off
    accumulates along a 20,000-step path, so its error is on the scale of
    the largest |p| wherever the cell's own value lies (the float32 plain p
    is 9e-4 from the kernel's beside |p| ~ 1.2e3 on an H100, at values
    near 0): held to 1e-5 of max |p| + 1e-5|x|."""
    px, py, bnd = rows_inputs(13, B=3, S=12, T=20000, modified=modified, offset=True)
    K = 3 if banded else 0
    lo = band(14, 3, 12, 20000, K) if banded else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    ag = torch.tensor([0.0, -1.5, 2.0], device=dev)
    p_k, s_k = wavefront.forward_rows(px, py, bnd, lo, K)
    p_p, s_p = wavefront.forward_rows_plain(px.double(), py.double(), bnd, lo, K)
    assert_loss_close(s_k, s_p)
    assert_close(p_k, p_p, 1e-5 * p_p[torch.isfinite(p_p)].abs().max().item(), 1e-5)
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ag, lo, K),
                    wavefront.backward_rows_plain(px.double(), py.double(), p_p, bnd, ag.double(), lo, K)):
        assert_close(a, b, 1e-5, 3e-3)


@pytest.mark.parametrize("modified", [False, True])
def test_fused_kernel_long_utterance(dev, modified):
    """T = 12000: the fused kernel sweeps 12,013 diagonals in one strip, its
    p scratch (15 rows of 12001 floats per utterance) round-trips through
    L2.  Its scores agree with the split pair's, and its occupancies with
    its plain version's in float32 and in float64 to the long-utterance
    bound.  (A float32 recursion's occupancies are 1.4e-3 from the float64
    ones here, an H100 reading in PERF.md: float32 round-off, so the
    occupancies are held to float64, not to a float32 pair.)"""
    px, py, bnd = from_numpy(*rows_inputs(10, B=2, S=12, T=12000, modified=modified), device=dev)
    sc, gx, gy = wavefront.fused_rows(px, py, bnd)
    p_k, s_k = wavefront.forward_rows(px, py, bnd)
    assert_loss_close(sc, s_k)
    for want in (wavefront.fused_rows_plain(px, py, bnd),
                 wavefront.fused_rows_plain(px.double(), py.double(), bnd)):
        assert_loss_close(sc, want[0])
        assert_close(gx, want[1], 1e-5, 1e-3)
        assert_close(gy, want[2], 1e-5, 1e-3)


# (S, T, modified, band width K or 0, storage dtype): several 128-row strips
# (S + 1 = 129, S = 300), S = 0, T past the split pair's shared-memory cap
# (20000), bf16 / f16 storage, bands over several strips
FUSED_CASES = [
    (128, 150, False, 0, torch.float32),
    (128, 150, True, 0, torch.float32),
    (300, 90, False, 0, torch.float32),
    (300, 90, True, 5, torch.float32),
    (0, 70, False, 0, torch.float32),
    (0, 70, True, 0, torch.bfloat16),
    (12, 20000, False, 0, torch.float32),
    (12, 20000, True, 3, torch.float32),
    (200, 120, False, 4, torch.bfloat16),
    (140, 100, True, 0, torch.float16),
    (9, 300, False, 3, torch.float16),
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=[f"S{c[0]}-T{c[1]}-{'mod' if c[2] else 'reg'}-K{c[3]}-"
                                                   f"{str(c[4])[6:]}" for c in FUSED_CASES])
def test_fused_kernel_diagonal_sweep_matches_plain(dev, case):
    """The diagonal sweep against its plain version (scores 1e-4 + 1e-5|x|,
    occupancies 1e-5 + (1e-3 + one storage step)|x|), with non-zero begins,
    ragged ends and zeros outside each rectangle; and the same bits on a
    second run (no atomics); and the forward and backward launched apart,
    seeded with ones, give the same bits.  At T = 20000, where |p| reaches ~4e4 and a
    float32 step is 4e-3, the float32 plain version's own occupancies are
    1.7e-3 from float64 ones (PERF.md): there the kernel is held to the
    plain version run in float64, at 3e-3."""
    from ._torch_parity import storage_rtol

    S, T, modified, K, dtype = case
    px, py, bnd = rows_inputs(500 + S + T, B=3, S=S, T=T, modified=modified, offset=True)
    bnd[0, 2] = S  # one utterance of every row
    lo = band(501 + S, 3, S, T, K) if K else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    px, py = px.to(dtype), py.to(dtype)
    out = wavefront.fused_rows(px, py, bnd, lo, K)
    long = T > 12000
    want = wavefront.fused_rows_plain(*((px.double(), py.double()) if long else (px, py)), bnd, lo, K)
    assert out[1].dtype == dtype and out[2].dtype == dtype
    assert_loss_close(out[0], want[0])
    rtol = 3e-3 if long else 1e-3 + storage_rtol(dtype)
    for a, b in zip(out[1:], want[1:]):
        assert_close(a, b, 1e-5, rtol)
    again = wavefront.fused_rows(px, py, bnd, lo, K)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    p_k, s_k = wavefront.forward_rows(px, py, bnd, lo, K)
    pair = (s_k, *wavefront.backward_rows(px, py, p_k, bnd, torch.ones_like(s_k), lo, K))
    assert all(torch.equal(a, b) for a, b in zip(out, pair))


# (S, T) of the strip-schedule cases: one 128-row strip (S = 0, 127), the
# first lattices of two (S = 128: a one-row top strip; 129), 6, 10 and 21
# strips; T from one column to the long-form cells' 12000
STRIP_S = [0, 127, 128, 129, 640, 1200, 2600]
STRIP_T = [1, 16, 6000, 12000]


def _strip_case(dev, S, T):
    """Four utterances: one over the whole lattice; one ragged, with
    non-zero begins, whose top strips are empty; one with s_end 0; one with
    t_end = t_begin.  Regular or modified, banded or not and the storage
    dtype go round with the case."""
    i = STRIP_S.index(S) * len(STRIP_T) + STRIP_T.index(T)
    modified, K = bool(i % 2), (min(5, S + 1) if i // 2 % 2 else 0)
    dtype = (torch.float32, torch.bfloat16, torch.float16)[i % 3]
    px, py, bnd = rows_inputs(700 + i, B=4, S=S, T=T, modified=modified)
    bnd[0] = (0, 0, S, T)
    bnd[1] = (S // 10, T // 5, S // 10 + S // 3, max(T // 5, T - T // 4))
    bnd[2] = (0, 0, 0, T)
    bnd[3] = (S // 4, T // 2, S, T // 2)
    lo = band(701 + i, 4, S, T, K) if K else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    return px.to(dtype), py.to(dtype), bnd, lo, K, modified


def _sweeps(px, py, bnd, lo, K, ag):
    """p and the scores of the forward alone, the occupancies of the
    backward alone seeded with ``ag``, and the fused launch's outputs."""
    p, sc = wavefront.forward_rows(px, py, bnd, lo, K)
    return (p, sc, *wavefront.backward_rows(px, py, p, bnd, ag, lo, K),
            *wavefront.fused_rows(px, py, bnd, lo, K))


@pytest.mark.parametrize("T", STRIP_T)
@pytest.mark.parametrize("S", STRIP_S)
def test_strips_at_once_equal_strip_after_strip(dev, monkeypatch, S, T):
    """Every sweep launch over all of an utterance's strips at once gives
    the bits of the same launch sweeping them one after another (one block
    an utterance, as past the resident blocks), again on a second run; the
    forward and backward apart, seeded with ones, give the fused launch's
    bits; B x strips blocks are counted a launch.  Against the plain
    version at the file's tolerances: T <= 16 in float32 (scores 1e-4 +
    1e-5|x|, p 1e-4 + 1e-5|x|, occupancies 1e-5 + (1e-3 + one storage
    step)|x|); T >= 6000 at one or two strips the scores and p, against
    float64 (p 1e-5 of max |p| + 1e-5|x|): the file holds long occupancies
    to 3e-3 at 12 rows, and at 127 rows x 6000 columns the float32
    recursion's own round-off reaches 8.7e-3 of a 0.002 occupancy in one
    strip, the schedule unchanged (an H100 reading); past that, 6 to 21
    strips over 6000 columns, and every long occupancy, are held to the
    strip-serial bits."""
    from ._torch_parity import storage_rtol

    px, py, bnd, lo, K, _ = _strip_case(dev, S, T)
    ag = torch.tensor([1.0, -0.5, 2.0, 0.0], device=dev)
    nk = wavefront._strips(S)
    before = wavefront.BLOCKS["sweep"]
    at_once = _sweeps(px, py, bnd, lo, K, ag)
    assert wavefront.BLOCKS["sweep"] - before == 3 * 4 * nk
    names = ("p", "scores", "bwd px_grad", "bwd py_grad", "fused scores", "fused px_grad",
             "fused py_grad")
    for what, other in (("a second run", _sweeps(px, py, bnd, lo, K, ag)),
                        ("strip after strip", None)):
        if other is None:
            monkeypatch.setattr(wavefront, "_resident", lambda d: 1)
            other = _sweeps(px, py, bnd, lo, K, ag)
            monkeypatch.undo()
        for a, b, name in zip(at_once, other, names):
            assert torch.equal(a, b), f"{what}: {name}"
    p, sc = at_once[:2]
    pair = (sc, *wavefront.backward_rows(px, py, p, bnd, torch.ones_like(sc), lo, K))
    assert all(torch.equal(a, b) for a, b in zip(pair, at_once[4:])), "fused vs apart"
    if T > 16 and nk > 2:
        return
    if T > 16:
        p_p, s_p = wavefront.forward_rows_plain(px.double(), py.double(), bnd, lo, K)
        assert_loss_close(sc, s_p)
        assert_close(p, p_p, 1e-5 * p_p[torch.isfinite(p_p)].abs().max().item(), 1e-5)
        return
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd, lo, K)
    assert_loss_close(sc, s_p)
    assert_close(p, p_p, 1e-4, 1e-5)
    rtol = 1e-3 + storage_rtol(px.dtype)
    for a, b in zip(at_once[2:4], wavefront.backward_rows_plain(px, py, p, bnd, ag, lo, K)):
        assert_close(a, b, 1e-5, rtol)
    want = wavefront.fused_rows_plain(px, py, bnd, lo, K)
    assert_loss_close(at_once[4], want[0])
    for a, b in zip(at_once[5:], want[1:]):
        assert_close(a, b, 1e-5, rtol)


def test_strips_at_once_cannot_hang_past_the_resident_blocks(dev):
    """B = 32 at S = 1200: 320 blocks a launch, over twice the blocks an H100
    holds at once, so most blocks start only after others end.  Run in a
    process of its own under a time limit, so that a launch whose blocks
    wait on a block that cannot start fails here instead of hanging the
    suite; its bits equal the strip-serial schedule's."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent("""
        import torch
        from fast_rnnt_tpu_torch.ops.kernels import wavefront
        from fast_rnnt_tpu_torch.utils import from_numpy
        from tests._torch_parity import band, rows_inputs

        dev = torch.device("cuda", 0)
        px, py, bnd = rows_inputs(800, B=32, S=1200, T=900, offset=True)
        bnd[::3, 0], bnd[::3, 2] = 0, 1200
        lo = band(801, 32, 1200, 900, 5)
        px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
        ag = torch.linspace(-1.0, 2.0, 32, device=dev)

        def sweeps(lo, K):
            p, sc = wavefront.forward_rows(px, py, bnd, lo, K)
            return (p, sc, *wavefront.backward_rows(px, py, p, bnd, ag, lo, K),
                    *wavefront.fused_rows(px, py, bnd, lo, K))

        resident = wavefront._resident(dev)
        assert 32 * wavefront._strips_at_once(1200, resident) > 2 * resident, resident
        at_once = [sweeps(None, 0), sweeps(lo, 5)]
        torch.cuda.synchronize()
        wavefront._resident = lambda d: 1
        serial = [sweeps(None, 0), sweeps(lo, 5)]
        for a, b in zip(at_once, serial):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        print("resident", resident)
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resident" in res.stdout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("seed", range(3))
def test_storage_dtypes_match_plain_on_random_shapes(dev, seed, dtype):
    """bf16 / f16 storage in the split and fused kernels at random ragged
    shapes: float32 p and scores, occupancies in the storage dtype within
    one storage step of the plain version's."""
    from ._torch_parity import storage_rtol

    rng = np.random.default_rng(300 + seed)
    B, S, T = int(rng.integers(1, 6)), int(rng.integers(0, 13)), int(rng.integers(1, 2200))
    modified = bool(rng.integers(2))
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=True)
    K = int(rng.integers(1, S + 2)) if rng.integers(2) else 0
    lo = band(seed, B, S, T, K) if K else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    px, py = px.to(dtype), py.to(dtype)
    rtol = 1e-4 + storage_rtol(dtype)
    p_k, s_k = wavefront.forward_rows(px, py, bnd, lo, K)
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd, lo, K)
    assert p_k.dtype == torch.float32 and s_k.dtype == torch.float32
    assert_loss_close(s_k, s_p)
    assert_close(p_k, p_p, 1e-4, 1e-5)
    ag = torch.rand(B, device=dev, generator=torch.Generator(device=dev).manual_seed(300 + seed)) + 0.5
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ag, lo, K),
                    wavefront.backward_rows_plain(px, py, p_k, bnd, ag, lo, K)):
        assert a.dtype == dtype
        assert_close(a, b, 1e-5, rtol)
    # the fused plain version runs its own forward, whose p differs from the
    # kernel's in the last bits: the long-utterance bound, 1e-3
    out = wavefront.fused_rows(px, py, bnd, lo, K)
    for a, b in zip(out, wavefront.fused_rows_plain(px, py, bnd, lo, K)):
        assert_close(a, b, 1e-4, 1e-3 + storage_rtol(dtype))


def test_recursion_dtype_and_size_rules_on_cuda(dev):
    """float64 and mixed px/py dtypes raise TypeError in every recursion
    wrapper, with no fallback; at T = 15000 the sweep kernels, which keep
    no row in shared memory, run."""
    px, py, bnd = from_numpy(*rows_inputs(11, B=2, S=3, T=8), device=dev)
    p, _ = wavefront.forward_rows(px, py, bnd)
    ones = torch.ones(2, device=dev)
    for x, y in ((px.double(), py.double()), (px, py.bfloat16()), (px.half(), py.bfloat16())):
        for fwd in (wavefront.forward_rows, wavefront.fused_rows):
            with pytest.raises(TypeError):
                fwd(x, y, bnd)
        with pytest.raises(TypeError):
            wavefront.backward_rows(x, y, p, bnd, ones)
    px, py, bnd = from_numpy(*rows_inputs(12, B=1, S=2, T=15000), device=dev)
    p, sc = wavefront.forward_rows(px, py, bnd)
    assert torch.isfinite(sc).all()
    assert all(torch.isfinite(g).all() for g in wavefront.backward_rows(px, py, p, bnd, torch.ones(1, device=dev)))
    assert torch.isfinite(wavefront.fused_rows(px, py, bnd)[0]).all()


def test_recipe_launches_the_fused_kernel_and_the_pair(dev):
    """The recipe's stage 1 launches the fused kernel once and stage 2 the
    sweep pair, the forward phase and, for the gradient, the backward
    phase, once each."""
    am, lm, sym, b = from_numpy(*loss_inputs(13, B=3, T=60, S=8, C=16), device=dev)
    am, lm = am.requires_grad_(), lm.requires_grad_()
    before = dict(wavefront.LAUNCHES)
    s, (gx, gy) = ft.rnnt_loss_simple(lm, am, sym, 0, b, reduction="sum", calc_gradients=True)
    r = ft.get_rnnt_prune_ranges(gx, gy, b, 3)
    am_p, lm_p = ft.do_rnnt_pruning(am, lm, r)
    loss = 0.5 * s + ft.rnnt_loss_pruned(am_p + lm_p, sym, r, 0, b, reduction="sum")
    grads = torch.autograd.grad(loss, (am, lm))
    assert {k: wavefront.LAUNCHES[k] - before[k] for k in before} == {"fwd": 1, "bwd": 1, "fused": 1}
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)


def test_rnnt_loss_bf16_logits_on_cuda(dev):
    """bf16 full logits give a float32 px and a bf16 py: the recursion
    stores both in float32 on the card, as on the CPU, with no TypeError."""
    am, lm, sym, b = loss_inputs(14, B=2, T=30, S=5, C=12)
    logits = torch.tensor(np.tanh(am[:, :, None, :] + lm[:, None, :, :]), dtype=torch.bfloat16)
    sym_d, b_d = from_numpy(sym, b, device=dev)
    got = ft.rnnt_loss(logits.to(dev), sym_d, 0, b_d, reduction="none")
    sym_c, b_c = from_numpy(sym, b, device="cpu")
    want = ft.rnnt_loss(logits, sym_c, 0, b_c, reduction="none")
    assert_loss_close(got.cpu(), want)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_f16_lm_am_train_through_the_build_kernels(dev, rnnt_type):
    """float16 lm and am: the build kernels run on their float32 casts (one
    forward and one backward launch, the smoothed build's too), and the
    loss of 0.5 * simple + pruned agrees with the plain route's on the same
    float16 inputs to relative 1e-4 (each utterance whose ranges agree),
    the float16 gradients to 2^-8 of max (a few float16 steps)."""
    am, lm, sym, b = loss_inputs(15, B=3, T=60, S=8, C=16)
    out = {}
    for where in ("card", "plain"):
        d = dev if where == "card" else torch.device("cpu")
        am_t, lm_t, sym_t, b_t = from_numpy(am, lm, sym, b, device=d)
        am_t, lm_t = am_t.half().requires_grad_(), lm_t.half().requires_grad_()
        before = dict(latbuild.LAUNCHES)
        s, p, r = ft.rnnt_loss_simple_pruned(lm_t, am_t, sym_t, 0, 3, b_t, rnnt_type=rnnt_type,
                                             reduction="none")
        loss = 0.5 * s + p
        g = torch.autograd.grad(loss.sum(), (am_t, lm_t))
        sm = ft.rnnt_loss_smoothed(lm_t.detach(), am_t.detach(), sym_t, 0, 0.2, 0.1, b_t, rnnt_type,
                                   reduction="none")
        n = {k: latbuild.LAUNCHES[k] - before[k] for k in before}
        out[where] = [x.detach().cpu() for x in (loss, sm, r, *g)], n
    (loss, sm, r, *g), n = out["card"]
    (loss_p, sm_p, r_p, *g_p), _ = out["plain"]
    assert n == {"fwd": 1, "bwd": 1, "fwd_parts": 1, "bwd_parts": 0}
    assert g[0].dtype == torch.float16 and g[1].dtype == torch.float16
    agree = (r == r_p).flatten(1).all(1)
    assert agree.any()
    np.testing.assert_allclose(loss[agree].numpy(), loss_p[agree].numpy(), rtol=1e-4)
    np.testing.assert_allclose(sm.numpy(), sm_p.numpy(), rtol=1e-4)
    if agree.all():
        for a, w in zip(g, g_p):
            assert (a.float() - w.float()).abs().max() <= 2.0**-8 * w.float().abs().max()


@pytest.mark.parametrize("seed", range(16))
def test_bf16_smoothed_build_matches_plain_on_random_shapes(dev, seed):
    """The smoothed build kernels on bf16 lm and am at random shapes (odd C
    included) against their plain versions, which round where the Pallas
    smoothed build rounds: px, py and normd to 1e-4 + 1e-5|x|; the backward
    (d_lm float32, d_am bf16, d_uni float32) and the autograd route's bf16
    gradients to the bf16 contract, 1e-5 of max (d_am plus one bf16 step),
    the plain backward on the forward kernel's residuals D and duni: w =
    dnorm / D and d_uni's weight rd are rounded to bf16, so both sides must
    form them from the same float32 values, and rd is held bit for bit."""
    rng = np.random.default_rng(400 + seed)
    B, S, T = int(rng.integers(1, 5)), int(rng.integers(0, 70)), int(rng.integers(1, 700))
    C, modified = int(rng.integers(2, 140)), bool(rng.integers(2))
    case = f"seed {400 + seed}: B={B} S={S} T={T} C={C} modified={modified}"
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, modified, 400 + seed)
    lm, am = lm.bfloat16(), am.bfloat16()
    uni, dnd = _smoothed_extras(dev, S, B, T, C, 1400 + seed, 1e-3)
    *out, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, uni, save=True)
    for a, b in zip(out, latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, blank, modified)):
        assert a.dtype == torch.float32
        assert_close(a, b, 1e-4, 1e-5, case)
    got, want = _smoothed_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, case)
    assert want[1].dtype == torch.bfloat16
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    _assert_bf16_contract(got, want, case)
    err, tol = float((got[2] - want[2]).abs().max()), 1e-5 * float(want[2].abs().max())
    assert err <= tol, f"{case}: d_uni max abs err {err:.3e} > {tol:.3e}"
    lm_l, am_l, uni_l = lm.clone().requires_grad_(), am.clone().requires_grad_(), uni.clone().requires_grad_()
    before = dict(latbuild.LAUNCHES)
    outs = latbuild._BuildPartsFn.apply(lm_l, am_l, sym, te, uni_l, blank % C, modified)
    g = torch.autograd.grad(outs, [lm_l, am_l, uni_l], [dpx, dpy, dnd])
    assert {k: latbuild.LAUNCHES[k] - before[k] for k in before} == {
        "fwd": 0, "bwd": 0, "fwd_parts": 1, "bwd_parts": 1}
    assert g[0].dtype == torch.bfloat16 and g[1].dtype == torch.bfloat16
    _assert_bf16_contract(g, (want[0].bfloat16(), want[1]), case)


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("seed", range(4))
def test_f32_smoothed_build_backward_matches_plain_at_each_level(dev, seed, level):
    """The smoothed build backward on float32 lm and am at random shapes, at
    each matmul precision (d_uni's product 3xTF32, one TF32 pass, one bf16
    pass; the d_lm and d_am products 3xTF32 at every level) against its
    plain version at that level on the forward kernel's residuals D and
    duni: rd bit for bit (so its rounding to the level's operand is the
    same on both sides), the gradients to 1e-4 of max (chip_smoke's
    GRAD_TOL)."""
    from fast_rnnt_tpu_torch.ops.lattice import _PREC_CODE

    rng = np.random.default_rng(700 + seed)
    B, S, T = int(rng.integers(1, 5)), int(rng.integers(0, 40)), int(rng.integers(1, 300))
    C, modified = int(rng.choice([17, 32, 33, 64, 500])), bool(rng.integers(2))
    case = f"seed {700 + seed} {level}: B={B} S={S} T={T} C={C} modified={modified}"
    lm, am, sym, blank, te, dpx, dpy = _build_grad_case(dev, rng, B, S, T, C, modified, 700 + seed)
    uni, dnd = _smoothed_extras(dev, S, B, T, C, 1700 + seed, 1e-3)
    *_, res = latbuild.build_fwd(lm, am, sym, te, blank, modified, uni, save=True, prec=_PREC_CODE[level])
    _assert_grads(*_smoothed_bwd(lm, am, sym, te, blank, modified, res, dpx, dpy, uni, dnd, case, level), case)


def _ranges_want(gy, gx, K, bnd, step):
    """The padding and repair of the kernels' raw argmax recomputed in their
    own summation order (``window_argmax_kernel_order``)."""
    raw = ranges.window_argmax_kernel_order(gy, gx, K)
    t = torch.arange(raw.shape[1], device=raw.device)[None, :]
    pad = (bnd[:, 2:3] - K + 1).clamp(min=0).to(torch.int32)
    return adjust_pruning_lower_bound(torch.where(t < bnd[:, 3:4] - 1, raw, pad), step)


def _ranges_case(dev, case, seed, dtype, quarter=False):
    B, S, T, K, modified, te = case
    gy, gx = occupancies(seed, B, S, T, modified, quarter)
    bnd = ranges_boundary(seed, B, S, T, te)
    gy, gx, bnd = from_numpy(gy, gx, bnd, device=dev)
    return gy.to(dtype), gx.to(dtype), bnd, K, 2 if modified else K


LONG_RANGES = [(128, 20, 12000, 5, False, None), (8, 100, 20000, 5, False, None),
               (30, 100, 1000, 5, False, None), (5, 60, 3000, 61, True, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", RANGES_EDGES + LONG_RANGES, ids=[ranges_edge_id(c) for c in RANGES_EDGES + LONG_RANGES])
def test_ranges_kernels_equal_repair_of_their_argmax(dev, case, dtype):
    """The pruning-window kernels' starts are exactly the padding and repair
    of their raw argmax in their own summation order, on the edge shapes
    (also on quarter-valued occupancies, whose ties are real), at B = 128,
    T = 12000 and T = 20000, in every storage dtype, one launch each; and
    each raw flip against the plain cumsum-difference search is a near-tie."""
    for quarter in (False, True) if case in RANGES_EDGES else (False,):
        gy, gx, bnd, K, step = _ranges_case(dev, case, sum(case[:4]), dtype, quarter)
        before = ranges.LAUNCHES["ranges"]
        got = ranges.window_starts(gy, gx, K, bnd, step)
        assert ranges.LAUNCHES["ranges"] == before + 1
        assert torch.equal(got, _ranges_want(gy, gx, K, bnd, step))
        assert_ranges_match(ranges.window_argmax_kernel_order(gy, gx, K),
                            torch.argmax(_window_scores(gx, gy, K), dim=0).to(torch.int32),
                            _window_scores(gx, gy, K))


@pytest.mark.parametrize("seed", range(6))
def test_ranges_kernels_on_random_shapes(dev, seed):
    """Random B, S, T, K, t_end and storage dtype: the starts equal the
    repair of the kernels' own raw argmax."""
    rng = np.random.default_rng(500 + seed)
    S, T = int(rng.integers(0, 150)), int(rng.integers(1, 3000))
    case = (int(rng.integers(1, 40)), S, T, int(rng.integers(1, S + 2)), bool(rng.integers(2)), None)
    dtype = (torch.float32, torch.bfloat16, torch.float16)[seed % 3]
    gy, gx, bnd, K, step = _ranges_case(dev, case, seed, dtype)
    assert torch.equal(ranges.window_starts(gy, gx, K, bnd, step), _ranges_want(gy, gx, K, bnd, step))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_ranges_kernels_read_narrow_storage_without_a_cast(dev, dtype):
    """bf16 and f16 occupancies go to the kernels as they are stored: the
    wrapper runs no cast or copy (the kernels sum in float32)."""
    gy, gx, bnd, K, step = _ranges_case(dev, (4, 30, 500, 5, False, None), 3, dtype)
    ranges.window_starts(gy, gx, K, bnd, step)  # the build, outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = ranges.window_starts(gy, gx, K, bnd, step)
    names = {e.name for e in prof.events()}
    assert not names & {"aten::to", "aten::_to_copy", "aten::copy_", "aten::contiguous"}, names
    assert torch.equal(got, _ranges_want(gy, gx, K, bnd, step))


# --- the transducer model on the card -----------------------------------------

MODEL_TINY = dict(vocab_size=32, feature_dim=8, d_model=16, d_joiner=16, num_layers=2, num_heads=2,
                  conv_kernel=7, dtype=torch.float32)


def _model_batch(seed, B=4, T_in=64, S=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T_in, 8)).astype(np.float32)
    flens = np.array([T_in, T_in - 7, T_in - 20, T_in - 33][:B], np.int32)
    syms = rng.integers(1, 32, size=(B, S)).astype(np.int32)
    slens = np.array([S, S - 1, 3, 2][:B], np.int32)
    return feats, flens, syms, slens


def _models(dev):
    from fast_rnnt_tpu_torch.models import TransducerConfig, init_model

    cfg = TransducerConfig(**MODEL_TINY)
    return (init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0)),
            init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))


def test_model_loss_on_cuda_runs_the_six_kernels_and_matches_cpu(dev, monkeypatch):
    """The training loss on the card launches the build, its backward, the
    fused recursion, the ranges kernel and stage 2's two phases once each;
    loss and parameter gradients match the same model's on the CPU (stage
    2 on both gets the CPU's ranges)."""
    from fast_rnnt_tpu_torch.models import LossConfig, pruned_transducer_loss
    from fast_rnnt_tpu_torch.models import training

    m_dev, m_cpu = _models(dev)
    batch = _model_batch(1)
    cfg = LossConfig(s_range=3)
    cpu_total, _ = pruned_transducer_loss(m_cpu, *(torch.tensor(x) for x in batch), cfg)
    cpu_total.backward()
    real = training.get_rnnt_prune_ranges
    seen = []

    def cpu_ranges(gx, gy, bnd, s_range, impl=None):
        got = real(gx, gy, bnd, s_range, impl=impl)
        seen.append(got)
        want = real(gx.cpu(), gy.cpu(), bnd.cpu(), s_range)
        assert_ranges_match(got[:, :, 0], want[:, :, 0],
                            _window_scores(gx.cpu().movedim(1, 0), gy.cpu().movedim(1, 0), s_range))
        return want.to(gx.device)

    monkeypatch.setattr(training, "get_rnnt_prune_ranges", cpu_ranges)
    counts = [dict(wavefront.LAUNCHES), dict(latbuild.LAUNCHES), dict(ranges.LAUNCHES)]
    total, metrics = pruned_transducer_loss(m_dev, *from_numpy(*batch, device=dev), cfg)
    total.backward()
    torch.cuda.synchronize()
    assert seen
    delta = {f"{i}.{k}": d[k] - c[k] for i, (d, c) in enumerate(zip(
        (wavefront.LAUNCHES, latbuild.LAUNCHES, ranges.LAUNCHES), counts)) for k in d}
    assert {k: v for k, v in delta.items() if v} == {
        "0.fwd": 1, "0.bwd": 1, "0.fused": 1, "1.fwd": 1, "1.bwd": 1, "2.ranges": 1}
    assert_loss_close(total.detach().cpu(), cpu_total.detach())
    top = max(q.grad.abs().max().item() for q in m_cpu.parameters())
    for (name, p), q in zip(m_dev.named_parameters(), m_cpu.parameters()):
        if name.endswith("attn.key.bias"):
            # zero but for round-off: the softmax cancels q . b_k
            assert max(p.grad.abs().max().item(), q.grad.abs().max().item()) <= 1e-5 * top, name
            continue
        err = (p.grad.cpu() - q.grad).abs().max().item()
        assert err <= 1e-3 * q.grad.abs().max().item(), name


def test_model_decoding_on_cuda_matches_cpu(dev):
    """Greedy and beam tokens on the card equal the CPU's for the same
    float32 model (TF32 off)."""
    from fast_rnnt_tpu_torch.models import greedy_search, modified_beam_search

    m_dev, m_cpu = _models(dev)
    feats, flens, _, _ = _model_batch(2)
    for search in (greedy_search, modified_beam_search):
        h_d, l_d = search(m_dev, *from_numpy(feats, flens, device=dev), max_len=48)
        h_c, l_c = search(m_cpu, torch.tensor(feats), torch.tensor(flens), max_len=48)
        assert torch.equal(l_d.cpu(), l_c) and torch.equal(h_d.cpu(), h_c), search.__name__


def test_viterbi_alignment_on_cuda_matches_cpu(dev):
    px, py, bnd = rows_inputs(9, B=3, S=7, T=40)
    px, py = np.moveaxis(px, 0, 1).copy(), np.moveaxis(py, 0, 1).copy()
    s_c, f_c, _ = ft.viterbi_alignment(*from_numpy(px, py, bnd, device="cpu"))
    s_d, f_d, _ = ft.viterbi_alignment(*from_numpy(px, py, bnd, device=dev))
    assert_lattice_close(s_d.cpu(), s_c)
    assert torch.equal(f_d.cpu(), f_c)


def _stream_models(dev):
    """The tiny causal float32 model on the card and on the CPU, the same
    weights."""
    from fast_rnnt_tpu_torch.models import TransducerConfig, init_model

    cfg = TransducerConfig(dtype=torch.float32, **STREAM_TINY)
    return (init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0)),
            init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))


def _stream(model, scfg, feats, flens, dev):
    from fast_rnnt_tpu_torch.models import streaming_init, streaming_step

    state = streaming_init(model, scfg, feats.shape[0])
    T = feats.shape[1]
    for i in range(-(-T // scfg.chunk)):
        fc = np.zeros((feats.shape[0], scfg.chunk, feats.shape[2]), np.float32)
        part = feats[:, i * scfg.chunk : (i + 1) * scfg.chunk]
        fc[:, : part.shape[1]] = part
        cl = np.clip(flens - i * scfg.chunk, 0, scfg.chunk).astype(np.int32)
        state, (hyps, lens) = streaming_step(model, scfg, state, *from_numpy(fc, cl, device=dev))
    return hyps.cpu(), lens.cpu()


@pytest.mark.parametrize("beam", [0, 4], ids=["greedy", "beam4"])
def test_streaming_on_cuda_matches_cpu(dev, beam):
    """Streamed tokens on the card equal the CPU's streamed tokens for the
    same weights (TF32 off), and the card's offline decode."""
    from fast_rnnt_tpu_torch.models import StreamingConfig, greedy_search, modified_beam_search

    m_dev, m_cpu = _stream_models(dev)
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(3, 100, STREAM_TINY["feature_dim"])).astype(np.float32)
    flens = np.array([100, 81, 58], np.int32)
    scfg = StreamingConfig(chunk=16, max_len=48, beam=beam)
    h_d, l_d = _stream(m_dev, scfg, feats, flens, dev)
    h_c, l_c = _stream(m_cpu, scfg, feats, flens, "cpu")
    assert torch.equal(l_d, l_c) and torch.equal(h_d, h_c)
    if beam:
        off = modified_beam_search(m_dev, *from_numpy(feats, flens, device=dev), beam=beam, max_len=48)
    else:
        off = greedy_search(m_dev, *from_numpy(feats, flens, device=dev), max_len=48)
    assert torch.equal(off[1].cpu(), l_d) and torch.equal(off[0].cpu(), h_d)
    assert int(l_d.max()) > 0


@pytest.mark.parametrize("beam", [0, 2], ids=["greedy", "beam2"])
def test_stream_server_on_cuda_matches_offline(dev, beam):
    """7 ragged streams through 2 slots on the card (every slot reused):
    each stream's tokens equal the card's offline decode."""
    from fast_rnnt_tpu_torch.models import (
        StreamServer, StreamingConfig, greedy_search, modified_beam_search,
    )

    m_dev, _ = _stream_models(dev)
    rng = np.random.default_rng(12)
    utts = [rng.normal(size=(n, STREAM_TINY["feature_dim"])).astype(np.float32)
            for n in (96, 40, 64, 24, 88, 56, 32)]
    server = StreamServer(m_dev, StreamingConfig(chunk=16, max_len=64, beam=beam), capacity=2)
    for i, u in enumerate(utts):
        server.submit(i, u)
    got = server.run()
    f, fl = from_numpy(*pad_utts(utts), device=dev)
    if beam:
        h, l = modified_beam_search(m_dev, f, fl, beam=beam, max_len=64)
    else:
        h, l = greedy_search(m_dev, f, fl, max_len=64)
    h, l = h.cpu().numpy(), l.cpu().numpy()
    for i in range(len(utts)):
        np.testing.assert_array_equal(got[i], h[i, : l[i]])
    assert l.sum() > 0


def test_streaming_reset_on_cuda_restores_fresh_state(dev):
    """After three chunks on the card, resetting slot 0 gives
    streaming_init's leaves there bit for bit; slot 1 is untouched."""
    from fast_rnnt_tpu_torch.models import (
        StreamingConfig, streaming_init, streaming_reset, streaming_step,
    )

    m_dev, _ = _stream_models(dev)
    scfg = StreamingConfig(chunk=8, max_len=16)
    rng = np.random.default_rng(13)
    state = streaming_init(m_dev, scfg, 2)
    for _ in range(3):
        fc = rng.normal(size=(2, 8, STREAM_TINY["feature_dim"])).astype(np.float32)
        state, _ = streaming_step(m_dev, scfg, state, *from_numpy(fc, np.full(2, 8, np.int32), device=dev))
    out = streaming_reset(m_dev, scfg, state, torch.tensor([True, False], device=dev))
    fresh = streaming_init(m_dev, scfg, 2)

    def leaves(st):
        for v in st.values():
            if isinstance(v, dict):
                yield from leaves(v)
            elif isinstance(v, list):
                yield from v
            else:
                yield v

    n = 0
    for a, f, o in zip(leaves(out), leaves(fresh), leaves(state)):
        assert a.device.type == "cuda"
        assert torch.equal(a[0], f[0]) and torch.equal(a[1], o[1])
        n += 1
    assert n == len(list(leaves(state))) > 5


def _launch_counts():
    return [dict(m.LAUNCHES) for m in (wavefront, latbuild, ranges, pruned)]


@pytest.mark.parametrize("loss_fn", [ft.rnnt_loss_simple_pruned, ft.rnnt_loss_smoothed_pruned],
                         ids=["simple", "smoothed"])
def test_route_switches_on_cuda(dev, monkeypatch, loss_fn):
    """On CUDA tensors the default and "cuda" / "kernel" routes launch the
    kernels, forward and VJP, with the same bits; both switches on "plain"
    launch none and give the CPU route's losses and gradients (the loss and
    lattice tolerances: the card sums in other orders)."""
    from fast_rnnt_tpu_torch.ops import lattice, recursion

    monkeypatch.setattr(recursion, "_DEFAULT_IMPL", None)
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", "auto")
    am, lm, sym, bnd = loss_inputs(41, B=3, T=40, S=7, C=20)

    def run(device):
        tam, tlm, tsym, tbnd = from_numpy(am, lm, sym, bnd, device=device)
        tam.requires_grad_(), tlm.requires_grad_()
        s, p, r = loss_fn(tlm, tam, tsym, 0, 3, boundary=tbnd, reduction="none")
        g = torch.autograd.grad(s.sum() + p.sum(), (tam, tlm))
        torch.cuda.synchronize()
        return [x.detach().cpu() for x in (s, p, r, *g)]

    before = _launch_counts()
    shipped = run(dev)
    assert _launch_counts() != before
    recursion.set_default_impl("cuda")
    lattice.set_lattice_build_impl("kernel")
    pinned = run(dev)
    assert all(torch.equal(a, b) for a, b in zip(pinned, shipped))

    recursion.set_default_impl("plain")
    lattice.set_lattice_build_impl("plain")
    before = _launch_counts()
    plain = run(dev)
    assert _launch_counts() == before
    cpu = run("cpu")
    # the utterances whose ranges agree (a near-tie may flip one)
    agree = (plain[2] == cpu[2]).reshape(len(am), -1).all(dim=1)
    assert agree.any()
    for a, b in zip(plain[:2], cpu[:2]):
        assert_loss_close(a[agree], b[agree])
    for a, b in zip(plain[3:], cpu[3:]):
        assert_close(a[agree], b[agree], 1e-4, 1e-4)


def test_parity_gate_on_cuda_small(dev):
    """The gate at tests/test_parity_gate.py's size on the card: the kernel
    route against the plain route passes enforce_parity (chip_smoke runs it
    at the headline shape)."""
    from fast_rnnt_tpu_torch.utils.parity import enforce_parity, onchip_parity_gate

    am, lm, sym, bnd = loss_inputs(0, B=4, T=64, S=12, C=32)
    before = _launch_counts()
    got = onchip_parity_gate(*from_numpy(am, lm, sym, bnd, device=dev), s_range=4)
    assert _launch_counts() != before
    assert got["golden_cases"] == 5
    enforce_parity(got)


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("C", [33, 64])
def test_precision_levels_match_their_plain_emulation(dev, level, C):
    """chip_smoke's precision phase at a small shape: at each matmul
    precision the build kernels (forward, backward on the forward's
    residual D, and the smoothed build's) against their plain emulation at
    the lattice and GRAD tolerances; the kernel's rounded exp operands equal
    the emulation's; bf16 lm and am give the same bits at every level."""
    from fast_rnnt_tpu_torch.ops import lattice

    am, lm, sym, bnd = from_numpy(*loss_inputs(90 + C, B=3, T=45, S=7, C=C), device=dev)
    B, T, S = 3, 45, 7
    te = bnd[:, 3].contiguous()
    g = torch.Generator(device=dev).manual_seed(C)
    dpx, dpy, dnd = (torch.randn(shape, device=dev, generator=g)
                     for shape in ((S, B, T + 1), (S + 1, B, T), (S + 1, B, T)))
    uni = torch.softmax(torch.randn(C, device=dev, generator=g), 0) + 1e-3
    try:
        ft.set_matmul_precision(level)
        for x in (am, lm):
            m = x.amax(2)
            k = latbuild.round_exps(x, m, lattice._PREC_CODE[level])
            if level != "highest":
                assert torch.equal(k, lattice._round_operand(torch.exp(x - m[..., None]), level))
        px_k, py_k, _, res = latbuild.build_fwd(lm, am, sym, te, 0, False, save=True)
        px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, 0, "regular", bnd)
        assert_close(px_k, px_p, 1e-4, 1e-5, "px")
        assert_close(py_k, py_p, 1e-4, 1e-5, "py")
        for got, want in zip(latbuild.build_bwd(lm, am, sym, te, 0, False, res, dpx, dpy)[:2],
                             latbuild.lattice_rows_bwd_plain(lm, am, sym, te, dpx, dpy, 0, False,
                                                             d=res[0])[:2]):
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        *out_k, res_s = latbuild.build_fwd(lm, am, sym, te, 0, False, uni, save=True)
        for got, want in zip(out_k, latbuild.lattice_rows_parts_plain(lm, am, sym, te, uni, 0, False)):
            assert_close(got, want, 1e-4, 1e-5, "parts")
        _assert_grads(*_smoothed_bwd(lm, am, sym, te, 0, False, res_s, dpx, dpy, uni, dnd, f"C={C} {level}"),
                      f"C={C} {level}")
        bf16 = latbuild.lattice_rows(lm.bfloat16(), am.bfloat16(), sym, 0, "regular", bnd)
        ft.set_matmul_precision("highest")
        want16 = latbuild.lattice_rows(lm.bfloat16(), am.bfloat16(), sym, 0, "regular", bnd)
        assert all(torch.equal(a, b) for a, b in zip(bf16, want16))
    finally:
        ft.set_matmul_precision("highest")


def test_per_call_impl_on_cuda(dev, monkeypatch):
    """impl="plain" per call launches no kernel on CUDA tensors and wins over
    the process switches pinned to the kernels; impl="cuda" gives the
    shipped route's bits."""
    from fast_rnnt_tpu_torch.ops import lattice, recursion

    monkeypatch.setattr(recursion, "_DEFAULT_IMPL", None)
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", "auto")
    am, lm, sym, bnd = loss_inputs(42, B=3, T=40, S=7, C=20)

    def run(impl):
        tam, tlm, tsym, tbnd = from_numpy(am, lm, sym, bnd, device=dev)
        tam.requires_grad_(), tlm.requires_grad_()
        s, p, r = ft.rnnt_loss_simple_pruned(tlm, tam, tsym, 0, 3, tbnd, reduction="none", impl=impl)
        g = torch.autograd.grad(s.sum() + p.sum(), (tam, tlm))
        torch.cuda.synchronize()
        return [x.detach().cpu() for x in (s, p, r, *g)]

    shipped = run(None)
    assert all(torch.equal(a, b) for a, b in zip(run("cuda"), shipped))
    recursion.set_default_impl("plain")
    lattice.set_lattice_build_impl("plain")
    switched = run(None)
    recursion.set_default_impl("cuda")
    lattice.set_lattice_build_impl("kernel")
    before = _launch_counts()
    plain = run("plain")
    assert _launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(plain, switched))


# The pruned lattice's kernels (csrc/pruned_rows.cu) against their plain
# version on the card.  float32: the kernels' log-sum-exp sums in another
# order than torch.logsumexp, a few float32 steps at |lse| <= ~10, so px and
# py within 1e-5 + 1e-6 |x|, d_logits within 1e-5 + 1e-5 |x| (a softmax of
# those normalisers times cotangents ~N(0, 1)).  bfloat16 and float16: the
# kernels compute in float32 and round where the plain version's arithmetic
# rounds (the normaliser, the difference, the constrained add), so against
# the plain version on the float32 logits px and py lie within eps max|lse|
# + eps |x| (+ 1e-5), eps the dtype's step at 1, the sum of those half-step
# roundings, and d_logits, rounded once, within eps |x| + 1e-5 max|g|.
# Against the plain version in the same dtype, whose torch.logsumexp rounds
# in that dtype too, the two normalisers lie within two steps at max|lse|:
# px, py within 2 eps max|lse| + 2 eps |x| (+ 1e-5), d_logits within
# (2 eps max|lse| + 2 eps) max(|g_px| + |g_py|) + 2 eps |x|.  The -inf,
# +inf and NaN patterns are equal everywhere.

PRUNED_CASES = {
    "ragged": dict(seed=31, B=3, T=37, S=9, K=4, C=29),
    "edges": dict(seed=32, B=4, T=41, S=8, K=3, C=33, edges=True),
    "k2": dict(seed=33, B=3, T=25, S=7, K=2, C=500),
    "k_s1": dict(seed=34, B=2, T=19, S=5, K=6, C=24),
    "s0": dict(seed=35, B=3, T=11, S=0, K=1, C=16),
    "t1": dict(seed=36, B=3, T=1, S=6, K=3, C=17),
}


def _pruned_run(fn, logits, sym, rg, bnd, rnnt_type, gx=None, gy=None):
    """(px, py, d_logits) with cotangents gx, gy on every element of px and
    py (-inf ones included), drawn where not given."""
    x = logits.detach().clone().requires_grad_()
    px, py = fn(x, sym, rg, 0, bnd, rnnt_type)
    if gx is None:
        g = torch.Generator(device=x.device).manual_seed(7)
        gx = torch.randn(px.shape, generator=g, device=x.device)
        gy = torch.randn(py.shape, generator=g, device=x.device)
    (d,) = torch.autograd.grad((px, py), x, (gx.to(px.dtype), gy.to(py.dtype)))
    torch.cuda.synchronize()
    return px.detach(), py.detach(), d, gx, gy


def _same_nonfinite(a, b, what):
    for f in (torch.isneginf, torch.isposinf, torch.isnan):
        assert torch.equal(f(a), f(b)), f"{what}: {f.__name__} pattern"


def _close_where_finite(a, b, atol, rtol, what):
    _same_nonfinite(a, b, what)
    fin = torch.isfinite(b)
    torch.testing.assert_close(a[fin].double(), b[fin].double(), atol=atol, rtol=rtol, msg=what)


def _pruned_compare(dev, kw, rnnt_type, dtype, index=torch.int32, with_bnd=True):
    logits, sym, rg, bnd = pruned_inputs(**kw)
    logits = torch.tensor(logits, dtype=dtype, device=dev)
    sym, rg, bnd = (torch.tensor(x, dtype=index, device=dev) for x in (sym, rg, bnd))
    bnd = bnd if with_bnd else None
    before = dict(pruned.LAUNCHES), pruned.FRAMES
    got = _pruned_run(ft.get_rnnt_logprobs_pruned, logits, sym, rg, bnd, rnnt_type)
    B, T = logits.shape[:2]
    assert {k: n - before[0][k] for k, n in pruned.LAUNCHES.items()} == {"band": 1, "rows": 1, "bwd": 1}
    assert pruned.FRAMES - before[1] == B * T
    assert got[0].movedim(1, 0).is_contiguous() and got[1].movedim(1, 0).is_contiguous()
    plain = _pruned_run(pruned.pruned_lattice_plain, logits, sym, rg, bnd, rnnt_type, *got[3:])
    lse = torch.logsumexp(logits.float(), 3)
    m = lse[torch.isfinite(lse)].abs().max().item() if lse.numel() else 0.0
    if dtype == torch.float32:
        for a, b, what in zip(got[:2], plain[:2], ("px", "py")):
            _close_where_finite(a, b, 1e-5, 1e-6, what)
        _close_where_finite(got[2], plain[2], 1e-5, 1e-5, "d_logits")
        return
    eps = torch.finfo(dtype).eps
    g = (got[3].abs().max() + got[4].abs().max()).item() if got[3].numel() else 0.0
    wide = _pruned_run(pruned.pruned_lattice_plain, logits.float(), sym, rg, bnd, rnnt_type,
                       got[3].to(dtype).float(), got[4].to(dtype).float())
    for a, b, what in zip(got[:2], wide[:2], ("px", "py")):
        assert a.dtype == dtype
        _close_where_finite(a, b, eps * m + 1e-5, eps, f"{what} vs float32")
    _close_where_finite(got[2], wide[2], 1e-5 * max(g, 1.0), eps, "d_logits vs float32")
    for a, b, what in zip(got[:2], plain[:2], ("px", "py")):
        _close_where_finite(a, b, 2 * eps * m + 1e-5, 2 * eps, f"{what} vs plain")
    _close_where_finite(got[2], plain[2], (2 * eps * m + 2 * eps) * max(g, 1.0), 2 * eps,
                        "d_logits vs plain")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
@pytest.mark.parametrize("case", list(PRUNED_CASES))
def test_pruned_lattice_kernels_match_the_plain_version(dev, case, rnnt_type, dtype):
    """Ragged boundaries, empty and s_end = 0 utterances, windows at row S
    and ranges outside [0, S], out-of-vocabulary symbols, K = 2 and
    K = S + 1, S = 0, T = 1: px, py and d_logits (tolerances above)."""
    kw = PRUNED_CASES[case]
    if rnnt_type == "constrained" and kw["K"] < 2:
        logits, sym, rg, bnd = from_numpy(*pruned_inputs(**kw), device=dev)
        with pytest.raises(ValueError, match="s_range >= 2"):
            ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd, rnnt_type)
        return
    _pruned_compare(dev, kw, rnnt_type, dtype)


@pytest.mark.parametrize("rnnt_type", ["regular", "constrained"])
def test_pruned_lattice_kernels_take_int64_and_no_boundary(dev, rnnt_type):
    _pruned_compare(dev, PRUNED_CASES["edges"], rnnt_type, torch.float32, torch.int64, False)


def test_pruned_lattice_kernels_at_the_recipe_shape(dev):
    """The recipe's pruned lattice for one utterance: T 12000, S 1200, K 5,
    C 500, float32."""
    _pruned_compare(dev, dict(seed=37, B=1, T=12000, S=1200, K=5, C=500), "regular",
                    torch.float32)


def test_pruned_loss_hands_the_rows_to_the_recursion(dev, monkeypatch):
    """rnnt_loss_pruned hands the kernels' rows to the recursion with no
    copy (the same storage), and its loss and gradient agree with the plain
    lattice's (loss 1e-4 + 1e-5 |x|, gradient the float32 tolerance above)."""
    from fast_rnnt_tpu_torch.ops import lattice
    from fast_rnnt_tpu_torch.ops import recursion as trec

    logits, sym, rg, bnd = from_numpy(*pruned_inputs(38, B=3, T=50, S=9, K=4, C=40), device=dev)
    made, seen = [], []
    route, rows = pruned.pruned_lattice, trec.mutual_information_rows

    def keep(*a):
        out = route(*a)
        made.append([t.data_ptr() for t in out])
        return out

    def look(px_rows, py_rows, *a, **k):
        seen.append([px_rows.data_ptr(), py_rows.data_ptr()])
        return rows(px_rows, py_rows, *a, **k)

    monkeypatch.setattr(pruned, "pruned_lattice", keep)
    monkeypatch.setattr(trec, "mutual_information_rows", look)

    def loss():
        x = logits.clone().requires_grad_()
        out = ft.rnnt_loss_pruned(x, sym, rg, 0, bnd, reduction="none")
        return out.detach(), torch.autograd.grad(out.sum(), x)[0]

    got = loss()
    assert made and seen == made
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", "plain")  # the recursion's route kept
    want = loss()
    assert_loss_close(got[0], want[0])
    _close_where_finite(got[1], want[1], 1e-5, 1e-5, "d_logits")


def test_pruned_loss_per_call_impl_on_cuda(dev, monkeypatch):
    """rnnt_loss_pruned's impl="plain" launches no kernel on CUDA tensors,
    the pruned lattice's included, and wins over the process switches
    pinned to the kernels; impl="cuda" launches the lattice's three kernels
    once each and gives the shipped route's bits."""
    from fast_rnnt_tpu_torch.ops import lattice, recursion

    monkeypatch.setattr(recursion, "_DEFAULT_IMPL", None)
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", "auto")
    logits, sym, rg, bnd = from_numpy(*pruned_inputs(39, B=3, T=40, S=7, K=3, C=20), device=dev)

    def run(impl):
        x = logits.clone().requires_grad_()
        loss = ft.rnnt_loss_pruned(x, sym, rg, 0, bnd, reduction="none", impl=impl)
        (g,) = torch.autograd.grad(loss.sum(), x)
        torch.cuda.synchronize()
        return [loss.detach().cpu(), g.cpu()]

    shipped = run(None)
    before = dict(pruned.LAUNCHES)
    assert all(torch.equal(a, b) for a, b in zip(run("cuda"), shipped))
    assert {k: n - before[k] for k, n in pruned.LAUNCHES.items()} == {"band": 1, "rows": 1, "bwd": 1}
    recursion.set_default_impl("plain")
    lattice.set_lattice_build_impl("plain")
    switched = run(None)
    recursion.set_default_impl("cuda")
    lattice.set_lattice_build_impl("kernel")
    before = _launch_counts()
    plain = run("plain")
    assert _launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(plain, switched))
