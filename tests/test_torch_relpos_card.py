"""The relative-position attention kernels (``csrc/relpos_attention.cu``,
wrapper ``ops/kernels/relpos_attention.py``) on the card.  They need an
NVIDIA GPU and skip without one; run them there with

    python -m pytest --noconftest tests/test_torch_relpos_card.py -m cuda

Each case runs the kernels forward and backward and holds o and the
gradients of qu, k, v and bd_raw, each by its norm-wise error
||got - want||_2 / ||want||_2, against two yardsticks:

  * the kernels' own function in float64 (:func:`contract`): the same
    inputs, the scores and softmax exact, the probabilities rounded to the
    inputs' dtype before the product with v, as the kernels round them.
    ``TOL[dtype]`` (o, gradients) lies about 2.5 times above the largest
    reading over this file's cases on an H100 and below the readings of planted
    faults (:func:`test_the_check_fails_a_backward_that_drops_small_probabilities`):
    the bf16 and f16 results are rounded once in their dtype (2^-9, 2^-12
    relative) and dS through the probabilities' rounding; float32 sums of up
    to T terms;
  * the plain version on the card, :func:`relpos_attention_plain`, which
    rounds qu k^T to the inputs' dtype before adding bd, so its scores move
    by up to eps |qu k^T| hd^-0.5: ``PLAIN_TOL``, about 2.5 times the
    largest reading in bf16 and f16, and float32 as tight as the contract (both compute in
    float32, TF32 off).

A norm-wise error weighs every entry: d(bd_raw) holds T^2 small entries and
a few large ones, and an error of the largest entry alone would pass a
backward that dropped most of them.  Each case prints its readings.

"""

import functools

import pytest
import torch

from fast_rnnt_tpu_torch.ops.kernels import relpos_attention as ra

pytestmark = pytest.mark.cuda

# (o, gradients): about 2.5 times the largest reading of this file's cases on
# an H100 (bf16 3.2e-3, 5.0e-3; f16 3.7e-4, 3.7e-4; float32 3.7e-7 and, at
# T = 1 where every float64 dS is 0 and the norm's floor decides, 1.5e-5;
# against the plain version bf16 4.1e-3, 5.0e-3; f16 4.5e-4, 5.3e-4); the
# planted faults read 2.6e-2 and 0.22 at the largest bucket
TOL = {torch.bfloat16: (8e-3, 1.2e-2), torch.float16: (1e-3, 1e-3), torch.float32: (1e-6, 4e-5)}
PLAIN_TOL = {torch.bfloat16: (1e-2, 1.2e-2), torch.float16: (1.2e-3, 1.5e-3), torch.float32: (1e-6, 4e-5)}
BUCKETS = [(93, 209), (67, 290), (55, 353), (45, 434)]
EDGE_T = [1, 2, 63, 64, 65, 127, 129]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def inputs(dev, B, T, H, hd, dt, lengths, seed, extra=None):
    """qu contiguous, k and v strided views of one (B, T, 3, H, hd) tensor
    as the in-projection gives them, bd_raw at the scores' scale with
    ``extra`` columns after the 2T-1 (by default as many as the module pads:
    to a multiple of 8), stored (H, B, T, L) as the module makes it, the key
    mask of ``lengths`` ("full", "one", "ragged" or "random": a scattered
    mask with at least one key), and dO."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, T, 3, H, hd), generator=g, device=dev).to(dt)
    qu = torch.randn((B, T, H, hd), generator=g, device=dev).to(dt)
    _, k, v = qkv.unbind(2)
    L = 2 * T - 1 + (-(2 * T - 1) % 8 if extra is None else extra)
    bd = (torch.randn((H, B, T, L), generator=g, device=dev) * hd ** 0.5).to(dt).transpose(0, 1)
    if lengths == "random":
        mask = torch.rand((B, T), generator=g, device=dev) < 0.5
        mask[:, torch.randint(T, (1,), generator=g, device=dev)] = True
    else:
        n = {"full": torch.full((B,), T, device=dev), "one": torch.ones(B, device=dev),
             "ragged": torch.randint(1, T + 1, (B,), generator=g, device=dev)}[lengths]
        n[0] = T
        mask = torch.arange(T, device=dev)[None, :] < n[:, None]
    do = torch.randn((B, T, H, hd), generator=g, device=dev).to(dt)
    return qu, k, v, bd, mask, do


def run(fn, qu, k, v, bd, mask, do):
    """fn's output and the gradients of qu, k, v and bd_raw for cotangent do."""
    xs = [x.detach().requires_grad_() for x in (qu, k, v, bd)]
    o = fn(*xs, mask)
    grads = torch.autograd.grad(o, xs, do)
    return [o.detach(), *grads]


def contract(qu, k, v, bd, mask, drop_below=None):
    """The kernels' function in float64: exact scores and softmax, the
    probabilities rounded to the inputs' dtype for the product with v (the
    rounding passed through by the gradient).  ``drop_below`` plants a
    fault: dS set to 0 wherever P < drop_below."""
    dt = qu.dtype
    hd = qu.shape[3]
    ac = torch.einsum("bihd,bjhd->bhij", qu.double(), k.double())
    w = (ac + ra.rel_shift(bd.double())) * hd ** -0.5
    w = w.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(w, dim=-1)
    if drop_below is not None:
        small = p.detach() < drop_below
        w.register_hook(lambda ds: ds.masked_fill(small, 0))
    p = p + (p.to(dt).double() - p).detach()
    return torch.einsum("bhij,bjhd->bihd", p, v.double()).to(dt)


def norm_errs(got, want):
    """Each ||got - want||_2 over ||want||_2; for a gradient over at least
    1e-2 of the largest gradient's norm, since with a single key in reach dS
    is exactly 0 in float64 and only rounding elsewhere."""
    norms = [float(b.double().norm()) for b in want]
    floor = 1e-2 * max(norms[1:])
    return [float((a.double() - b.double()).norm()) / max(n, floor if i else 1e-30)
            for i, (a, b, n) in enumerate(zip(got, want, norms))]


NAMES = ("o", "dqu", "dk", "dv", "dbd_raw")


def check(dev, B, T, H, hd, dt, lengths, seed, extra=None):
    args = inputs(dev, B, T, H, hd, dt, lengths, seed, extra)
    rows = ra.ROWS
    got = run(ra.relpos_attention, *args)
    assert ra.ROWS - rows == B * H * T
    want = run(contract, *args)
    plain = run(ra.relpos_attention_plain, *args)
    case = f"B={B} T={T} H={H} hd={hd} {dt} lengths={lengths} seed={seed}"
    for x in got:
        assert torch.isfinite(x).all(), case
    readings = ((norm_errs(got, want), TOL[dt], "float64 contract"),
                (norm_errs(got, plain), PLAIN_TOL[dt], "plain version"))
    for errs, _, what in readings:
        print(f"{case} vs the {what}: " + ", ".join(f"{n} {e:.3e}" for n, e in zip(NAMES, errs)))
    for errs, (t_o, t_g), what in readings:
        for name, e in zip(NAMES, errs):
            assert e <= (t_o if name == "o" else t_g), f"{case}: {name} vs the {what}: {e:.3e}"
    # d(bd_raw) is 0 wherever no (i, j) reads bd_raw
    reached = torch.zeros(args[3].shape[2:], dtype=torch.bool, device=dev)
    ra.rel_shift(reached[None, None])[0, 0].fill_(True)
    assert not got[4][:, :, ~reached].any(), case
    return got


@pytest.mark.parametrize("B,T", BUCKETS)
def test_bucket_shapes_bf16(dev, B, T):
    check(dev, B, T, 8, 64, torch.bfloat16, "ragged", 1000 + T)


@pytest.mark.parametrize("T", EDGE_T)
@pytest.mark.parametrize("lengths", ["full", "one", "ragged"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_edge_lengths(dev, T, lengths, dt):
    check(dev, 3, T, 2, 64, dt, lengths, 2000 + T)


@pytest.mark.parametrize("extra", [None, 13])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_bd_raw_layouts(dev, extra, dt):
    """bd_raw padded as the module pads it and 13 columns past 2T-1 (L 192
    at T 90)."""
    check(dev, 4, 90, 3, 64, dt, "ragged", 3500 + (extra or 0), extra)


def test_cuda_cores_take_rows_of_any_length(dev):
    """float32 runs on the CUDA cores, whose bd rows may start anywhere: 2T-1
    columns; the tensor-core kernels raise on them."""
    check(dev, 4, 90, 3, 64, torch.float32, "ragged", 3600, 0)
    qu, k, v, bd, mask, _ = inputs(dev, 4, 90, 3, 64, torch.bfloat16, "ragged", 3600, 0)
    with pytest.raises(ValueError):
        ra.relpos_attention(qu, k, v, bd, mask)


@pytest.mark.parametrize("T", [64, 129, 434])
def test_float16(dev, T):
    check(dev, 4, T, 4, 64, torch.float16, "ragged", 3000 + T)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_scattered_key_mask(dev, dt):
    check(dev, 5, 150, 3, 64, dt, "random", 4000)


@pytest.mark.parametrize("hd,dt", [(32, torch.bfloat16), (32, torch.float32), (96, torch.float32)])
def test_cuda_core_head_sizes(dev, hd, dt):
    check(dev, 3, 77, 2, hd, dt, "ragged", 5000 + hd)


def test_float32_bucket(dev):
    check(dev, 45, 434, 8, 64, torch.float32, "ragged", 6000)


def test_deterministic(dev):
    """No atomics: two runs give the same bits."""
    args = inputs(dev, 7, 200, 8, 64, torch.bfloat16, "ragged", 7000)
    a, b = run(ra.relpos_attention, *args), run(ra.relpos_attention, *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fully_masked_utterance_gives_nan_as_the_plain_version(dev):
    qu, k, v, bd, mask, _ = inputs(dev, 2, 70, 2, 64, torch.bfloat16, "full", 8000)
    mask[1] = False
    o = ra.relpos_attention(qu, k, v, bd, mask)
    want = ra.relpos_attention_plain(qu, k, v, bd, mask)
    assert torch.isnan(o[1]).all() and torch.isnan(want[1]).all()
    assert torch.isfinite(o[0]).all()


def test_launches_and_rows(dev):
    args = inputs(dev, 2, 100, 8, 64, torch.bfloat16, "ragged", 9000)
    before, rows = dict(ra.LAUNCHES), ra.ROWS
    run(ra.relpos_attention, *args)
    assert {k: ra.LAUNCHES[k] - before[k] for k in before} == {"fwd": 1, "bwd_q": 1, "bwd_kv": 1}
    assert ra.ROWS - rows == 2 * 8 * 100


def test_kernel_route_raises_on_what_it_does_not_take(dev):
    qu, k, v, bd, mask, _ = inputs(dev, 2, 40, 2, 64, torch.bfloat16, "full", 9100)
    with pytest.raises(TypeError):
        ra.relpos_attention(qu, k, v, bd.float(), mask)
    with pytest.raises(TypeError):
        ra.relpos_attention(qu, k, v, bd, mask.cpu())
    with pytest.raises(ValueError):
        ra.relpos_attention(qu, k, v, bd[..., :2 * 40 - 2].contiguous(), mask)
    with pytest.raises(ValueError):  # rows not L apart
        ra.relpos_attention(qu, k, v, bd[..., :2 * 40 - 1], mask)
    bf = dict(dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # rows not on 16 bytes
        ra.relpos_attention(qu, torch.empty((2, 40, 2, 72), **bf)[..., 4:68], v, bd, mask)
    with pytest.raises(ValueError):  # no unit stride on the last axis
        ra.relpos_attention(qu, torch.empty((2, 40, 64, 2), **bf).transpose(2, 3), v, bd, mask)


@pytest.mark.parametrize("drop", [1e-2, 1e-3])
def test_the_check_fails_a_backward_that_drops_small_probabilities(dev, drop):
    """A planted fault at the largest bucket: the float64 function with dS
    set to 0 wherever P < ``drop`` (most of the T^2 entries; each dropped one
    is small) is held to the float64 contract as the kernels are, and must
    fail ``TOL`` in dqu, dk and d(bd_raw); dv and o do not pass through dS."""
    args = inputs(dev, 45, 434, 8, 64, torch.bfloat16, "ragged", 1434)
    want = run(contract, *args)
    bad = run(functools.partial(contract, drop_below=drop), *args)
    errs = dict(zip(NAMES, norm_errs(bad, want)))
    print(f"dS dropped where P < {drop}, vs the float64 contract: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    for name in ("dqu", "dk", "dbd_raw"):
        assert errs[name] > TOL[torch.bfloat16][1], (name, errs[name])
