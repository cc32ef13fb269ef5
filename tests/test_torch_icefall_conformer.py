"""The icefall recipe of the port's transducer (``TransducerConfig(recipe=
"icefall")``, the conformer of icefall's pruned_transducer_stateless) against
the plain reference ``tests/torch_reference/icefall_conformer.py``, on the
CPU at a small size: d_model 64 (the subsampling convs' channels too), 2
layers, 4 heads, conv kernel 7, vocabulary 50, seeded random weights and batches of
unequal lengths.

Tolerances, in float32:

  * am, lm: max |a - b| <= 1e-5 of max |b| (measured <= 4e-7): the same
    equations in another order (torch's fused LayerNorm and BatchNorm
    against their means and variances written out, the shift as a strided
    view against a gather, the encodings' arguments rounded in float32
    against float64);
  * the losses: relative 1e-5 (the loss ops in float32 both sides, on
    outputs that agree as above);
  * each gradient: relative L2 1e-3 (measured <= 2e-5); the depthwise
    biases, whose gradient BatchNorm makes 0 but for rounding, within
    1e-6 of the gradient's largest entry;
  * bf16 compute (the configuration's): am and lm within 3e-2 of max |b|
    (measured <= 8e-3: bf16 operands, 2^-9 relative, over two blocks);
  * Adam's step: within 1e-4 of the step's largest entry, plus the
    parameter's own rounding (2^-22 of its largest entry).
"""

from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fast_rnnt_tpu_torch.models import (LossConfig, TransducerConfig, init_model,
                                        make_train_step, training)
from fast_rnnt_tpu_torch.ops.kernels.relpos_attention import rel_shift

from .torch_reference import icefall_conformer as ref

# one thread, as tests/_torch_parity.py has it: the suite's workers share the cores
torch.set_num_threads(1)

SMALL = dict(recipe="icefall", vocab_size=50, feature_dim=80, d_model=64, num_layers=2,
             num_heads=4, conv_kernel=7)
REF = dict(d_model=64, num_layers=2, num_heads=4, blank_id=0, lm_scale=0.25, am_scale=0.0,
           simple_loss_scale=0.5)
LOSS = LossConfig(s_range=5, lm_only_scale=0.25, am_only_scale=0.0)
OUT_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
ZERO_GRAD_TOL = 1e-6
BF16_TOL = 3e-2
ADAM_TOL = 1e-4
SEEDS = [0, 1]


def _model(seed, dtype=torch.float32, **kw):
    return init_model(TransducerConfig(dtype=dtype, **{**SMALL, **kw}), device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _batch(seed, B=4, T_in=150, S=9):
    g = torch.Generator().manual_seed(100 + seed)
    lens = torch.tensor([T_in, T_in - 13, T_in - 31, T_in - 50])[:B]
    feats = torch.randn(B, T_in, 80, generator=g)
    feats = feats * (torch.arange(T_in)[None, :, None] < lens[:, None, None])
    s_lens = torch.tensor([S, S - 2, S - 4, S - 1])[:B]
    sym = torch.randint(1, 50, (B, S), generator=g) * (torch.arange(S)[None, :] < s_lens[:, None])
    return feats, lens, sym.to(torch.int32), s_lens


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _max_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_outputs_match_reference(seed):
    model = _model(seed)
    feats, lens, sym, _ = _batch(seed)
    with torch.no_grad():
        am, lm, simple_am, simple_lm, out_lens = model(feats, lens, sym)
        am_r, lm_r, lens_r = ref.forward(_params(model), REF, feats, lens, sym)
    assert am is simple_am and lm is simple_lm
    assert am.dtype == lm.dtype == torch.float32
    assert am.shape == (4, 36, 50) and lm.shape == (4, 10, 50)
    assert torch.equal(out_lens, lens_r)
    assert _max_err(am, am_r) <= OUT_TOL and _max_err(lm, lm_r) <= OUT_TOL


def _step(model, batch, loss_cfg=LOSS, monkeypatch=None):
    """One make_train_step call (Adam as the benchmark's); the windows it
    searched."""
    got = {}
    search = training.get_rnnt_prune_ranges

    def kept(*args, **kwargs):
        got["ranges"] = search(*args, **kwargs)
        return got["ranges"]

    monkeypatch.setattr(training, "get_rnnt_prune_ranges", kept)
    opt = torch.optim.Adam(model.parameters(), lr=7.8e-4, betas=(0.9, 0.98), eps=1e-9)
    metrics = make_train_step(model, opt, loss_cfg)(batch)
    return metrics, got["ranges"], opt


@pytest.mark.parametrize("seed", SEEDS)
def test_losses_and_gradients_match_reference(seed, monkeypatch):
    model = _model(seed)
    P = _params(model)
    batch = _batch(seed)
    metrics, ranges, _ = _step(model, batch, monkeypatch=monkeypatch)
    simple, pruned, grads = ref.loss_and_grads(P, REF, *batch, ranges)
    assert float(metrics["simple_loss"]) == pytest.approx(float(simple), rel=LOSS_RTOL)
    assert float(metrics["pruned_loss"]) == pytest.approx(float(pruned), rel=LOSS_RTOL)
    assert float(metrics["loss"]) == pytest.approx(0.5 * float(simple) + float(pruned),
                                                   rel=LOSS_RTOL)
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, p in model.named_parameters():
        if name.endswith(".conv.dw.bias"):
            assert float(p.grad.abs().max()) <= ZERO_GRAD_TOL * largest, name
            continue
        err = float((p.grad - grads[name]).norm() / grads[name].norm())
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("T", [1, 2, 5, 16])
def test_rel_shift_is_the_explicit_gather(T):
    x = torch.randn(2, 3, T, 2 * T - 1, generator=torch.Generator().manual_seed(T))
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    want = torch.gather(x, 3, (T - 1 - i + j).expand(2, 3, T, T))
    assert torch.equal(rel_shift(x), want)


def test_rel_shift_gradient_is_the_gather_gradient():
    x = torch.randn(2, 2, 6, 11, requires_grad=True)
    w = torch.randn(2, 2, 6, 6)
    i = torch.arange(6)[:, None]
    j = torch.arange(6)[None, :]
    (g,) = torch.autograd.grad((rel_shift(x) * w).sum(), x)
    (want,) = torch.autograd.grad((torch.gather(x, 3, (5 - i + j).expand(2, 2, 6, 6)) * w).sum(), x)
    assert torch.equal(g, want)


@pytest.mark.parametrize("T_in", [7, 8, 9, 10, 33, 100, 101, 150])
def test_front_end_lengths(T_in):
    """((L - 1) // 2 - 1) // 2 frames for every utterance, and the encoder's
    padded length that of the longest."""
    model = _model(0, num_layers=1)
    lens = torch.tensor([T_in, max(T_in - 1, 7), 7])
    feats = torch.randn(3, T_in, 80)
    with torch.no_grad():
        am, _, _, _, out_lens = model(feats, lens, torch.ones(3, 2, dtype=torch.int32))
    want = ((lens - 1) // 2 - 1) // 2
    assert torch.equal(out_lens, want) and am.shape[1] == ((T_in - 1) // 2 - 1) // 2
    assert torch.equal(ref.out_lengths(lens), want)


@pytest.mark.parametrize("scales,called", [((0.0, 0.0), "rnnt_loss_simple"),
                                           ((0.25, 0.0), "rnnt_loss_smoothed")])
def test_stage_one_loss_follows_the_scales(scales, called, monkeypatch):
    """Zero scales keep rnnt_loss_simple; a nonzero scale calls
    rnnt_loss_smoothed, with the scales given."""
    seen = []
    for name in ("rnnt_loss_simple", "rnnt_loss_smoothed"):
        fn = getattr(training, name)
        monkeypatch.setattr(training, name,
                            lambda *a, _fn=fn, _n=name, **k: seen.append((_n, k)) or _fn(*a, **k))
    model = _model(0)
    lm_s, am_s = scales
    cfg = LossConfig(s_range=5, lm_only_scale=lm_s, am_only_scale=am_s)
    training.pruned_transducer_loss(model, *_batch(0), cfg)
    assert [n for n, _ in seen] == [called]
    if called == "rnnt_loss_smoothed":
        assert (seen[0][1]["lm_only_scale"], seen[0][1]["am_only_scale"]) == scales


def test_smoothed_step_at_zero_scales_is_the_simple_step(monkeypatch):
    """The smoothed loss at scales 0 is the simple loss (its lm-only and
    am-only parts weigh 1e-20), so the step is the same."""
    batch = _batch(1)
    plain = training.pruned_transducer_loss(_model(1), *batch, LossConfig(s_range=5))[1]
    smoothed = training.rnnt_loss_smoothed
    monkeypatch.setattr(training, "rnnt_loss_simple",
                        lambda lm, am, sym, **k: smoothed(lm, am, sym, lm_only_scale=0.0,
                                                          am_only_scale=0.0, **k))
    got = training.pruned_transducer_loss(_model(1), *batch, LossConfig(s_range=5))[1]
    for key in ("simple_loss", "pruned_loss"):
        got[key], plain[key] = got[key].detach(), plain[key].detach()
        assert float(got[key]) == pytest.approx(float(plain[key]), rel=LOSS_RTOL), key


def test_adam_step_matches_reference(monkeypatch):
    """One step of torch's Adam (icefall's betas and eps) from the model's
    moments after a first step: the parameters the reference's Adam gives."""
    model = _model(2)
    batch = _batch(2)
    _, _, opt = _step(model, batch, monkeypatch=monkeypatch)
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    m = [opt.state[p]["exp_avg"].clone() for p in params]
    v = [opt.state[p]["exp_avg_sq"].clone() for p in params]
    opt.zero_grad()
    total, _ = training.pruned_transducer_loss(model, *batch, LOSS)
    total.backward()
    grads = [p.grad.clone() for p in params]
    opt.step()
    want = ref.adam(before, grads, m, v, 2, 7.8e-4, (0.9, 0.98), 1e-9)
    for (name, p), w, b in zip(model.named_parameters(), want, before):
        # the step's float32 rounding, and the parameter's own at its size
        tol = ADAM_TOL * float((w - b).abs().max()) + 2.0 ** -22 * float(b.abs().max())
        assert float((p.detach() - w).abs().max()) <= tol, name


def test_reference_copies_are_equal():
    root = Path(__file__).resolve().parents[1]
    a = root / "tests" / "torch_reference" / "icefall_conformer.py"
    b = root / "perfbench" / "reference" / "icefall_conformer.py"
    assert a.read_bytes() == b.read_bytes()


def test_reference_imports_neither_jax_nor_the_port():
    text = (Path(ref.__file__)).read_text()
    for name in ("import jax", "from jax", "fast_rnnt_tpu", "flax"):
        assert name not in text, name


def test_published_widths_and_initialisers():
    """icefall's 12 x 512 conformer at BPE 500: 84,252,268 parameters;
    torch's initialisers, the blank's embedding row 0, the attention's
    biases 0 and its position biases xavier-uniform."""
    cfg = TransducerConfig(recipe="icefall", d_model=512, num_layers=12, num_heads=8,
                           conv_kernel=31)
    model = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 84_252_268
    sd = model.state_dict()
    assert sd["encoder.sub2.weight"].shape == (512, 512, 3, 3)
    assert sd["encoder.proj.weight"].shape == (512, 512 * 19)
    assert not sd["predictor.embed.weight"][0].any() and sd["predictor.embed.weight"][1].any()
    assert "predictor.conv.bias" not in sd and sd["predictor.conv.weight"].shape == (512, 1, 2)
    a = "encoder.blocks.3.attn."
    assert not sd[a + "in_proj.bias"].any() and not sd[a + "out_proj.bias"].any()
    bound = (6 / (8 + 64)) ** 0.5
    u = sd[a + "pos_bias_u"]
    assert u.abs().max() <= bound and u.abs().max() > 0.9 * bound
    w = sd["encoder.blocks.3.ff1.fc1.weight"]  # kaiming-uniform a = sqrt(5): bound 1 / sqrt(512)
    assert w.abs().max() <= 512 ** -0.5 and w.abs().max() > 0.99 * 512 ** -0.5
    assert torch.equal(sd["encoder.blocks.3.conv.norm.weight"], torch.ones(512))
    again = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))


def test_bf16_outputs_within_rounding():
    model = _model(3, dtype=torch.bfloat16)
    feats, lens, sym, _ = _batch(3)
    with torch.no_grad():
        am, lm, _, _, _ = model(feats, lens, sym)
        am_r, lm_r, _ = ref.forward(_params(model), REF, feats, lens, sym)
    assert am.dtype == lm.dtype == torch.float32
    assert _max_err(am, am_r) <= BF16_TOL and _max_err(lm, lm_r) <= BF16_TOL


def test_step_opens_the_model_spans(monkeypatch):
    """A profiled step opens every span of the model's parts."""
    model = _model(4)
    batch = _batch(4, B=2)
    opt = torch.optim.Adam(model.parameters(), lr=7.8e-4, betas=(0.9, 0.98), eps=1e-9)
    step = make_train_step(model, opt, LOSS)
    step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    names = {e.name for e in prof.events() if e.name.startswith("frt.model.")}
    assert names == {f"frt.model.{p}" for p in ("subsampling", "attention", "conv_module",
                                                "feed_forward", "predictor", "joiner",
                                                "optimizer")}


@pytest.mark.parametrize("kw", [dict(recipe="espnet"), dict(recipe="icefall", causal=True),
                                dict(recipe="icefall", attention_left_context=8)])
def test_recipe_is_checked(kw):
    with pytest.raises(ValueError):
        TransducerConfig(**kw)
