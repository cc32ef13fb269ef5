"""Parity of the port's pruned transducer (fast_rnnt_tpu_torch.models)
with the JAX package's, on the CPU, at the tiny size of tests/test_models.py
(vocab 32, 8 features, d 16, 2 heads, conv 7, T_in 32, S 6).

The JAX model's weights are carried across by ``params_from_flax``; the
same numpy batch goes to both.  Tolerances:

  * float32 model outputs: |a - b| <= 1e-5 + 1e-5 |b|;
  * bfloat16 compute: max |a - b| <= 2e-2 of max |b| per output (measured
    <= 1.5e-2 at these sizes: bf16 rounding at other places);
  * losses: rel 1e-4; each parameter's gradient within 1e-4 of that
    leaf's max |grad| (stage 2 gets the JAX ranges, monkeypatched on the
    port's training module only: a near-tie window flip would change the
    pruned loss's lattice);
  * AdamW against optax.adamw from the same params and gradients: each
    leaf within 1e-6 of its max |param| plus 1e-5 of the steps' total
    learning rate (optax's own float32 bias correction, ADAM_UPDATE_TOL); three train steps end to end:
    metrics rel 1e-4, params within 1e-4 of each leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_rnnt_tpu.models import LossConfig as JLossConfig
from fast_rnnt_tpu.models import TransducerConfig as JConfig
from fast_rnnt_tpu.models import init_model as jinit_model
from fast_rnnt_tpu.models import make_train_step as jmake_train_step
from fast_rnnt_tpu.models.training import make_boundary as jmake_boundary
from fast_rnnt_tpu.models.training import pruned_transducer_loss as jloss_fn
from fast_rnnt_tpu.ops.losses import rnnt_loss_simple as jrnnt_loss_simple
from fast_rnnt_tpu.ops.pruning import get_rnnt_prune_ranges as jget_ranges
from fast_rnnt_tpu_torch.models import (
    LossConfig,
    PrunedTransducer,
    TransducerConfig,
    init_model,
    make_train_step,
    pruned_transducer_loss,
)
from fast_rnnt_tpu_torch.models import training as ttraining
from fast_rnnt_tpu_torch.models import transducer as ttransducer
from fast_rnnt_tpu_torch.ops.pruning import _window_scores
from fast_rnnt_tpu_torch.utils import params_from_flax

from ._torch_parity import assert_ranges_match, to_np

TINY = dict(vocab_size=32, feature_dim=8, d_model=16, d_joiner=16, num_heads=2, conv_kernel=7)
S_RANGE = 3
OUT_ATOL = OUT_RTOL = 1e-5
BF16_TOL = 2e-2
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
# optax's float32 bias correction 1 - 0.999 is 1.3e-5 off 0.001, which moves
# its Adam update by ~6.5e-6 of itself (torch's, in float64, by ~1e-7)
ADAM_UPDATE_TOL = 1e-5


def _batch(seed, B=8, T_in=32, S=6):
    """tests/test_models.py's batch, in numpy."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T_in, TINY["feature_dim"])).astype(np.float32)
    feat_lens = np.clip(rng.integers(T_in // 2, T_in + 1, size=B), 28, T_in).astype(np.int32)
    syms = rng.integers(1, TINY["vocab_size"], size=(B, S)).astype(np.int32)
    sym_lens = rng.integers(2, S + 1, size=B).astype(np.int32)
    return feats, feat_lens, syms, sym_lens


def _port(params, dtype=torch.float32, **kw):
    model = PrunedTransducer(TransducerConfig(dtype=dtype, **TINY, **kw))
    sd = params_from_flax(params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def _tb(batch):
    return tuple(torch.tensor(x) for x in batch)


@pytest.fixture(scope="module")
def jmodel():
    """One float32 JAX model (1 layer) for the loss, gradient and optimizer
    cases: the model, its params as numpy, and its jitted loss value and
    gradient ``vg(params, batch)`` (one compile for the file)."""
    model, params = jinit_model(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, num_layers=1, **TINY))
    cfg = JLossConfig(s_range=S_RANGE)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, model, *b, cfg), has_aux=True))
    return model, jax.device_get(params), vg


def _jax_ranges(model, params, batch, s_range=S_RANGE):
    feats, flens, syms, slens = (jnp.asarray(x) for x in batch)
    _, _, s_am, s_lm, out_lens = model.apply(params, feats, flens, syms)
    bnd = jmake_boundary(out_lens, slens)
    _, (gx, gy) = jrnnt_loss_simple(s_lm, s_am, syms, 0, bnd, reduction="sum", calc_gradients=True)
    return np.asarray(jget_ranges(gx, gy, bnd, s_range))


def _patch_ranges(monkeypatch, queue):
    """Stage 2 of the port's loss takes the next JAX ranges of ``queue``."""
    monkeypatch.setattr(ttraining, "get_rnnt_prune_ranges",
                        lambda *a, **k: torch.tensor(queue.pop(0)))


CASES = [(dt, causal, T_in) for dt in ("f32", "bf16") for causal in (False, True) for T_in in (32, 31)]


@pytest.mark.parametrize("dt,causal,T_in", CASES,
                         ids=[f"{d}-{'causal' if c else 'offline'}-T{t}" for d, c, t in CASES])
def test_model_outputs_match_jax(dt, causal, T_in):
    """(am, lm, simple_am, simple_lm, out_lens); T_in even and odd covers
    both cases of the SAME-padding rule, the causal encoder its explicit
    left pads and the attention window."""
    kw = dict(num_layers=2, causal=causal, attention_left_context=4 if causal else None)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jm, jp = jinit_model(jax.random.PRNGKey(1), JConfig(dtype=jdt, **TINY, **kw))
    model = _port(jax.device_get(jp), tdt, **kw)
    batch = _batch(2, B=3, T_in=T_in)
    want = jm.apply(jp, *(jnp.asarray(x) for x in batch[:3]))
    with torch.no_grad():
        got = model(*_tb(batch[:3]))
    np.testing.assert_array_equal(to_np(got[4]), np.asarray(want[4]))
    for name, g, w in zip(("am", "lm", "simple_am", "simple_lm"), got[:4], want[:4]):
        assert g.dtype == torch.float32, name
        g, w = to_np(g), np.asarray(w, np.float32)
        if dt == "f32":
            np.testing.assert_allclose(g, w, atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=name)
        else:
            assert np.abs(g - w).max() <= BF16_TOL * np.abs(w).max(), name


def test_symmetric_subsampling_pad_would_fail(monkeypatch):
    """nn.Conv2d(padding=1)'s symmetric (1, 1) pad of the stride-2 convs
    shifts every subsampled frame by one input frame at even T_in: the
    outputs leave the tolerance that the SAME rule meets."""
    kw = dict(num_layers=1)
    jm, jp = jinit_model(jax.random.PRNGKey(1), JConfig(dtype=jnp.float32, **TINY, **kw))
    model = _port(jax.device_get(jp), **kw)
    batch = _batch(3, B=2, T_in=32)
    want = np.asarray(jm.apply(jp, *(jnp.asarray(x) for x in batch[:3]))[0])
    monkeypatch.setattr(ttransducer, "_same_pads", lambda length, k, stride: (k // 2, k // 2))
    with torch.no_grad():
        got = to_np(model(*_tb(batch[:3]))[0])
    assert np.abs(got - want).max() > 100 * (OUT_ATOL + OUT_RTOL * np.abs(want).max())


def test_loss_and_grads_match_jax(jmodel, monkeypatch):
    jm, jp, vg = jmodel
    batch = _batch(4)
    (_, jmetrics), jgrads = vg(jp, tuple(jnp.asarray(x) for x in batch))
    _patch_ranges(monkeypatch, [_jax_ranges(jm, jp, batch)])
    model = _port(jp, num_layers=1)
    total, metrics = pruned_transducer_loss(model, *_tb(batch), LossConfig(s_range=S_RANGE))
    total.backward()
    for key in ("loss", "simple_loss", "pruned_loss"):
        w = float(jmetrics[key])
        assert abs(metrics[key].item() - w) <= LOSS_RTOL * abs(w), key
    assert int(metrics["frames"]) == int(jmetrics["frames"])
    want = params_from_flax(jax.device_get(jgrads))
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in model.named_parameters():
        g, w = to_np(p.grad), want[name].numpy()
        if name.endswith("attn.key.bias"):
            # q . b_k shifts a query's logits alike: the softmax cancels it,
            # so this gradient is zero but for round-off on both sides
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * top, name
            continue
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), f"{name}: {err} vs max {np.abs(w).max()}"


def test_port_ranges_match_jax_or_near_tie(jmodel):
    """Without the patch, the port's own ranges equal the JAX package's, or
    differ only at near-ties of the window scores (<= 1e-3)."""
    jm, jp, _ = jmodel
    batch = _batch(5)
    model = _port(jp, num_layers=1)
    feats, flens, syms, slens = _tb(batch)
    with torch.no_grad():
        _, _, s_am, s_lm, out_lens = model(feats, flens, syms)
        bnd = ttraining.make_boundary(out_lens, slens)
        _, (gx, gy) = ttraining.rnnt_loss_simple(s_lm, s_am, syms, 0, bnd, reduction="sum",
                                                 calc_gradients=True)
        got = ttraining.get_rnnt_prune_ranges(gx, gy, bnd, S_RANGE)
        scores = _window_scores(gx.movedim(1, 0), gy.movedim(1, 0), S_RANGE)
    want = _jax_ranges(jm, jp, batch)
    assert_ranges_match(to_np(got)[:, :, 0], want[:, :, 0], to_np(scores), "ranges")


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax(jmodel, steps):
    """torch.optim.AdamW(1e-3, betas (0.9, 0.999), eps 1e-8, weight_decay
    1e-4) against optax.adamw(1e-3), fed the same (JAX) gradients at each
    step from the same params: the optimizers' mapping alone (Adam's
    normalisation turns the round-off of a near-zero gradient into a
    visible update, so the end-to-end step is held in the next test)."""
    jm, jp, vg = jmodel
    jb = tuple(jnp.asarray(x) for x in _batch(6))
    opt = optax.adamw(1e-3)
    params, state = jp, opt.init(jp)
    model = _port(jp, num_layers=1)
    optim = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    for _ in range(steps):
        _, grads = vg(params, jb)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        g = params_from_flax(jax.device_get(grads))
        for name, p in model.named_parameters():
            p.grad = g[name]
        optim.step()
    want = params_from_flax(jax.device_get(params))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(to_np(p) - w).max()
        tol = ADAM_TOL * np.abs(w).max() + ADAM_UPDATE_TOL * 1e-3 * steps
        assert err <= tol, f"{name}: {err} vs max {np.abs(w).max()}"


def test_train_step_matches_jax(jmodel, monkeypatch):
    """Three steps of ``make_train_step`` against the JAX package's, both
    with AdamW (optax.adamw(1e-3)): each step's metrics to rel 1e-4, the
    params after them within 1e-4 of each leaf's max.  The attention key
    bias is left out of the params: its gradient is zero but for round-off
    (see above), which Adam turns into +-lr steps on either side."""
    jm, jp, _ = jmodel
    batch = _batch(6)
    opt = optax.adamw(1e-3)
    jstep = jmake_train_step(jm, opt, mesh=None, loss_cfg=JLossConfig(s_range=S_RANGE))
    params, state, queue, jmetrics = jp, opt.init(jp), [], []
    for _ in range(3):
        queue.append(_jax_ranges(jm, params, batch))
        params, state, m = jstep(params, state, tuple(jnp.asarray(x) for x in batch))
        jmetrics.append(m)
    _patch_ranges(monkeypatch, queue)
    model = _port(jp, num_layers=1)
    optim = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    step = make_train_step(model, optim, LossConfig(s_range=S_RANGE))
    for jm_k in jmetrics:
        metrics = step(_tb(batch))
        assert not any(v.requires_grad for v in metrics.values())
        for key in ("loss", "simple_loss", "pruned_loss"):
            w = float(jm_k[key])
            assert abs(metrics[key].item() - w) <= LOSS_RTOL * abs(w), key
    assert not queue
    want = params_from_flax(jax.device_get(params))
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue
        w = want[name].numpy()
        err = np.abs(to_np(p) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), f"{name}: {err} vs max {np.abs(w).max()}"


def test_train_loop_from_own_init_loss_falls():
    """30 AdamW steps on one batch from the port's own init, on the CPU."""
    model = init_model(TransducerConfig(dtype=torch.float32, num_layers=1, **TINY), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    optim = torch.optim.AdamW(model.parameters(), lr=3e-3, weight_decay=1e-4)
    step = make_train_step(model, optim, LossConfig(s_range=S_RANGE))
    batch = _tb(_batch(7))
    losses = [float(step(batch)["loss"]) for _ in range(30)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


def test_init_model_families():
    """flax's default initialisers; the same generator seed gives the same
    weights; a CUDA device without one raises."""
    cfg = TransducerConfig(**{**TINY, "d_model": 64, "d_joiner": 64, "vocab_size": 128}, num_layers=1)
    a = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert torch.equal(sd["encoder.blocks.0.ln_out.weight"], torch.ones(64))
    assert not sd["encoder.blocks.0.ff1.fc1.bias"].any()
    w = sd["encoder.blocks.0.ff1.fc1.weight"]  # lecun normal, fan_in 64, truncated at 2 std
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and abs(w.std().item() / (1 / 64) ** 0.5 - 1) < 0.05
    e = sd["predictor.embed.weight"]  # normal, std sqrt(1 / d)
    assert abs(e.std().item() / (1 / 64) ** 0.5 - 1) < 0.05 and e.abs().max() > 2 * std
    dw = sd["encoder.blocks.0.conv.dw.weight"]  # depthwise: fan_in = kernel extent
    assert dw.abs().max() <= 2 * (1 / 7) ** 0.5 / 0.87962566103423978
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_model(cfg)
