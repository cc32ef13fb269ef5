"""Plain reference of icefall's pruned-transducer conformer training step
(k2-fsa/icefall, egs/librispeech/ASR/pruned_transducer_stateless;
arXiv:2206.13236), written from its layer equations.

Plain PyTorch, computed in the dtype of the parameters it is given (float32
for the comparisons), with no kernel and no module of the measured program:
it imports nothing of it.  It reads the parameters from a dict keyed by the
program's ``state_dict`` names (``encoder.blocks.<i>.attn.in_proj.weight``
and so on), weights as (out, in).  ``perfbench/reference/`` and
``tests/torch_reference/`` hold the same file.

  * front end: relu(conv 3x3 stride 2, unpadded) twice; the (B, C, T, F)
    output flattened channel-major to (B, T, C F); a Linear to d; x * sqrt(d);
    T = ((T_in - 1) // 2 - 1) // 2;
  * pe: the sinusoidal encodings of the relative positions T-1 ... -(T-1);
  * a block: x += FF(LN(x)) / 2; x += MHSA(LN(x)); x += Conv(LN(x));
    x += FF(LN(x)) / 2; x = LN(x); FF = Linear, x sigmoid(x), Linear; LN eps
    1e-5;
  * MHSA: q, k, v = x W_in + b_in (heads of hd); p = pe W_pos; score[b, h,
    i, j] = ((q_i + u_h) . k_j + (q_i + v_h) . p[T-1-i+j]) / sqrt(hd), the
    position term gathered explicitly; padded keys -inf; softmax; . v; out;
  * Conv: Linear(d, 2d), GLU, padded frames zeroed, depthwise conv of width
    k (padding (k-1)/2), BatchNorm over every B x T position (biased
    variance, eps 1e-5), x sigmoid(x), Linear;
  * am = Linear(LN(x)) (B, T, V); lm: the symbols after one blank, embedded
    (the blank's row 0), one zero frame of left context per extra width,
    a depthwise conv of width k without bias, relu, Linear (B, S+1, V);
  * losses from their definition (``pruned_loss.py``): the smoothed simple
    loss (lm_only_scale, am_only_scale) and, on given windows, the pruned
    loss of logits = Linear(tanh(am_t + lm_s)); total = simple_scale *
    simple + pruned, summed over the batch;
  * Adam (Kingma and Ba, arXiv:1412.6980, algorithm 1) with the bias
    corrections of step t, weight decay 0.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import pruned_loss as rl

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5
BN_EPS = 1e-5


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products without TF32, the cuBLAS and cuDNN switches restored
    after the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def out_lengths(feature_lens: torch.Tensor) -> torch.Tensor:
    return ((feature_lens - 1) // 2 - 1) // 2


def positions(T: int, d: int, dtype, device) -> torch.Tensor:
    """(2T-1, d): row r encodes the relative position T-1-r, sin(pos w_k) in
    column 2k and cos(pos w_k) in column 2k+1, w_k = 10000^(-2k/d)."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float64, device=device)[:, None]
    w = torch.pow(10000.0, -torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
    pe = torch.stack([torch.sin(pos * w), torch.cos(pos * w)], dim=2).reshape(2 * T - 1, d)
    return pe.to(dtype)


def _lin(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ P[f"{name}.weight"].t()
    return y + P[f"{name}.bias"] if f"{name}.bias" in P else y


def _ln(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _ff(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return _lin(P, f"{name}.fc2", _swish(_lin(P, f"{name}.fc1", _ln(P, f"{name}.ln", x))))


def _attention(P: Params, name: str, x: torch.Tensor, pe: torch.Tensor, valid: torch.Tensor,
               heads: int) -> torch.Tensor:
    B, T, d = x.shape
    hd = d // heads
    q, k, v = _lin(P, f"{name}.in_proj", x).split(d, dim=-1)
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))  # (B, H, T, hd)
    p = _lin(P, f"{name}.linear_pos", pe).reshape(2 * T - 1, heads, hd).transpose(0, 1)
    u = P[f"{name}.pos_bias_u"][None, :, None, :]
    w = P[f"{name}.pos_bias_v"][None, :, None, :]
    content = (q + u) @ k.transpose(-1, -2)  # (B, H, T, T)
    by_pos = (q + w) @ p.transpose(-1, -2)  # (B, H, T, 2T-1)
    i = torch.arange(T, device=x.device)[:, None]
    j = torch.arange(T, device=x.device)[None, :]
    shift = (T - 1 - i + j).expand(B, heads, T, T)
    score = (content + torch.gather(by_pos, 3, shift)) / math.sqrt(hd)
    score = score.masked_fill(~valid[:, None, None, :], float("-inf"))
    o = torch.softmax(score, dim=-1) @ v  # (B, H, T, hd)
    return _lin(P, f"{name}.out_proj", o.transpose(1, 2).reshape(B, T, d))


def _conv_module(P: Params, name: str, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    h = _lin(P, f"{name}.pw_in", _ln(P, f"{name}.ln_in", x))
    a, g = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)) * valid[:, :, None]
    w = P[f"{name}.dw.weight"]  # (d, 1, k)
    k = w.shape[2]
    h = F.conv1d(h.transpose(1, 2), w, P[f"{name}.dw.bias"], padding=(k - 1) // 2,
                 groups=w.shape[0])  # (B, d, T)
    mean = h.mean(dim=(0, 2), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(0, 2), keepdim=True)
    h = (h - mean) / torch.sqrt(var + BN_EPS) * P[f"{name}.norm.weight"][:, None] \
        + P[f"{name}.norm.bias"][:, None]
    return _lin(P, f"{name}.pw_out", _swish(h).transpose(1, 2))


def encoder(P: Params, cfg: dict, features: torch.Tensor, feature_lens: torch.Tensor):
    """am (B, T, V) and the out lengths."""
    x = F.relu(F.conv2d(features[:, None], P["encoder.sub1.weight"], P["encoder.sub1.bias"],
                        stride=2))
    x = F.relu(F.conv2d(x, P["encoder.sub2.weight"], P["encoder.sub2.bias"], stride=2))
    B, C, T, Fq = x.shape
    d = cfg["d_model"]
    x = _lin(P, "encoder.proj", x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)) * math.sqrt(d)
    lens = out_lengths(feature_lens)
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    pe = positions(T, d, x.dtype, x.device)
    for i in range(cfg["num_layers"]):
        blk = f"encoder.blocks.{i}"
        x = x + 0.5 * _ff(P, f"{blk}.ff1", x)
        x = x + _attention(P, f"{blk}.attn", _ln(P, f"{blk}.ln_attn", x), pe, valid,
                           cfg["num_heads"])
        x = x + _conv_module(P, f"{blk}.conv", x, valid)
        x = x + 0.5 * _ff(P, f"{blk}.ff2", x)
        x = _ln(P, f"{blk}.ln_out", x)
    return _lin(P, "encoder_out", _ln(P, "encoder.after_norm", x)), lens


def predictor(P: Params, cfg: dict, symbols: torch.Tensor) -> torch.Tensor:
    """lm (B, S+1, V)."""
    blank = cfg["blank_id"]
    y = torch.cat([torch.full_like(symbols[:, :1], blank), symbols], dim=1).long()
    emb = P["predictor.embed.weight"][y]
    emb = torch.where((y == blank)[..., None], torch.zeros_like(emb), emb)  # (B, S+1, d)
    w = P["predictor.conv.weight"]  # (d, 1, k)
    k = w.shape[2]
    h = F.conv1d(F.pad(emb.transpose(1, 2), (k - 1, 0)), w, groups=w.shape[0])
    return _lin(P, "predictor.out", F.relu(h).transpose(1, 2))


def forward(P: Params, cfg: dict, features, feature_lens, symbols):
    """(am, lm, out lengths)."""
    am, lens = encoder(P, cfg, features, feature_lens)
    return am, predictor(P, cfg, symbols), lens


def boundary(out_lens: torch.Tensor, symbol_lens: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(out_lens)
    return torch.stack([z, z, symbol_lens.to(out_lens.dtype), out_lens], dim=1)


def simple_loss(am, lm, symbols, bnd, cfg: dict) -> torch.Tensor:
    """Per utterance, the smoothed simple loss (B,)."""
    px, py = rl.smoothed_lattice(lm, am, symbols, cfg["blank_id"], cfg["lm_scale"],
                                 cfg["am_scale"], bnd)
    return -rl.recursion(px, py, bnd)


def pruned_loss(P: Params, am, lm, symbols, ranges, bnd, cfg: dict) -> torch.Tensor:
    """Per utterance, the pruned loss (B,) of the joiner over the windows
    ``ranges`` (B, T, K): logits[b, t, k] = Linear(tanh(am[b, t] +
    lm[b, ranges[b, t, k]]))."""
    B, T, K = ranges.shape
    rows = ranges.long().clamp(0, lm.shape[1] - 1)
    lm_p = torch.gather(lm[:, None].expand(B, T, *lm.shape[1:]), 2,
                        rows[..., None].expand(B, T, K, lm.shape[2]))
    logits = _lin(P, "joiner.out", torch.tanh(am[:, :, None, :] + lm_p))
    px, py = rl.pruned_lattice(logits, symbols, ranges, cfg["blank_id"], bnd)
    return -rl.recursion(px, py, bnd)


def loss_and_grads(P: Params, cfg: dict, features, feature_lens, symbols, symbol_lens,
                   ranges) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(simple, pruned, gradients by name) of the step on one batch, the
    pruned stage on the windows ``ranges``: every parameter of ``P`` that
    the losses reach gets a gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    am, lm, lens = forward(leaves, cfg, features, feature_lens, symbols)
    bnd = boundary(lens, symbol_lens)
    simple = simple_loss(am, lm, symbols, bnd, cfg).sum()
    pruned = pruned_loss(leaves, am, lm, symbols, ranges, bnd, cfg).sum()
    total = cfg["simple_loss_scale"] * simple + pruned
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
    return simple.detach(), pruned.detach(), {
        k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)}


def adam(params: List[torch.Tensor], grads: List[torch.Tensor], m: List[torch.Tensor],
         v: List[torch.Tensor], t: int, lr: float, betas: Tuple[float, float],
         eps: float) -> List[torch.Tensor]:
    """The parameters after Adam's step t (1 for the first) from the moments
    m, v of step t-1: m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2,
    theta' = theta - lr (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)."""
    b1, b2 = betas
    out = []
    for p, g, m0, v0 in zip(params, grads, m, v):
        m1 = b1 * m0 + (1 - b1) * g
        v1 = b2 * v0 + (1 - b2) * g * g
        out.append(p - lr * (m1 / (1 - b1 ** t)) / (torch.sqrt(v1 / (1 - b2 ** t)) + eps))
    return out
