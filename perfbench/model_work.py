"""Operations and bytes of icefall's conformer training step
(``configs/icefall-conformer-l12-d512.json``), counted from the
configuration and each utterance's lengths.

The operations are those of every product the model needs, counted over
each utterance's own frames (T_in input frames, T encoder frames, S
symbols), 2 a multiply-add: both subsampling convs and the Dense after
them; in each block the two feed-forwards, the attention's in-projection,
the scores (q+u) k^T over T x T, the position scores (q+v) p^T over
T x (2T-1), the probabilities times v over T x T and the out-projection,
the conv module's two pointwise products and its depthwise conv; the
position projection of the batch's 2T-1 positions once a batch; the
output Dense to the vocabulary; the predictor's context conv and Dense;
the joiner over T x s_range pairs.  A step is three times the forward
(the backward's two products for each of the forward's).  The loss's own
products (the lattice build) are the loss layers' (``roofline.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from .roofline import BF16_FLOPS

Work = Tuple[float, float, float]  # (operations, bytes, operation peak)


def frames(t_in: int) -> Tuple[int, int]:
    """(frames after the first conv, encoder frames) of t_in input frames."""
    t1 = (t_in - 1) // 2
    return t1, (t1 - 1) // 2


def forward_ops(cfg: dict, t_in: Iterable[int], s: Iterable[int], s_range: int) -> Dict[str, float]:
    """Forward operations of one batch by part: ``subsampling``,
    ``attention``, ``conv_module``, ``feed_forward``, ``encoder_out``,
    ``predictor``, ``joiner``."""
    d, c, V = cfg["d_model"], cfg["subsampling_channels"], cfg["vocab_size"]
    L, ff, k, e = cfg["num_layers"], cfg["ff_dim"], cfg["conv_kernel"], cfg["decoder_dim"]
    f1 = (cfg["feature_dim"] - 1) // 2
    f2 = (f1 - 1) // 2
    ops = dict.fromkeys(("subsampling", "attention", "conv_module", "feed_forward",
                         "encoder_out", "predictor", "joiner"), 0.0)
    t_max = 0
    for t_in_b, s_b in zip(t_in, s):
        t1, T = frames(t_in_b)
        t_max = max(t_max, T)
        ops["subsampling"] += 2.0 * 9 * c * t1 * f1 + 2.0 * 9 * c * c * T * f2 + 2.0 * c * f2 * d * T
        ops["attention"] += L * (2.0 * d * 3 * d * T + 2.0 * T * T * d + 2.0 * T * (2 * T - 1) * d
                                 + 2.0 * T * T * d + 2.0 * d * d * T)
        ops["conv_module"] += L * (2.0 * d * 2 * d * T + 2.0 * k * d * T + 2.0 * d * d * T)
        ops["feed_forward"] += L * 2 * (2.0 * d * ff * T + 2.0 * ff * d * T)
        ops["encoder_out"] += 2.0 * d * V * T
        ops["predictor"] += (s_b + 1) * (2.0 * cfg["context_size"] * e + 2.0 * e * V)
        ops["joiner"] += 2.0 * V * V * T * s_range
    ops["attention"] += L * 2.0 * (2 * t_max - 1) * d * d  # the position projection, once a batch
    return ops


def attention_bytes(cfg: dict, t_in: Iterable[int]) -> float:
    """Bytes the attention needs in the forward and the backward of one
    batch: each way its float32 input and its bf16 output over the
    utterances' frames, the float32 encodings of the 2T-1 positions and its
    float32 weights, each once."""
    d, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    t = [frames(x)[1] for x in t_in]
    weights = 3 * d * d + 3 * d + d * d + d * d + d + 2 * d  # in, pos, out, biases u, v (H x hd)
    per_layer = sum(t) * d * (4 + 2) + (2 * max(t) - 1) * d * 4 + weights * 4
    return 2.0 * L * per_layer


def step_work(cfg: dict, batches: Iterable[Tuple[Iterable[int], Iterable[int]]], s_range: int,
              params: int) -> Dict[str, Work]:
    """(operations, bytes, bf16 peak) of a cycle of ``batches``, each
    (input frames, symbols) a utterance: ``model``, the whole step (its
    bytes the features read once and ten float32 words a parameter: read in
    the forward and the backward, the gradient written, Adam's read and
    write of the parameter and both moments), and ``attention``."""
    ops = att = nbytes = att_bytes = 0.0
    for t_in, s in batches:
        t_in, s = list(t_in), list(s)
        fwd = forward_ops(cfg, t_in, s, s_range)
        ops += 3 * sum(fwd.values())
        att += 3 * fwd["attention"]
        nbytes += 4.0 * cfg["feature_dim"] * sum(t_in) + 40.0 * params
        att_bytes += attention_bytes(cfg, t_in)
    return {"model": (ops, nbytes, BF16_FLOPS), "attention": (att, att_bytes, BF16_FLOPS)}
