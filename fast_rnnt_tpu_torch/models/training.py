"""Two-stage pruned-transducer training step (PyTorch port of
``fast_rnnt_tpu/models/training.py``):

  1. simple loss (vocab-space additive joiner) with occupancies
  2. pruning ranges from the occupancies
  3. prune the joiner-space projections
  4. full joiner on the pruned (B, T, s_range) pairs only
  5. pruned loss;   total = simple_scale * simple + pruned_scale * pruned

On CUDA tensors the loss runs the port's kernels: the lattice build and
its backward, the fused recursion (stage 1's occupancies), the ranges
kernel, and the recursion's forward and backward phases (stage 2).  The
model's own layers are plain PyTorch.

With a mesh (``parallel.make_mesh``), each rank runs the step on its shard
of the batch (``parallel.shard_batch``) and the gradients and metrics are
all-reduced with SUM, as the JAX step's ``psum`` sums them: the loss is a
sum over the batch, so the global gradient is the sum of the shards'.
(``DistributedDataParallel`` would average them instead, a factor of the
world size away.)

``optax.adamw(lr)`` corresponds to ``torch.optim.AdamW(params, lr,
betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)`` (optax's default decay
is 1e-4, torch's 1e-2).

Nonzero ``LossConfig.lm_only_scale`` or ``am_only_scale`` make stage 1 the
smoothed simple loss (``rnnt_loss_smoothed``), as icefall's recipe has it.
The icefall recipe's model (``TransducerConfig(recipe="icefall")``) is drawn
with torch's default initialisers, as icefall's modules have them
(:func:`_torch_init`).  The optimizer's step is the span
``frt.model.optimizer``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.losses import rnnt_loss_pruned, rnnt_loss_simple, rnnt_loss_smoothed
from ..parallel.sharding import all_reduce_sum, broadcast_from_first
from ..ops.pruning import do_rnnt_pruning, get_rnnt_prune_ranges
from ..utils.profiling import annotate
from .transducer import (LayerNorm, PrunedTransducer, RelPositionMultiHeadAttention,
                         TransducerConfig)

__all__ = [
    "LossConfig",
    "make_boundary",
    "pruned_transducer_loss",
    "make_train_step",
    "init_model",
]

# stddev of a standard normal truncated to [-2, 2]: flax's truncated-normal
# initialisers divide by it so that the truncated draw has the asked std
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The loss's settings, the JAX package's.  ``impl`` is the losses'
    per-call route, passed to both (None: the process switches and the
    tensors' device; "cuda"; "plain", the plain versions on any device, the
    build included; or a ``register_impl`` name)."""

    s_range: int = 5
    simple_scale: float = 0.5
    pruned_scale: float = 1.0
    rnnt_type: str = "regular"
    delay_penalty: float = 0.0
    impl: Optional[str] = None
    # stage 1's smoothing (rnnt_loss_smoothed); both 0: rnnt_loss_simple
    lm_only_scale: float = 0.0
    am_only_scale: float = 0.0


def make_boundary(out_lens: torch.Tensor, symbol_lens: torch.Tensor) -> torch.Tensor:
    """[B, 4] int32 rows [0, 0, symbol_len, out_len], on out_lens' device."""
    zeros = torch.zeros_like(out_lens, dtype=torch.int32)
    return torch.stack(
        [zeros, zeros, symbol_lens.to(torch.int32), out_lens.to(torch.int32)], dim=1
    )


def pruned_transducer_loss(
    model: PrunedTransducer,
    features: torch.Tensor,
    feature_lens: torch.Tensor,
    symbols: torch.Tensor,
    symbol_lens: torch.Tensor,
    loss_cfg: LossConfig = LossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss (sum over the batch) and a metrics dict with the JAX
    package's keys: loss, simple_loss, pruned_loss, frames."""
    blank = model.cfg.blank_id
    am, lm, simple_am, simple_lm, out_lens = model(features, feature_lens, symbols)
    boundary = make_boundary(out_lens, symbol_lens)

    common = dict(termination_symbol=blank, boundary=boundary, rnnt_type=loss_cfg.rnnt_type,
                  delay_penalty=loss_cfg.delay_penalty, reduction="sum", calc_gradients=True,
                  impl=loss_cfg.impl)
    if loss_cfg.lm_only_scale or loss_cfg.am_only_scale:
        simple_loss, (px_grad, py_grad) = rnnt_loss_smoothed(
            simple_lm, simple_am, symbols, lm_only_scale=loss_cfg.lm_only_scale,
            am_only_scale=loss_cfg.am_only_scale, **common)
    else:
        simple_loss, (px_grad, py_grad) = rnnt_loss_simple(simple_lm, simple_am, symbols, **common)
    # the occupancies are not differentiable: they only pick the int ranges
    ranges = get_rnnt_prune_ranges(px_grad, py_grad, boundary, loss_cfg.s_range, impl=loss_cfg.impl)
    am_pruned, lm_pruned = do_rnnt_pruning(am, lm, ranges)
    logits = model.join(am_pruned, lm_pruned)
    pruned_loss = rnnt_loss_pruned(
        logits,
        symbols,
        ranges,
        termination_symbol=blank,
        boundary=boundary,
        rnnt_type=loss_cfg.rnnt_type,
        delay_penalty=loss_cfg.delay_penalty,
        reduction="sum",
        impl=loss_cfg.impl,
    )
    total = loss_cfg.simple_scale * simple_loss + loss_cfg.pruned_scale * pruned_loss
    metrics = {
        "loss": total,
        "simple_loss": simple_loss,
        "pruned_loss": pruned_loss,
        "frames": out_lens.sum(),
    }
    return total, metrics


@torch.no_grad()
def _flax_init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's default initialisers: Dense and Conv kernels lecun-normal
    (truncated to 2 std, std sqrt(1 / fan_in)), biases 0, LayerNorm scale 1
    and bias 0, embeddings normal with std sqrt(1 / d)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()  # in (/ groups) x kernel extent
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, 0.0, math.sqrt(1.0 / mod.weight.shape[1]),
                            generator=generator)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


@torch.no_grad()
def _torch_init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch's default initialisers, as icefall's modules have them, drawn
    from ``generator``: Linear and Conv weights kaiming-uniform with a =
    sqrt(5) (bound sqrt(1 / fan_in)) and biases U(+-sqrt(1 / fan_in));
    embeddings N(0, 1) with the padding row 0; norms' scales 1 and
    biases 0; the relative-position attention's in-projection and biases
    u, v xavier-uniform, its in- and out-projection biases 0."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())  # fan_in: in (/ groups) x kernel
            nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=generator)
            if mod.bias is not None:
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, generator=generator)
            if mod.padding_idx is not None:
                mod.weight[mod.padding_idx].zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            mod.reset_parameters()
    # after the pass above, which reaches the attention's Dense layers later
    for mod in model.modules():
        if isinstance(mod, RelPositionMultiHeadAttention):
            nn.init.xavier_uniform_(mod.in_proj.weight, generator=generator)
            nn.init.zeros_(mod.in_proj.bias)
            nn.init.zeros_(mod.out_proj.bias)
            nn.init.xavier_uniform_(mod.pos_bias_u, generator=generator)
            nn.init.xavier_uniform_(mod.pos_bias_v, generator=generator)


def init_model(
    cfg: TransducerConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> PrunedTransducer:
    """The model with flax's default initialisers (the icefall recipe's with
    torch's, :func:`_torch_init`), drawn on the CPU from ``generator`` (the
    same weights on any device), then moved to ``device``.  A CUDA device
    on a machine without one raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_model: no CUDA device (pass device='cpu' to run on the CPU)")
    model = PrunedTransducer(cfg)
    (_torch_init if cfg.icefall else _flax_init)(model, generator)
    return model.to(device)


def make_train_step(
    model: PrunedTransducer,
    optimizer: torch.optim.Optimizer,
    loss_cfg: LossConfig = LossConfig(),
    mesh=None,
) -> Callable[[Tuple[torch.Tensor, ...]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one optimizer step on ``batch =
    (features, feature_lens, symbols, symbol_lens)``; the metrics come back
    detached, on the model's device (reading them syncs the host).

    With a ``mesh``, ``batch`` is this rank's shard: the parameters and
    buffers are broadcast from the mesh's first rank once, here; each step
    all-reduces every gradient (in one flat buffer) and the metrics with
    SUM before the optimizer step, so every rank takes the same step."""
    if mesh is not None:
        broadcast_from_first([*model.parameters(), *model.buffers()], mesh)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        feats, feat_lens, syms, sym_lens = batch
        optimizer.zero_grad(set_to_none=True)
        total, metrics = pruned_transducer_loss(
            model, feats, feat_lens, syms, sym_lens, loss_cfg
        )
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            for p, g in zip(params, all_reduce_sum(grads, mesh)):
                p.grad = g
            metrics = dict(zip(metrics, all_reduce_sum(list(metrics.values()), mesh)))
        with annotate("frt.model.optimizer"):
            optimizer.step()
        return metrics

    return step
