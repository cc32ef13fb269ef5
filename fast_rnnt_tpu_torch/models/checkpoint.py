"""Checkpoint and resume of a training run (PyTorch counterpart of
``fast_rnnt_tpu/models/checkpoint.py``): ``{"params": state_dict,
"opt_state": optimizer.state_dict()}`` saved with ``torch.save`` under
``<ckpt_dir>/<step>/state.pt``, the newest ``max_to_keep`` steps kept.

The format is not orbax's: JAX weights come across through
``utils.params_from_flax``, not through a checkpoint."""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "state.pt"


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(ckpt_dir)
        if name.isdigit() and os.path.isfile(os.path.join(ckpt_dir, name, _FILE))
    )


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    max_to_keep: int = 3,
) -> None:
    """Save a training checkpoint at ``step`` (``params``: a state_dict;
    ``opt_state``: an optimizer's state_dict), then delete all but the
    newest ``max_to_keep`` steps."""
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    step_dir = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(step_dir, _FILE))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(x: Any, template: Any) -> Any:
    """``x`` with each tensor moved to the device and dtype of the
    template's tensor at the same place."""
    if isinstance(x, torch.Tensor) and isinstance(template, torch.Tensor):
        return x.to(device=template.device, dtype=template.dtype)
    if isinstance(x, dict) and isinstance(template, dict):
        return {k: _like(v, template[k]) if k in template else v for k, v in x.items()}
    if isinstance(x, (list, tuple)) and isinstance(template, (list, tuple)):
        return type(x)(_like(a, b) for a, b in zip(x, template))
    return x


def restore_checkpoint(
    ckpt_dir: str,
    step: Optional[int] = None,
    template: Any = None,
) -> Tuple[int, Any]:
    """Restore (step, state), the newest step when ``step`` is None.
    ``template`` (a matching tree of tensors, e.g. ``{"params":
    model.state_dict()}``) pins devices and dtypes; without it tensors come
    back on the CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    state = torch.load(os.path.join(ckpt_dir, str(int(step)), _FILE),
                       map_location="cpu", weights_only=True)
    if template is not None:
        state = _like(state, template)
    return step, state
