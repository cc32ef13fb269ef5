"""Carry the JAX package's inputs and weights over to the port.

The loss has no parameters: its state is its inputs (``am``, ``lm``,
``symbols``, ``boundary``), which the JAX package takes as numpy or jax
arrays.  :func:`from_numpy` turns such arrays into the port's tensors:
float32 and int32, on the device stated by the caller.

The transducer's weights are a flax tree; :func:`params_from_flax` turns
it into the ``state_dict`` of the port's ``PrunedTransducer``."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy", "params_from_flax"]


def from_numpy(*arrays, device):
    """Return one tensor per array on ``device``: floating arrays as
    float32, integer arrays as int32, ``None`` passed through."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            t = torch.tensor(a, dtype=torch.float32, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.tensor(a, dtype=torch.int32, device=device)
        else:
            raise TypeError(f"from_numpy takes float or integer arrays, got {a.dtype}")
        out.append(t)
    return out[0] if len(out) == 1 else tuple(out)


# flax's auto-named submodules -> the port's attribute names
_RENAME = {"LayerNorm_0": "ln", "Embed_0": "embed", "Conv_0": "conv", "Dense_1": "fc2"}


def _torch_name(parent: str, name: str) -> str:
    if name == "Dense_0":
        return "out" if parent == "joiner" else "fc1"
    if name.startswith("blocks_"):
        return "blocks." + name[len("blocks_"):]
    return _RENAME.get(name, name)


def _torch_leaf(path, leaf: str, x: np.ndarray) -> np.ndarray:
    """One flax leaf in the port's layout."""
    attn = len(path) >= 2 and path[-2] == "attn"
    if leaf == "kernel":
        if attn and path[-1] == "out":  # (heads, head_dim, d) -> (d, heads*head_dim)
            return x.reshape(-1, x.shape[-1]).T
        if attn:  # (d, heads, head_dim) -> (heads*head_dim, d)
            return x.reshape(x.shape[0], -1).T
        if x.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            return x.T
        if x.ndim == 3:  # Conv (k, in/groups, out) -> Conv1d (out, in/groups, k)
            return x.transpose(2, 1, 0)
        return x.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)
    if leaf == "bias" and attn and path[-1] != "out":
        return x.reshape(-1)
    return x


def params_from_flax(params) -> dict:
    """The port's ``PrunedTransducer`` state_dict (float32 CPU tensors)
    from the JAX model's variables (``{"params": {...}}`` or the inner
    tree, of numpy or jax arrays).  Load it with
    ``model.load_state_dict(sd, strict=True)``."""
    tree = params.get("params", params)
    out = {}

    def walk(node, path, prefix):
        for name, child in node.items():
            if isinstance(child, dict):
                parent = path[-1] if path else ""
                walk(child, path + [name], prefix + [_torch_name(parent, name)])
            else:
                key = "weight" if name in ("kernel", "scale", "embedding") else name
                x = _torch_leaf(path, name, np.asarray(child, dtype=np.float32))
                out[".".join(prefix + [key])] = torch.tensor(np.ascontiguousarray(x))

    walk(tree, [], [])
    return out
