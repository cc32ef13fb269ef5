"""Carry the JAX package's inputs over to the port.

The loss has no parameters: its state is its inputs (``am``, ``lm``,
``symbols``, ``boundary``), which the JAX package takes as numpy or jax
arrays.  :func:`from_numpy` turns such arrays into the port's tensors:
float32 and int32, on the device stated by the caller."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy"]


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
