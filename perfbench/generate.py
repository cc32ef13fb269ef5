"""The benchmark's one traffic generator.

A traffic file (``perfbench/traffic/<name>.json``) holds only parameters;
this module turns them, a configuration and ``--seed`` into the batches of
a cycle: (am, lm, symbols, boundary) of the pruned loss, the batch shape
(B, T, S) from the traffic and the vocabulary C from the configuration;
am and lm N(0, 1), symbols U[1, C), each utterance's last frame and
symbol drawn uniformly from the fractions of T and S that the file gives
(chip_smoke.py's ``make_inputs``).

Sizes come from the file's ``sizes_seed``, so every run does the same
work; ``--seed`` draws the values on the device, the order of the batches
in the cycle and the order of the rows within a batch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def card_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def host_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % (1 << 64))


def lattice_sizes(traffic: dict) -> List[np.ndarray]:
    """Per batch a [B, 2] array of (s_end, t_end)."""
    B, T, S = traffic["B"], traffic["T"], traffic["S"]
    rng = host_rng(traffic["sizes_seed"])
    out = []
    for _ in range(traffic["batches"]):
        lo, hi = traffic["t_end"]
        t_end = np.clip(rng.integers(int(T * lo), int(T * hi) + 1, size=B), S + 2, T)
        lo, hi = traffic["s_end"]
        s_end = np.clip(rng.integers(int(S * lo), int(S * hi) + 1, size=B), 2, S)
        out.append(np.stack([s_end, t_end], axis=1))
    return out


def lattice_batches(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    B, T, S, C = traffic["B"], traffic["T"], traffic["S"], cfg["C"]
    dtype = getattr(torch, cfg["dtype"])
    rng = host_rng(seed)
    g = card_generator(seed, device)
    sizes = lattice_sizes(traffic)
    out = []
    for i in rng.permutation(len(sizes)):
        se = sizes[i][rng.permutation(B)]
        bnd = np.zeros((B, 4), np.int32)
        bnd[:, 2:] = se
        out.append({
            "am": torch.randn((B, T, C), generator=g, device=device).to(dtype),
            "lm": torch.randn((B, S + 1, C), generator=g, device=device).to(dtype),
            "symbols": torch.randint(1, C, (B, S), generator=g, device=device, dtype=torch.int32),
            "boundary": torch.from_numpy(bnd).to(device),
        })
    return out
