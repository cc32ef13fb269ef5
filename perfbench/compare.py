"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference's answer to the same inputs."""

from __future__ import annotations

import math

import torch


def rel(got, ref):
    ref = ref.detach()
    return float(((got.double() - ref).abs() / ref.abs().clamp(min=1e-30)).max())


def l2_err(got, ref):
    """Norm of the difference over the reference's norm."""
    ref = ref.detach()
    return float((got.double() - ref).norm() / ref.norm().clamp(min=1e-30))


def lattice_err(rows, px, py, bnd):
    """Largest difference between the program's lattice rows (px [S, B,
    T+1], py [S+1, B, T]) and the reference's, over the cells inside each
    utterance's boundary."""
    B, S, T1 = px.shape
    if rows is None or rows[0].shape != (S, B, T1):
        return math.inf
    s = torch.arange(S + 1, device=px.device)[None, :, None]
    t = torch.arange(T1 - 1, device=px.device)[None, None, :]
    inside_t = t < bnd[:, 3, None, None]
    in_x = (s[:, :S] < bnd[:, 2, None, None]) & inside_t
    in_y = (s <= bnd[:, 2, None, None]) & inside_t
    dx = (rows[0].permute(1, 0, 2)[:, :, : T1 - 1].double() - px[:, :, : T1 - 1]).abs()
    dy = (rows[1].permute(1, 0, 2).double() - py).abs()
    return float(max(dx[in_x].max(), dy[in_y].max()))


def cover_gaps(occ_y, r_ref, r_got, bnd):
    """Per utterance, the difference between the share of blank occupancy
    that the reference's windows and the program's cover (each frame's
    blank occupancies sum to 1); None where the shapes differ."""
    B, S1, T = occ_y.shape
    if r_got is None or r_got.shape != r_ref.shape:
        return None

    def cover(r):
        rows = r.long().clamp(0, S1 - 1)
        inside = (r >= 0) & (r < S1)
        got = torch.gather(occ_y.transpose(1, 2), 2, rows) * inside
        return got.sum(dim=(1, 2))

    return ((cover(r_ref) - cover(r_got)).abs() / bnd[:, 3].double()).tolist()


def occ_err(got_gy, ref_gy, bnd):
    """The worst utterance's mean, over its frames, of the L1 distance
    between the program's and the reference's blank occupancies of a frame
    (each sums to 1 over the rows)."""
    T = ref_gy.shape[2]
    frame = (got_gy.double() - ref_gy.detach()).abs().sum(dim=1)  # [B, T]
    inside = torch.arange(T, device=frame.device)[None, :] < bnd[:, 3, None]
    return float(((frame * inside).sum(dim=1) / bnd[:, 3].double()).max())
