"""icefall's relative-position attention between its projections, the
(B, H, T, T) part: wrapper of the CUDA kernels in
``csrc/relpos_attention.cu`` and their plain PyTorch version.

Replaces no Pallas kernel: the JAX package's model leaves its attention to
XLA.  Given the in-projection's query with the bias u added, qu, its keys
k and values v, each (B, T, H, hd), the relative-position scores
``bd_raw = (q + v_h) p^T`` (B, H, T, L) over the relative positions T-1,
..., -(T-1) and L - (2T-1) unread columns after them (on a CUDA tensor
stored (H, B, T, L), as the module makes it), and the bool ``key_mask`` (B,
T), it returns (B, T, H, hd)

    o = softmax((qu k^T + rel_shift(bd_raw)) hd^-0.5, keys masked) v,

the softmax in float32, its probabilities rounded to the inputs' dtype
before the product with v.  The kernels keep the scores and the
probabilities out of device memory: a forward that saves o and the float32
row log-sum-exp, and a backward that recomputes the probabilities from
them and writes d(bd_raw) at the shifted addresses, zeros elsewhere.

A CPU tensor runs the plain version, ordinary differentiable torch; a CUDA
tensor launches the kernels or raises.  bfloat16 and float16 at hd = 64
take the tensor-core kernels, float32 (its products in float32, as
``torch.matmul`` with TF32 off) and other head sizes up to 128 the CUDA-core
ones.  The kernels' scores qu k^T stay in float32 where the plain version
rounds them to bfloat16 or float16.

``LAUNCHES`` counts each kernel's launches and ``ROWS`` the B x H x T query
rows of each forward the kernels computed (``utils.profiling.counters``
names it ``model.attention.kernel_rows``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .wavefront import _STORAGE  # storage dtype -> the kernels' dtype code

__all__ = ["relpos_attention", "relpos_attention_plain", "rel_shift", "LAUNCHES", "ROWS"]

LAUNCHES = {"fwd": 0, "bwd_q": 0, "bwd_kv": 0}
ROWS = 0

_TC_HD = 64  # the tensor-core kernels' head size
_MAX_HD = 128  # the CUDA-core kernels' largest


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, L) scores against the relative positions, L >= 2T-1 ->
    (B, H, T, T) with out[..., i, j] = x[..., i, T-1-i+j], the position
    i - j: a strided view of the contiguous ``x`` (icefall's ``rel_shift``)."""
    x = x.contiguous()
    B, H, T, n = x.shape
    sb, sh, st, sn = x.stride()
    return x.as_strided((B, H, T, T), (sb, sh, st - sn, sn), x.storage_offset() + sn * (T - 1))


def relpos_attention_plain(qu, k, v, bd_raw, key_mask):
    """The attention as plain torch ops, (B, T, H, hd)."""
    hd = qu.shape[3]
    dt = qu.dtype
    ac = torch.matmul(qu.transpose(1, 2), k.permute(0, 2, 3, 1))  # (B, H, T, T)
    w = (ac.float() + rel_shift(bd_raw)) * hd ** -0.5  # bd promoted to float32
    w = w.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    w = torch.softmax(w, dim=-1).to(dt)
    return torch.matmul(w, v.transpose(1, 2)).transpose(1, 2)


def relpos_attention(qu, k, v, bd_raw, key_mask):
    """:func:`relpos_attention_plain`'s (B, T, H, hd) output; on a CUDA
    tensor by the kernels, differentiable w.r.t. qu, k, v and bd_raw."""
    if not qu.is_cuda:
        return relpos_attention_plain(qu, k, v, bd_raw, key_mask)
    _check(qu, k, v, bd_raw, key_mask)
    return _RelPosAttentionFn.apply(qu, k, v, bd_raw, key_mask)


def _check(qu, k, v, bd_raw, key_mask) -> None:
    """Device, dtype, shape and stride checks of the kernel route."""
    dev, dt = qu.device, qu.dtype
    if dt not in _STORAGE:
        raise TypeError(f"the attention kernels take float32, bfloat16 or float16, got {dt}")
    if qu.dim() != 4:
        raise ValueError(f"qu must be (B, T, H, hd), got shape {tuple(qu.shape)}")
    B, T, H, hd = qu.shape
    L = bd_raw.shape[3] if bd_raw.dim() == 4 and bd_raw.shape[3] >= 2 * T - 1 else 2 * T - 1
    for name, x, shape in (("k", k, qu.shape), ("v", v, qu.shape),
                           ("bd_raw", bd_raw, (B, H, T, L)), ("key_mask", key_mask, (B, T))):
        want = torch.bool if name == "key_mask" else dt
        if x.device != dev or x.dtype != want:
            raise TypeError(f"{name} must be {want} on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(x.shape)} does not fit qu {tuple(qu.shape)}")
    if not 0 < hd <= _MAX_HD:
        raise ValueError(f"the attention kernels take head sizes 1 to {_MAX_HD}, got {hd}")
    if B > 65535 or H > 65535:
        raise ValueError(f"the attention kernels take at most 65535 utterances and heads, got B={B} H={H}")
    if not bd_raw.transpose(0, 1).is_contiguous() or not key_mask.is_contiguous():
        raise ValueError("bd_raw must be stored (H, B, T, L), as the module makes it, and key_mask "
                         "contiguous")
    tc = dt != torch.float32 and hd == _TC_HD
    if tc and (any(s % 8 for s in bd_raw.stride()[:3]) or bd_raw.data_ptr() % 16):
        raise ValueError(f"bd_raw's rows must start on 16 bytes for the tensor-core kernels: strides "
                         f"{bd_raw.stride()} (L a multiple of 8), address {bd_raw.data_ptr():#x}")
    for name, x in (("qu", qu), ("k", k), ("v", v)):
        if x.stride(3) != 1 or min(x.stride()) < 0:
            raise ValueError(f"{name} must have unit stride on its last axis, got strides {x.stride()}")
        if tc and (any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16):
            raise ValueError(f"{name}'s rows must start on 16 bytes for the tensor-core kernels: "
                             f"strides {x.stride()}, address {x.data_ptr():#x}")


def _layout(bd_raw, *xs) -> ctypes.Array:
    """The b, t and h strides of each (B, T, H, hd) tensor, bd_raw's b and h
    strides and its element count, in one array."""
    return (ctypes.c_longlong * 15)(*[s for x in xs for s in x.stride()[:3]], *bd_raw.stride()[:2],
                                    bd_raw.numel())


class _RelPosAttentionFn(torch.autograd.Function):
    """The CUDA attention: (qu, k, v, bd_raw, key_mask) -> o, its VJP the
    backward kernels."""

    @staticmethod
    def forward(ctx, qu, k, v, bd_raw, key_mask):
        global ROWS
        B, T, H, hd = qu.shape
        dev, dt = qu.device, qu.dtype
        o = torch.empty((B, T, H, hd), dtype=dt, device=dev)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        if o.numel():
            p = _build.ptr
            err = _build.load_library().frt_relpos_fwd(
                p(qu), p(k), p(v), p(bd_raw), p(key_mask), _layout(bd_raw, qu, k, v, o), B, T, H, hd,
                bd_raw.shape[3], hd ** -0.5, _STORAGE[dt], p(o), p(lse), _build.stream_ptr(dev),
            )
            _build.check(err, "relpos_fwd")
            LAUNCHES["fwd"] += 1
            ROWS += B * H * T
        ctx.save_for_backward(qu, k, v, bd_raw, key_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qu, k, v, bd_raw, key_mask, o, lse = ctx.saved_tensors
        B, T, H, hd = qu.shape
        dq, dk, dv = (torch.empty_like(o) for _ in range(3))
        dbd = torch.empty_strided(bd_raw.shape, bd_raw.stride(), dtype=o.dtype, device=o.device)
        if o.numel():
            if do.stride(3) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
                do = do.clone(memory_format=torch.contiguous_format)  # expanded or offset
            D = torch.empty_like(lse)
            p = _build.ptr
            err = _build.load_library().frt_relpos_bwd(
                p(qu), p(k), p(v), p(bd_raw), p(key_mask), p(o), p(lse), p(do),
                _layout(bd_raw, qu, k, v, do), B, T, H, hd, bd_raw.shape[3], hd ** -0.5, _STORAGE[o.dtype],
                p(dq), p(dk), p(dv), p(dbd), p(D), _build.stream_ptr(o.device),
            )
            _build.check(err, "relpos_bwd")
            LAUNCHES["bwd_q"] += 1
            LAUNCHES["bwd_kv"] += 1
        return dq, dk, dv, dbd, None
