"""The relative-position attention's wrapper
(``ops/kernels/relpos_attention.py``) on the CPU: its plain version is the
attention written out in plain torch ops, bit for bit in values and
gradients, and the module the same function; the kernel route's checks raise on what the kernels do not
take; the CPU route counts no kernel rows.  The kernels themselves are held
on the card by ``tests/test_torch_relpos_card.py``."""

import pytest
import torch

from fast_rnnt_tpu_torch.models.transducer import RelPositionMultiHeadAttention, rel_positions
from fast_rnnt_tpu_torch.ops.kernels import relpos_attention as ra
from fast_rnnt_tpu_torch.utils import profiling

torch.set_num_threads(1)


def attention_lines(qu, k, v, bd_raw, key_mask):
    """The module's (B, H, T, T) part as plain torch ops, qu (B, T, H, hd):
    the function ``relpos_attention_plain`` has to be, bit for bit."""
    B, T, H, hd = qu.shape
    dt = qu.dtype
    ac = torch.matmul(qu.transpose(1, 2), k.permute(0, 2, 3, 1))
    bd = ra.rel_shift(bd_raw)
    w = (ac.float() + bd) * hd ** -0.5
    w = w.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    w = torch.softmax(w, dim=-1).to(dt)
    return torch.matmul(w, v.transpose(1, 2)).transpose(1, 2).reshape(B, T, H * hd)


def module_unfused(m, x, pos, key_mask):
    """The module's function with bd_raw of 2T-1 columns by a broadcast
    matmul."""
    B, T, d = x.shape
    H = m.num_heads
    hd = d // H
    q, k, v = m.in_proj(x).view(B, T, 3, H, hd).unbind(2)
    p = m.linear_pos(pos).view(2 * T - 1, H, hd).permute(1, 2, 0)
    dt = q.dtype
    qu = q + m.pos_bias_u.to(dt)
    bd_raw = torch.matmul((q + m.pos_bias_v.to(dt)).transpose(1, 2), p)
    return m.out_proj(attention_lines(qu, k, v, bd_raw, key_mask))


def _module_case(dt, T):
    g = torch.Generator().manual_seed(T)
    B, d, H = 3, 32, 4
    m = RelPositionMultiHeadAttention(d, H, dt)
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
    x = torch.randn((B, T, d), generator=g)
    mask = torch.arange(T)[None, :] < torch.tensor([T, max(T - 3, 1), 1])[:, None]
    return m, x, rel_positions(T, d), mask, torch.randn((B, T, d), generator=g)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7, 33])
def test_plain_version_is_the_attention_lines_bit_for_bit(dt, T):
    g = torch.Generator().manual_seed(T)
    B, H, hd = 3, 4, 8
    args = [torch.randn(s, generator=g).to(dt) for s in
            ((B, T, H, hd), (B, T, H, hd), (B, T, H, hd), (H, B, T, 2 * T - 1 + 3))]
    args[3] = args[3].transpose(0, 1)  # stored (H, B, T, L), as the module makes it
    mask = torch.arange(T)[None, :] < torch.tensor([T, max(T - 3, 1), 1])[:, None]
    gy = torch.randn((B, T, H * hd), generator=g).to(dt)
    outs = []
    for fn in (lambda *a: ra.relpos_attention_plain(*a).reshape(B, T, H * hd), attention_lines):
        xs = [x.clone().requires_grad_() for x in args]
        y = fn(*xs, mask)
        outs.append([y, *torch.autograd.grad(y, xs, gy)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T", [1, 7, 33])
def test_module_is_its_unfused_function(dt, tol, T):
    """The module (bd_raw by one product a head, rows padded to a multiple
    of 8) against the broadcast matmul of 2T-1 columns: values and every
    gradient within the products' rounding (the head products sum in
    another order)."""
    m, x, pos, mask, gy = _module_case(dt, T)
    outs = []
    for fn in (m.forward, lambda *a: module_unfused(m, *a)):
        xx = x.clone().requires_grad_()
        y = fn(xx, pos, mask)
        outs.append([y, *torch.autograd.grad(y, [xx, *m.parameters()], gy.to(y.dtype))])
    for a, b in zip(*outs):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-30)


def _args(B=2, T=5, H=2, hd=64, dt=torch.bfloat16, L=None):
    """Kernel-route arguments, bd_raw stored (H, B, T, L) as the module
    makes it."""
    g = torch.Generator().manual_seed(0)
    qu, k, v = (torch.randn((B, T, H, hd), generator=g).to(dt) for _ in range(3))
    bd = torch.randn((H, B, T, L or 2 * T - 1 + (-(2 * T - 1) % 8)), generator=g).to(dt)
    return qu, k, v, bd.transpose(0, 1), torch.ones((B, T), dtype=torch.bool)


def test_kernel_route_checks_dtype_and_device():
    qu, k, v, bd, mask = _args()
    ra._check(qu, k, v, bd, mask)
    with pytest.raises(TypeError):
        ra._check(qu.double(), k.double(), v.double(), bd.double(), mask)
    with pytest.raises(TypeError):
        ra._check(qu, k.float(), v, bd, mask)
    with pytest.raises(TypeError):
        ra._check(qu, k, v, bd, mask.to(torch.uint8))
    with pytest.raises(TypeError):
        ra._check(qu, k, v.to("meta"), bd, mask)


def test_kernel_route_checks_shapes():
    qu, k, v, bd, mask = _args()
    with pytest.raises(ValueError):
        ra._check(qu[0], k, v, bd, mask)
    with pytest.raises(ValueError):
        ra._check(qu, k[:, :4], v, bd, mask)
    with pytest.raises(ValueError):
        ra._check(qu, k, v, bd[..., :-1], mask)
    with pytest.raises(ValueError):
        ra._check(qu, k, v, bd, mask[:, :4])
    big = _args(hd=160, dt=torch.float32)
    with pytest.raises(ValueError):
        ra._check(*big)


def test_kernel_route_checks_strides():
    qu, k, v, bd, mask = _args()
    with pytest.raises(ValueError):  # no unit stride on the last axis
        ra._check(qu, torch.empty((2, 5, 64, 2), dtype=qu.dtype).transpose(2, 3), v, bd, mask)
    with pytest.raises(ValueError):  # bf16 rows not on 16 bytes for the tensor cores
        ra._check(qu, torch.empty((2, 5, 2, 72), dtype=qu.dtype)[..., 4:68], v, bd, mask)
    with pytest.raises(ValueError):  # rows not L apart
        ra._check(qu, k, v, torch.empty((2, 2, 5, 20), dtype=qu.dtype)[..., :9].transpose(0, 1), mask)
    with pytest.raises(ValueError):  # stored (B, H, T, L): not the module's layout
        ra._check(qu, k, v, bd.contiguous(), mask)
    with pytest.raises(ValueError):  # bf16 bd rows not on 16 bytes (L = 9)
        ra._check(*_args(L=9))
    ra._check(*_args(L=9, dt=torch.float32))  # the CUDA cores take them
    # the in-projection's strided views are taken as they are
    _, k3, v3 = torch.empty((2, 5, 3, 2, 64), dtype=qu.dtype).unbind(2)
    ra._check(qu, k3, v3, bd, mask)
    # float32 runs on the CUDA cores, which take any row offset
    f = [x.float() for x in (qu, k, v, bd)]
    ra._check(f[0], torch.empty((2, 5, 2, 72))[..., 1:65], f[2], f[3], mask)


def test_cpu_route_is_plain_and_counts_nothing(monkeypatch):
    monkeypatch.setattr(ra, "ROWS", 0)
    launches = dict(ra.LAUNCHES)
    args = _args(dt=torch.float32)
    assert torch.equal(ra.relpos_attention(*args), ra.relpos_attention_plain(*args))
    assert ra.ROWS == 0 and ra.LAUNCHES == launches
    assert profiling.counters()["model.attention.kernel_rows"] == 0


def test_counters_name_the_rows(monkeypatch):
    monkeypatch.setattr(ra, "ROWS", 1_867_200)
    assert profiling.counters()["model.attention.kernel_rows"] == 1_867_200


def test_unread_columns_of_bd_raw_change_nothing():
    """bd_raw's columns after the 2T-1 (the module pads its rows to a
    multiple of 8) are never read: the plain version on rows padded with
    noise is bit-equal, and the kernel route's checks take them."""
    qu, k, v, bd, mask = _args(dt=torch.float32, T=6, L=11)
    padded = torch.cat([bd, torch.randn(bd.shape[:3] + (5,))], dim=3).transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(ra.relpos_attention(qu, k, v, padded, mask),
                       ra.relpos_attention(qu, k, v, bd, mask))
    ra._check(qu, k, v, padded, mask)
