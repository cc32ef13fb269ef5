"""The port's edit distance and token error rate against the JAX
package's (exact integers), its opt-in value checks of the loss inputs
against the JAX package's checkify messages, and its checkpoints (save,
restore, pruning to ``max_to_keep``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.models.metrics import edit_distance as jedit_distance
from fast_rnnt_tpu.models.metrics import token_error_rate as jtoken_error_rate
from fast_rnnt_tpu_torch.models import edit_distance, token_error_rate
from fast_rnnt_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from fast_rnnt_tpu_torch.utils import checkify_rnnt_inputs


def _pairs(seed, B=12, S_ref=9, S_hyp=11, V=5):
    rng = np.random.default_rng(seed)
    refs = rng.integers(1, V, size=(B, S_ref)).astype(np.int32)
    hyps = rng.integers(1, V, size=(B, S_hyp)).astype(np.int32)
    ref_lens = rng.integers(0, S_ref + 1, size=B).astype(np.int32)
    hyp_lens = rng.integers(0, S_hyp + 1, size=B).astype(np.int32)
    # empty hypothesis, empty reference, both empty, identical
    hyp_lens[0], ref_lens[1], ref_lens[2], hyp_lens[2] = 0, 0, 0, 0
    hyps[3, :S_ref], hyp_lens[3], ref_lens[3] = refs[3], S_ref, S_ref
    return refs, ref_lens, hyps, hyp_lens


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_distance_and_ter_match_jax(seed):
    arrays = _pairs(seed)
    want = np.asarray(jedit_distance(*(jnp.asarray(a) for a in arrays)))
    got = edit_distance(*(torch.tensor(a) for a in arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 0 and got[0] == arrays[1][0] and got[1] == arrays[3][1]
    jter, jinfo = jtoken_error_rate(*(jnp.asarray(a) for a in arrays))
    ter, info = token_error_rate(*(torch.tensor(a) for a in arrays))
    assert ter.item() == pytest.approx(float(jter), rel=1e-7)
    np.testing.assert_array_equal(info["edits"].numpy(), np.asarray(jinfo["edits"]))
    assert int(info["ref_tokens"]) == int(jinfo["ref_tokens"])


def test_token_error_rate_all_empty_references():
    z = torch.zeros((2, 3), dtype=torch.int32)
    ter, info = token_error_rate(z, torch.zeros(2, dtype=torch.int32), z + 1,
                                 torch.tensor([2, 0], dtype=torch.int32))
    assert int(info["ref_tokens"]) == 1 and ter.item() == 2.0


SYM = torch.tensor([[1, 2], [3, 9]], dtype=torch.int32)
BND = torch.tensor([[0, 0, 2, 5], [0, 0, 2, 5]], dtype=torch.int32)


def test_checkify_accepts_good_inputs():
    checkify_rnnt_inputs(SYM, C=10, boundary=BND, S=2, T=5)
    checkify_rnnt_inputs(SYM, C=10)


@pytest.mark.parametrize("change,match", [
    (lambda s, b: (s - 2, b), "symbols must be >= 0"),
    (lambda s, b: (s + 3, b), "symbols must be < C=10"),
    (lambda s, b: (s, b - torch.tensor([1, 0, 0, 0], dtype=torch.int32)), "begin must be >= 0"),
    (lambda s, b: (s, b + torch.tensor([3, 0, 0, 0], dtype=torch.int32)), "s_begin must be <= s_end"),
    (lambda s, b: (s, b + torch.tensor([0, 6, 0, 0], dtype=torch.int32)), "t_begin must be <= t_end"),
    (lambda s, b: (s, b + torch.tensor([0, 0, 1, 0], dtype=torch.int32)), "s_end must be <= S=2"),
    (lambda s, b: (s, b + torch.tensor([0, 0, 0, 1], dtype=torch.int32)), "t_end must be <= T=5"),
], ids=["sym-neg", "sym-C", "begin", "s-order", "t-order", "s-end", "t-end"])
def test_checkify_raises_the_jax_messages(change, match):
    sym, bnd = change(SYM, BND)
    with pytest.raises(ValueError, match=match):
        checkify_rnnt_inputs(sym, C=10, boundary=bnd, S=2, T=5)


def test_checkpoint_roundtrip_and_max_to_keep(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ck)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    for step in (1, 4, 7, 9):
        save_checkpoint(ck, step, model.state_dict(), opt.state_dict())
    assert latest_step(ck) == 9
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["4", "7", "9"]
    template = {"params": {k: v.double() for k, v in model.state_dict().items()}}
    step, state = restore_checkpoint(ck, template=template)
    assert step == 9 and state["params"]["weight"].dtype == torch.float64
    torch.testing.assert_close(state["params"]["weight"].float(), model.weight.detach())
    step, state = restore_checkpoint(ck, step=4)
    opt2 = torch.optim.AdamW(torch.nn.Linear(3, 2).parameters(), lr=1e-3, weight_decay=1e-4)
    opt2.load_state_dict(state["opt_state"])
    assert step == 4 and opt2.state_dict()["state"][0]["step"] == 1
    save_checkpoint(ck, 10, model.state_dict(), max_to_keep=1)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["10"]
    assert set(restore_checkpoint(ck)[1]) == {"params"}
