"""End-to-end example with the PyTorch port: train a pruned transducer and
decode with it.

Ragged batching (the native C++ planner), the two-stage pruned RNN-T loss,
data-parallel training over the ranks of a mesh, checkpoint save and
resume, and batched greedy and beam decoding, on a synthetic copy task
(each symbol is painted into 8 feature frames, so a converged model must
transcribe the sequence).

  python examples/torch_train_and_decode.py [--steps 300] [--ckpt DIR]   (on the GPU)
  python examples/torch_train_and_decode.py --device cpu                 (on the CPU)
  torchrun --nproc-per-node N examples/torch_train_and_decode.py         (N ranks)

Under ``torchrun`` every rank builds the same batches and trains on its
slice of each; the gradients are summed over the ranks.  The last line is
a JSON object with the greedy and beam token accuracies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fast_rnnt_tpu_torch.data import RaggedBatcher
from fast_rnnt_tpu_torch.models import (
    LossConfig,
    TransducerConfig,
    greedy_search,
    init_model,
    make_train_step,
    modified_beam_search,
)
from fast_rnnt_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from fast_rnnt_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch
from fast_rnnt_tpu_torch.parallel.sharding import mesh_device

VOCAB = 16
FEAT = 16
FRAMES_PER_SYM = 8


def synth_utterance(rng, min_s=3, max_s=8):
    """Symbols painted into frames: features[t] ~ onehot(symbol) + noise."""
    S = int(rng.integers(min_s, max_s + 1))
    syms = rng.integers(1, VOCAB, size=S).astype(np.int32)
    frames = np.repeat(np.eye(FEAT, dtype=np.float32)[syms], FRAMES_PER_SYM, axis=0)
    frames = frames + 0.1 * rng.normal(size=frames.shape).astype(np.float32)
    return frames, syms


def token_accuracy(hyps, hlens, refs, rlens):
    hits = total = 0
    for h, hl, r, rl in zip(hyps, hlens, refs, rlens):
        total += int(rl)
        m = min(int(hl), int(rl))
        hits += int((h[:m] == r[:m]).sum())
    return hits / max(total, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--utts", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # torchrun's environment, if any: one process per rank
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if world > 1:
        addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        initialize_distributed(addr, world, rank, device=args.device)
    mesh = make_mesh(args.device)
    dev = mesh_device(mesh)
    n_dev = mesh.size()
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"ranks: {n_dev} ({dev})")

    rng = np.random.default_rng(0)
    data = [synth_utterance(rng) for _ in range(args.utts)]
    features = [f for f, _ in data]
    symbols = [s for _, s in data]

    cfg = TransducerConfig(
        vocab_size=VOCAB, feature_dim=FEAT, d_model=64, d_joiner=64,
        num_layers=2, num_heads=2, conv_kernel=7, dtype=torch.float32,
    )
    model = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))

    batcher = RaggedBatcher(
        max_frames=4096, max_batch=16 * n_dev, quantum=16, pad_batch_to=16 * n_dev,
    )
    batches = list(batcher.batches(features, symbols))
    log(f"{len(batches)} static-shape batches (shapes: {sorted({b[0].shape for b in batches})})")

    # optax.adamw(3e-3)'s defaults
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        start, state = restore_checkpoint(args.ckpt, template={"params": model.state_dict()})
        model.load_state_dict(state["params"])
        opt.load_state_dict(state["opt_state"])
        log(f"resumed from step {start}")
    step_fn = make_train_step(model, opt, LossConfig(s_range=4), mesh)

    # shard each distinct batch once
    device_batches = [shard_batch(b, mesh) for b in batches]
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        metrics = step_fn(device_batches[i % len(device_batches)])
        if i % 50 == 0 or i == args.steps - 1:
            log(f"step {i:4d}  loss {metrics['loss'].item():8.3f}  ({time.perf_counter() - t0:.1f}s)")
    if args.ckpt and rank == 0:
        save_checkpoint(args.ckpt, args.steps, model.state_dict(), opt.state_dict())
        log(f"checkpoint saved to {args.ckpt}")

    # decode the first batch back
    feats, flens, syms, slens = batches[0]
    f, fl = torch.from_numpy(feats).to(dev), torch.from_numpy(flens).to(dev)
    hyps, hlens = greedy_search(model, f, fl, max_len=16)
    hyps, hlens = hyps.cpu().numpy(), hlens.cpu().numpy()
    acc = token_accuracy(hyps, hlens, syms, slens)
    log(f"greedy-decode token accuracy on train batch: {acc:.1%}")
    bh, bl = modified_beam_search(model, f, fl, beam=4, max_len=16)
    bacc = token_accuracy(bh.cpu().numpy(), bl.cpu().numpy(), syms, slens)
    log(f"beam-search (H=4) token accuracy on train batch: {bacc:.1%}")
    for b in range(min(3, len(syms))):
        sl, hl = int(slens[b]), int(hlens[b])
        log(f"  ref: {syms[b][:sl].tolist()}\n  hyp: {hyps[b][:hl].tolist()}")
    log(json.dumps({"steps": args.steps, "ranks": n_dev, "greedy_accuracy": acc,
                    "beam_accuracy": bacc}))


if __name__ == "__main__":
    main()
