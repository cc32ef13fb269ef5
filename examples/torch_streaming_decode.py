"""Streaming transducer decoding with the PyTorch port: train a tiny causal
model to memorise a batch, decode it chunk by chunk, and check that the
streamed tokens and a one-slot ``StreamServer`` equal the offline decode.

Run:  python examples/torch_streaming_decode.py               (on the GPU)
      python examples/torch_streaming_decode.py --device cpu  (on the CPU)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fast_rnnt_tpu_torch.models import (
    LossConfig,
    StreamServer,
    StreamingConfig,
    TransducerConfig,
    greedy_search,
    init_model,
    make_train_step,
    streaming_init,
    streaming_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200, help="training steps")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = TransducerConfig(
        vocab_size=16, feature_dim=8, d_model=32, d_joiner=32,
        num_layers=1, num_heads=2, conv_kernel=7, dtype=torch.float32,
        causal=True, attention_left_context=8,  # a streaming-capable encoder
    )
    model = init_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))

    rng = np.random.default_rng(0)
    B, T_in, S = 2, 64, 4
    feats = torch.tensor(rng.normal(size=(B, T_in, cfg.feature_dim)).astype(np.float32), device=dev)
    flens = torch.full((B,), T_in, dtype=torch.int32, device=dev)
    syms = torch.tensor(rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32), device=dev)
    slens = torch.full((B,), S, dtype=torch.int32, device=dev)

    # overfit the batch with the two-stage pruned loss
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=3e-3), LossConfig(s_range=3))
    for _ in range(args.steps):
        metrics = step((feats, flens, syms, slens))
    print(f"trained: loss {metrics['loss'].item():.4f}")

    off_hyps, off_lens = greedy_search(model, feats, flens, max_len=16)

    # streaming decode, 16-frame chunks
    scfg = StreamingConfig(chunk=16, max_len=16)
    state = streaming_init(model, scfg, B)
    for i in range(T_in // scfg.chunk):
        fc = feats[:, i * scfg.chunk : (i + 1) * scfg.chunk]
        cl = (flens - i * scfg.chunk).clamp(0, scfg.chunk)
        state, (hyps, lens) = streaming_step(model, scfg, state, fc, cl)
        print(f"after chunk {i}: emitted so far = {lens.tolist()}")
    if not (torch.equal(hyps, off_hyps) and torch.equal(lens, off_lens)):
        raise SystemExit("streamed tokens differ from the offline decode")
    print("streaming == offline decode, token for token:")
    for b in range(B):
        print(f"  ref: {syms[b].tolist()}  hyp: {hyps[b, : int(lens[b])].tolist()}")

    # continuous batching: both utterances and a repeat of the first through
    # ONE slot; each admission re-arms the slot
    server = StreamServer(model, StreamingConfig(chunk=16, max_len=16), capacity=1)
    f_np = feats.cpu().numpy()
    streams = [("utt0", 0), ("utt1", 1), ("utt0-again", 0)]
    for sid, b in streams:
        server.submit(sid, f_np[b])
    results = server.run()
    oh, ol = off_hyps.cpu().numpy(), off_lens.cpu().numpy()
    for sid, b in streams:
        if not np.array_equal(results[sid], oh[b, : ol[b]]):
            raise SystemExit(f"StreamServer's {sid} differs from the offline decode")
    print("StreamServer (1 slot, 3 admissions) == offline decode")


if __name__ == "__main__":
    main()
