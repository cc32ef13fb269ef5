"""One rank of the port's two-process data-parallel tests
(tests/test_torch_parallel.py).  Imports torch and the port only.

Each rank joins a gloo group through a ``file://`` store in the test's
directory, runs one case on its slice of a batch that every rank builds
from the same seed, and saves what the parent compares to
``<dir>/rank<r>.pt`` (tests/test_torch_parallel.py and, for the
collective census, tests/test_torch_profiling.py).

Run (by the tests):  python -m tests._torch_mp_worker <case> <rank> <world> <dir>
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_rnnt_tpu_torch import rnnt_loss_simple  # noqa: E402
from fast_rnnt_tpu_torch.data import RaggedBatcher, fbank_cpu  # noqa: E402
from fast_rnnt_tpu_torch.models import (  # noqa: E402
    LossConfig,
    PrunedTransducer,
    StreamingConfig,
    TransducerConfig,
    init_model,
    make_train_step,
    pruned_transducer_loss,
    streaming_init,
    streaming_reset,
    streaming_step,
)
from fast_rnnt_tpu_torch.models import training  # noqa: E402
from fast_rnnt_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
    data_parallel_value_and_grad,
    initialize_distributed,
    make_mesh,
    shard_batch,
)
from fast_rnnt_tpu_torch.utils import collective_census  # noqa: E402


# --- inputs, made the same way by the parent test -------------------------

def loss_inputs(seed, B=8, T=10, S=4, C=12):
    """tests/test_parallel.py's _inputs, in numpy."""
    rng = np.random.default_rng(seed)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    symbols = rng.integers(0, C, size=(B, S)).astype(np.int32)
    boundary = np.stack([np.zeros(B), np.zeros(B), np.full(B, S), np.full(B, T)], 1).astype(np.int32)
    return lm, am, symbols, boundary


TRAIN_CFG = dict(vocab_size=32, feature_dim=8, d_model=16, d_joiner=16, num_layers=1, num_heads=2,
                 conv_kernel=7)


def train_batch(seed, B=8, T_in=32, S=6):
    """tests/test_torch_models.py's batch."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T_in, TRAIN_CFG["feature_dim"])).astype(np.float32)
    feat_lens = np.clip(rng.integers(T_in // 2, T_in + 1, size=B), 28, T_in).astype(np.int32)
    syms = rng.integers(1, TRAIN_CFG["vocab_size"], size=(B, S)).astype(np.int32)
    sym_lens = rng.integers(2, S + 1, size=B).astype(np.int32)
    return feats, feat_lens, syms, sym_lens


SLICE_CFG = dict(vocab_size=32, feature_dim=80, d_model=64, d_joiner=64, num_layers=2, num_heads=2,
                 conv_kernel=7)
SLICE_UTTS, SLICE_PAD_TO = 7, 8


def slice_utterances(seed):
    """Synthetic 0.4-0.8 s waveforms at 16 kHz and their symbols."""
    rng = np.random.default_rng(seed)
    wavs = [(0.1 * rng.normal(size=int(n))).astype(np.float32)
            for n in rng.integers(6400, 12801, size=SLICE_UTTS)]
    syms = [rng.integers(1, SLICE_CFG["vocab_size"], size=int(s)).astype(np.int32)
            for s in rng.integers(3, 9, size=SLICE_UTTS)]
    return wavs, syms


def slice_batch(fbank, batcher_cls, seed):
    """audio -> fbank -> the first RaggedBatcher batch (``fbank`` and
    ``batcher_cls`` are the port's or the JAX package's)."""
    wavs, syms = slice_utterances(seed)
    feats = [fbank(w) for w in wavs]
    batcher = batcher_cls(max_frames=4096, quantum=16, pad_batch_to=SLICE_PAD_TO)
    return next(iter(batcher.batches(feats, syms)))


SERVE_CFG = dict(vocab_size=12, feature_dim=6, d_model=16, d_joiner=16, num_layers=1, num_heads=2,
                 conv_kernel=3, causal=True, attention_left_context=4)
SERVE_B, SERVE_CHUNK = 8, 8


def serve_setup(seed):
    """The causal model, its streaming config, a state advanced by one
    chunk of every stream, and the next step's (reset, feats, lens): the
    counterpart of tests/test_serving.py's sharded server step."""
    cfg = TransducerConfig(dtype=torch.float32, **SERVE_CFG)
    model = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    scfg = StreamingConfig(chunk=SERVE_CHUNK, max_len=16)
    rng = np.random.default_rng(seed)
    B, F = SERVE_B, cfg.feature_dim
    state = streaming_init(model, scfg, B)
    first = torch.tensor(rng.normal(size=(B, SERVE_CHUNK, F)).astype(np.float32))
    state, _ = streaming_step(model, scfg, state, first, torch.full((B,), SERVE_CHUNK, dtype=torch.int32))
    reset = torch.tensor(np.arange(B) % 3 == 0)
    feats = torch.tensor(rng.normal(size=(B, SERVE_CHUNK, F)).astype(np.float32))
    lens = torch.tensor(rng.integers(0, SERVE_CHUNK + 1, size=B).astype(np.int32))
    return model, scfg, state, (reset, feats, lens)


def serve_fn(model, scfg):
    def fn(state, reset, feats, lens):
        return streaming_step(model, scfg, streaming_reset(model, scfg, state, reset), feats, lens)
    return fn


# --- the cases --------------------------------------------------------------

def case_sharding(mesh, rank, world, spec):
    lm, am, symbols, boundary = loss_inputs(spec["seed"])
    out = {"shard": shard_batch((lm, am, symbols, boundary, np.float32(2.5)), mesh)}
    try:
        shard_batch(np.zeros((world * 2 + 1, 3), np.float32), mesh)
        out["indivisible_raised"] = False
    except ValueError:
        out["indivisible_raised"] = True
    args = out["shard"][:4]

    def loss_none(lm, am, symbols, boundary):
        return rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="none")

    def loss_sum(lm, am, symbols, boundary):
        return rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="sum")

    out["none"] = data_parallel(loss_none, mesh)(*args)
    out["sum"] = data_parallel(loss_sum, mesh, reduce_outputs=True)(*args)

    def loss_fn(params, lm, am, symbols, boundary):
        return loss_sum(lm * params["w_lm"], am * params["w_am"], symbols, boundary)

    params = {"w_am": torch.ones(am.shape[2]), "w_lm": torch.ones(lm.shape[2])}
    out["vg_loss"], out["vg_grads"] = data_parallel_value_and_grad(loss_fn, mesh)(params, *args)
    return out


def case_train(mesh, rank, world, spec):
    """The two-rank step's all-reduced gradients, and the sum of the two
    shards' gradients from the single-process loss and backward on a copy
    of the same model, in this process.  The second rank's weights are
    moved off before the step is built, which broadcasts the first's."""
    cfg = TransducerConfig(dtype=torch.float32, **TRAIN_CFG)
    model = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(spec["seed"]))
    loss_cfg = LossConfig(s_range=3)
    batch = train_batch(spec["seed"])
    B = len(batch[0])

    ref = copy.deepcopy(model)
    shard_grads, shard_metrics = [], []
    for k in range(world):
        sl = slice(k * B // world, (k + 1) * B // world)
        ref.zero_grad(set_to_none=True)
        total, m = pruned_transducer_loss(ref, *(torch.from_numpy(x[sl]) for x in batch), loss_cfg)
        total.backward()
        shard_grads.append({n: p.grad.clone() for n, p in ref.named_parameters()})
        shard_metrics.append({k2: v.detach() for k2, v in m.items()})

    with torch.no_grad():  # the step must start from the first rank's weights
        for p in model.parameters():
            p.add_(rank)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = make_train_step(model, opt, loss_cfg, mesh)
    metrics = step(shard_batch(batch, mesh))
    return {
        "grads": {n: p.grad for n, p in model.named_parameters()},
        "shard_sum": {n: sum(g[n] for g in shard_grads) for n in shard_grads[0]},
        "metrics": metrics,
        "shard_metrics_sum": {k: sum(m[k] for m in shard_metrics) for k in shard_metrics[0]},
        "params": {n: p.detach() for n, p in model.named_parameters()},
    }


def case_slice(mesh, rank, world, spec):
    """audio -> fbank_cpu -> RaggedBatcher -> the two-rank step from the
    JAX model's weights, stage 2 fed the JAX package's ranges."""
    model = PrunedTransducer(TransducerConfig(dtype=torch.float32, **SLICE_CFG))
    model.load_state_dict(torch.load(Path(spec["dir"]) / "weights.pt"), strict=True)
    batch = slice_batch(fbank_cpu, RaggedBatcher, spec["seed"])
    jax_ranges = torch.from_numpy(np.load(Path(spec["dir"]) / "ranges.npy"))
    local = shard_batch(batch, mesh)
    own = []
    port_ranges = training.get_rnnt_prune_ranges

    def ranges(px_grad, py_grad, boundary, s_range, impl=None):
        own.append(port_ranges(px_grad, py_grad, boundary, s_range, impl=impl))
        return shard_batch(jax_ranges, mesh)

    training.get_rnnt_prune_ranges = ranges
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    metrics = make_train_step(model, opt, LossConfig(s_range=spec["s_range"]), mesh)(local)
    return {
        "batch": local,
        "metrics": metrics,
        "grads": {n: p.grad for n, p in model.named_parameters()},
        "own_ranges": own[0],
    }


def case_serve(mesh, rank, world, spec):
    model, scfg, state, step_in = serve_setup(spec["seed"])
    args = shard_batch((state, *step_in), mesh)
    new_state, (hyps, lens) = data_parallel(serve_fn(model, scfg), mesh)(*args)
    return {"state": new_state, "hyps": hyps, "lens": lens}


def case_census(mesh, rank, world, spec):
    """``collective_census`` of ``spec["steps"]`` steps of the two-rank
    ``make_train_step`` (after one untraced step), under a profiler with
    shapes; the lattice dims are the encoder's T and T+1."""
    cfg = TransducerConfig(dtype=torch.float32, **TRAIN_CFG)
    model = init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(spec["seed"]))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = make_train_step(model, opt, LossConfig(s_range=3), mesh)
    batch = shard_batch(train_batch(spec["seed"]), mesh)
    step(batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        for _ in range(spec["steps"]):
            step(batch)
    T = -(-batch[0].shape[1] // 4)  # the encoder's frames: ceil(T_in / 4)
    shapes = [e.input_shapes for e in prof.events() if e.name.startswith("gloo:")]
    return {"census": collective_census(prof, lattice_dims=(T, T + 1)), "T": T, "shapes": shapes}


CASES = {"sharding": case_sharding, "train": case_train, "slice": case_slice, "serve": case_serve,
         "census": case_census}


def main():
    case, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    spec = json.loads((out_dir / "spec.json").read_text())
    initialize_distributed(f"file://{out_dir / 'store'}", world, rank, device="cpu")
    mesh = make_mesh("cpu")
    assert mesh.size() == world and mesh.get_local_rank() == rank
    out = CASES[case](mesh, rank, world, spec)
    torch.save(out, out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
