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


# --- batch-sharded DTensors through the losses and the ops -------------------
# (tests/test_torch_partition.py)

PART_B, PART_T, PART_S, PART_C, PART_K = 4, 13, 5, 11, 3
SMOOTH = dict(lm_only_scale=0.15, am_only_scale=0.1)


def partition_inputs(seed, B=PART_B, T=PART_T, S=PART_S, C=PART_C):
    """tests/test_gspmd.py's _inputs (ragged ends, symbols in [1, C)), in
    numpy: (lm, am, symbols, boundary)."""
    rng = np.random.default_rng(seed)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    t_end = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    s_end = rng.integers(S // 2, S + 1, size=B).astype(np.int32)
    boundary = np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], axis=1)
    return lm, am, symbols, boundary


def partition_arrays(seed):
    """Every named input of the entry-point cases, in numpy: the loss
    inputs, a random (B, S, T+1) / (B, S+1, T) lattice and occupancies (and
    their s-major rows), the port's ranges of the unsharded simple loss,
    the full and pruned joiner logits of am + lm, a score cotangent, and the
    glue ops' inputs: a [B, T, S+1] row to roll, a [B, T, K] window to
    place, raw window starts to repair."""
    from fast_rnnt_tpu_torch import get_rnnt_prune_ranges

    lm, am, symbols, boundary = partition_inputs(seed)
    B, S1, C = lm.shape
    T = am.shape[1]
    rng = np.random.default_rng(seed + 1)
    px = (2.0 * rng.normal(size=(B, S1 - 1, T + 1))).astype(np.float32)
    px[:, :, -1] = -np.inf
    py = (2.0 * rng.normal(size=(B, S1, T))).astype(np.float32)
    gx = rng.random((B, S1 - 1, T + 1)).astype(np.float32)
    gy = rng.random((B, S1, T)).astype(np.float32)
    _, (ogx, ogy) = rnnt_loss_simple(*(torch.from_numpy(a) for a in (lm, am, symbols)), 0,
                                     torch.from_numpy(boundary), reduction="sum", calc_gradients=True)
    ranges = get_rnnt_prune_ranges(ogx, ogy, torch.from_numpy(boundary), PART_K).numpy()
    lm_p = lm[np.arange(B)[:, None, None], ranges]  # (B, T, K, C)
    glue = np.random.default_rng(seed + 2)
    return {
        "lm": lm, "am": am, "symbols": symbols, "boundary": boundary,
        "px": px, "py": py, "px_rows": np.ascontiguousarray(px.transpose(1, 0, 2)),
        "py_rows": np.ascontiguousarray(py.transpose(1, 0, 2)),
        "gx": gx, "gy": gy, "gx_rows": np.ascontiguousarray(gx.transpose(1, 0, 2)),
        "gy_rows": np.ascontiguousarray(gy.transpose(1, 0, 2)),
        "ranges": ranges, "lo": np.ascontiguousarray(ranges[:, :, 0]),
        "logits": am[:, :, None, :] + lm[:, None, :, :],
        "logits_pruned": am[:, :, None, :] + lm_p,
        "ans_grad": (rng.random(B) + 0.5).astype(np.float32),
        "src": np.ascontiguousarray(py.transpose(0, 2, 1)),
        "win": np.ascontiguousarray(am[:, :, :PART_K]),
        "s_begin": glue.integers(0, S1 - PART_K + 1, size=(B, T)).astype(np.int32),
    }


def joiner(am, lm):
    return am[:, :, None, :] + lm[:, None, :, :]


# entry point -> (function name in ``ops`` or ``ops.recursion``, positional
# arguments: a name of partition_arrays' arrays, or a literal, keyword
# arguments); each one's batch-carrying arrays are Shard(0) DTensors
# (s-major rows: Shard(1))
ENTRIES = {
    "rnnt_loss_simple": ("rnnt_loss_simple", ("lm", "am", "symbols", 0, "boundary"),
                         dict(reduction="none", calc_gradients=True)),
    "rnnt_loss_smoothed": ("rnnt_loss_smoothed", ("lm", "am", "symbols", 0, 0.15, 0.1, "boundary"),
                           dict(reduction="mean")),
    "rnnt_loss": ("rnnt_loss", ("logits", "symbols", 0, "boundary"), dict(reduction="sum")),
    "rnnt_loss_chunked": ("rnnt_loss_chunked", (joiner, "am", "lm", "symbols", 0, "boundary"),
                          dict(reduction="none", chunk=4)),
    "rnnt_loss_pruned": ("rnnt_loss_pruned", ("logits_pruned", "symbols", "ranges", 0, "boundary"),
                         dict(reduction="none")),
    "rnnt_loss_pruned_simple": ("rnnt_loss_pruned_simple",
                                ("lm", "am", "symbols", "ranges", 0, "boundary"), dict(reduction="none")),
    "rnnt_loss_simple_pruned": ("rnnt_loss_simple_pruned", ("lm", "am", "symbols", 0, PART_K, "boundary"),
                                dict(reduction="none")),
    "rnnt_loss_smoothed_pruned": ("rnnt_loss_smoothed_pruned",
                                  ("lm", "am", "symbols", 0, PART_K, 0.15, 0.1, "boundary"),
                                  dict(reduction="sum")),
    "mutual_information_recursion": ("mutual_information_recursion", ("px", "py", "boundary"),
                                     dict(calc_gradients=True)),
    "mutual_information_rows": ("mutual_information_rows", ("px_rows", "py_rows", "boundary", "lo", PART_K),
                                {}),
    "occupancy_roundtrip_check": ("occupancy_roundtrip_check", ("gx", "gy", "boundary", "ans_grad"), {}),
    "get_rnnt_prune_ranges": ("get_rnnt_prune_ranges", ("gx", "gy", "boundary", PART_K), {}),
    "get_rnnt_prune_ranges_rows": ("get_rnnt_prune_ranges_rows", ("gx_rows", "gy_rows", "boundary", PART_K),
                                   {}),
    "do_rnnt_pruning": ("do_rnnt_pruning", ("am", "lm", "ranges"), {}),
    "get_rnnt_logprobs": ("get_rnnt_logprobs", ("lm", "am", "symbols", 0, "regular", "boundary"), {}),
    "get_rnnt_logprobs_smoothed": ("get_rnnt_logprobs_smoothed",
                                   ("lm", "am", "symbols", 0, 0.15, 0.1, "boundary"), {}),
    "get_rnnt_logprobs_rows": ("get_rnnt_logprobs_rows", ("lm", "am", "symbols", 0, "modified", "boundary"),
                               {}),
    "get_rnnt_logprobs_smoothed_rows": ("get_rnnt_logprobs_smoothed_rows",
                                        ("lm", "am", "symbols", 0, 0.1, 0.2, "boundary", "regular"), {}),
    "get_rnnt_logprobs_pruned": ("get_rnnt_logprobs_pruned",
                                 ("logits_pruned", "symbols", "ranges", 0, "boundary"), {}),
    "get_rnnt_logprobs_pruned_simple": ("get_rnnt_logprobs_pruned_simple",
                                        ("lm", "am", "symbols", "ranges", 0, "boundary"), {}),
    # the glue ops, which reach no kernel
    "fix_for_boundary": ("fix_for_boundary", ("px", "boundary"), {}),
    "band_mask_rows_smajor": ("band_mask_rows_smajor", ("py_rows", "lo", PART_K), {}),
    "band_mask_rows": ("band_mask_rows", ("px", "ranges"), {}),
    "get_rnnt_logprobs_joint": ("get_rnnt_logprobs_joint", ("logits", "symbols", 0, "boundary"), {}),
    "roll_by_shifts": ("roll_by_shifts", ("src", "lo"), {}),
    "scatter_window": ("scatter_window", ("win", "lo", PART_S + 1), {}),
    "adjust_pruning_lower_bound": ("adjust_pruning_lower_bound", ("s_begin", PART_K), {}),
    "viterbi_scores": ("viterbi_scores", ("px", "py", "boundary"), {}),
    "viterbi_alignment": ("viterbi_alignment", ("px", "py", "boundary"), {}),
}

# the public ops left unwrapped, entries as ENTRIES': they make no tensor
# of their own, so DTensor's sharding rules carry them
NATIVE = {
    "cummin": ("cummin", ("lo",), {}),
    "monotonic_lower_bound": ("monotonic_lower_bound", ("s_begin",), {}),
    "logaddexp": ("logaddexp", ("px", "gx"), {}),
    "safe_exp": ("safe_exp", ("py",), {}),
}

# the differentiable glue ops: name -> the arguments taking a gradient, of
# the sum of every finite output entry
GLUE_GRADS = {
    "viterbi_scores": ("px", "py"),
    "band_mask_rows": ("px",),
    "band_mask_rows_smajor": ("py_rows",),
    "get_rnnt_logprobs_joint": ("logits",),
}


def entry_function(ops, name):
    return getattr(ops, name, None) or getattr(ops.recursion, name)


def entry_args(name, arrays, make, table=None):
    """ENTRIES[name]'s (or ``table[name]``'s) positional arguments, each
    named array through ``make(name, array)``."""
    spec = (table or ENTRIES)[name][1]
    return [make(a, arrays[a]) if isinstance(a, str) and a in arrays else a for a in spec]


def glue_grad(name, args):
    """A differentiable glue op's outputs and the gradient of the sum of
    their finite entries w.r.t. its GLUE_GRADS arguments, ``args`` as
    entry_args gives them (plain tensors or DTensors)."""
    import fast_rnnt_tpu_torch.ops as ops

    wrt = [i for i, a in enumerate(ENTRIES[name][1]) if a in GLUE_GRADS[name]]
    args = [x.detach().requires_grad_() if i in wrt else x for i, x in enumerate(args)]
    out = getattr(ops, name)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    total = sum(torch.where(torch.isfinite(o), o, 0.0).sum() for o in outs)
    return (*outs, *torch.autograd.grad(total, [args[i] for i in wrt]))


def _full(out):
    """Every DTensor of a result as its global value; placements beside."""
    from torch.distributed.tensor import DTensor

    if isinstance(out, DTensor):
        return {"value": out.full_tensor().detach(), "placements": str(out.placements)}
    if isinstance(out, (tuple, list)):
        return [_full(o) for o in out]
    return out


def _pruned_step(lm, am, symbols, boundary):
    """tests/test_gspmd.py's _pruned_step: the value and gradient of
    0.5 * simple + pruned w.r.t. (lm, am), reduction "sum"."""
    from fast_rnnt_tpu_torch import rnnt_loss_simple_pruned

    lm, am = lm.detach().requires_grad_(), am.detach().requires_grad_()
    simple, pruned, ranges = rnnt_loss_simple_pruned(lm, am, symbols, 0, PART_K, boundary, reduction="sum")
    loss = 0.5 * simple + pruned
    return loss, torch.autograd.grad(loss, (lm, am)), ranges


def _smoothed_step(lm, am, symbols, boundary):
    """tests/test_gspmd.py's smoothed step: smoothed + 0.5 * pruned."""
    from fast_rnnt_tpu_torch import rnnt_loss_smoothed_pruned

    lm, am = lm.detach().requires_grad_(), am.detach().requires_grad_()
    smoothed, pruned, ranges = rnnt_loss_smoothed_pruned(lm, am, symbols, 0, PART_K, boundary=boundary,
                                                         reduction="sum", **SMOOTH)
    loss = smoothed + 0.5 * pruned
    return loss, torch.autograd.grad(loss, (lm, am)), ranges


def case_partition(mesh, rank, world, spec):
    """Every DTensor case of tests/test_torch_partition.py in one process
    start: each sub-case's results (global values, placements) and the
    trace hook's (name, per-shard batch) log."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from fast_rnnt_tpu_torch import ops
    from fast_rnnt_tpu_torch.ops.kernels import latbuild, partition, ranges, wavefront

    log = []
    partition._TRACE_HOOK = lambda name, b: log.append((name, int(b)))

    def dt(x, placement=Shard(0)):
        return distribute_tensor(torch.as_tensor(x), mesh, [placement])

    def logged(fn):
        log.clear()
        return {"out": _full(fn()), "hook": sorted(set(log))}

    arrays = partition_arrays(spec["seed"])
    lm, am, sym, bnd = (dt(arrays[k]) for k in ("lm", "am", "symbols", "boundary"))
    out = {}
    for name, (fname, _, kw) in ENTRIES.items():
        args = entry_args(name, arrays, lambda a, x: dt(x, Shard(1) if a.endswith("_rows") else Shard(0)))
        out[name] = logged(lambda: entry_function(ops, fname)(*args, **kw))

    for name, (fname, _, kw) in NATIVE.items():
        args = entry_args(name, arrays, lambda a, x: dt(x), NATIVE)
        out[f"native_{name}"] = logged(lambda: getattr(ops, fname)(*args, **kw))
    for name in GLUE_GRADS:
        args = entry_args(name, arrays, lambda a, x: dt(x, Shard(1) if a.endswith("_rows") else Shard(0)))
        out[f"grad_{name}"] = logged(lambda: glue_grad(name, args))

    out["pruned_step"] = logged(lambda: _pruned_step(lm, am, sym, bnd))
    out["smoothed_step"] = logged(lambda: _smoothed_step(lm, am, sym, bnd))
    # the kernel wrappers themselves, on s-major rows sharded on axis 1
    px, py, lo = dt(arrays["px_rows"], Shard(1)), dt(arrays["py_rows"], Shard(1)), dt(arrays["lo"])
    gx, gy = dt(arrays["gx_rows"], Shard(1)), dt(arrays["gy_rows"], Shard(1))
    out["fused_rows"] = logged(lambda: wavefront.fused_rows(px, py, bnd, lo, PART_K))

    def split():
        p, scores = wavefront.forward_rows(px, py, bnd)
        return (scores, *wavefront.backward_rows(px, py, p, bnd, torch.ones_like(scores)))

    out["split_rows"] = logged(split)
    out["window_starts"] = logged(lambda: ranges.window_starts(gy, gx, PART_K, bnd, PART_K))

    def split_vjp():  # the scores op and its VJP, B-major
        pxb, pyb = (dt(arrays[k]).requires_grad_() for k in ("px", "py"))
        scores = ops.mutual_information_recursion(pxb, pyb, bnd)
        return (scores, *torch.autograd.grad(scores.sum(), (pxb, pyb)))

    out["split_vjp"] = logged(split_vjp)

    def smoothed_glue():  # the kernel route's glue, its parts and VJP plain
        lm_g, am_g = lm.detach().requires_grad_(), am.detach().requires_grad_()
        part = partition.batch_partitioned(latbuild.lattice_rows_smoothed,
                                           {"lm": 0, "am": 0, "symbols": 0, "boundary": 0}, 1,
                                           "lattice_rows_smoothed")
        px_s, py_s = part(lm_g, am_g, sym, 0, 0.15, 0.1, bnd, "regular", "plain")
        total = px_s.exp().sum() + py_s.exp().sum()
        return (px_s, py_s, *torch.autograd.grad(total, (lm_g, am_g)))

    out["smoothed_glue"] = logged(smoothed_glue)
    # lm and am sharded on C (a non-batch axis), resharded to the batch
    out["non_batch"] = logged(lambda: _pruned_step(dt(arrays["lm"], Shard(2)), dt(arrays["am"], Shard(2)),
                                                  sym, bnd))
    # B = 3 over two ranks: replicated, run whole
    odd = [dt(arrays[k][:3]) for k in ("lm", "am", "symbols", "boundary")]
    out["indivisible"] = logged(lambda: _pruned_step(*odd))
    out["indivisible_alignment"] = logged(
        lambda: ops.viterbi_alignment(*(dt(arrays[k][:3]) for k in ("px", "py", "boundary"))))
    for red in ("none", "mean", "sum"):
        out[f"reduction_{red}"] = logged(
            lambda: ops.rnnt_loss_simple(lm, am, sym, 0, bnd, reduction=red))
    # the collectives of one step of each pipeline, the loss read back
    census = {}
    for name, step in (("pruned", _pruned_step), ("smoothed", _smoothed_step)):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            loss, grads, _ = step(lm, am, sym, bnd)
            loss.full_tensor()
        census[name] = {
            "census": collective_census(prof, lattice_dims=(PART_T, PART_T + 1)),
            "shapes": [[list(s) for s in e.input_shapes] for e in prof.events()
                       if e.name.startswith("gloo:")],
        }
    out["census"] = census
    return out


CASES = {"sharding": case_sharding, "train": case_train, "slice": case_slice, "serve": case_serve,
         "census": case_census, "partition": case_partition}


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
