"""Continuous-batching streaming ASR server (PyTorch port of
``fast_rnnt_tpu/models/serving.py``).

Independent audio streams share a fixed number of decode slots on the
model's device:

  * each step, finished slots are re-armed for queued streams by
    :func:`streaming.streaming_reset` (a per-leaf ``where``);
  * per-stream progress counters (the encoder's ``seen``, ``decoded_t``)
    let slots sit at different positions of different utterances while
    sharing every batched product.

A reset restores the exact :func:`streaming.streaming_init` leaves, so a
stream decodes to the offline tokens whatever slot it lands in and
whatever decoded there before (tests/test_torch_serving.py).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .streaming import StreamingConfig, streaming_init, streaming_reset, streaming_step
from .transducer import PrunedTransducer

__all__ = ["StreamServer"]


@dataclasses.dataclass
class _Slot:
    stream_id: Any
    feats: np.ndarray  # (T, feature_dim) float32
    cursor: int = 0  # input frames already fed

    @property
    def done_feeding(self) -> bool:
        return self.cursor >= len(self.feats)


class StreamServer:
    """Multiplex independent audio streams over ``capacity`` decode slots.

    Usage::

        server = StreamServer(model, StreamingConfig(chunk=32), capacity=128)
        server.submit("utt-1", feats_1)     # (T1, feature_dim) numpy
        server.submit("utt-2", feats_2)
        while not server.idle:
            for stream_id, tokens in server.step():
                handle(stream_id, tokens)   # int32 token ids, no blanks

    ``step()`` advances every active slot by one ``chunk`` of input frames
    (slot reset, stateful encode, greedy or beam decode, on the model's
    device) and returns the streams that finished during that step.
    Feed-as-you-go streams: submit with ``final=False``, append audio with
    :meth:`extend` and end with :meth:`finish`.
    """

    def __init__(self, model: PrunedTransducer, scfg: StreamingConfig, capacity: int):
        self._model = model
        self._scfg = scfg
        self._capacity = capacity
        self._F = model.cfg.feature_dim
        self._state = streaming_init(model, scfg, capacity)
        self._device = self._state["stream_len"].device
        self._slots: List[Optional[_Slot]] = [None] * capacity
        self._open: Dict[Any, _Slot] = {}  # non-final streams by id
        self._pending: collections.deque[_Slot] = collections.deque()
        self._progressed = False

    # ------------------------------------------------------------- intake
    def submit(self, stream_id: Any, features: np.ndarray, final: bool = True):
        """Queue a stream.  ``features`` is (T, feature_dim); with
        ``final=False`` more audio may be appended by :meth:`extend` (the
        slot then stays live until :meth:`finish` is called)."""
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self._F:
            raise ValueError(f"features must be (T, {self._F}), got {feats.shape}")
        if final and len(feats) == 0:
            raise ValueError("a final stream needs at least one frame")
        slot = _Slot(stream_id, feats)
        self._pending.append(slot)
        if not final:
            self._open[stream_id] = slot

    def extend(self, stream_id: Any, features: np.ndarray):
        """Append audio to a stream submitted with ``final=False``."""
        slot = self._open[stream_id]
        slot.feats = np.concatenate([slot.feats, np.asarray(features, np.float32)], axis=0)

    def finish(self, stream_id: Any):
        """Mark a non-final stream complete (no more :meth:`extend`)."""
        del self._open[stream_id]

    # ------------------------------------------------------------- status
    @property
    def idle(self) -> bool:
        return not self._pending and all(s is None for s in self._slots)

    @property
    def active_streams(self) -> int:
        return sum(s is not None for s in self._slots) + len(self._pending)

    # --------------------------------------------------------------- step
    def step(self) -> List[Tuple[Any, np.ndarray]]:
        """Advance every slot by one chunk; return the finished streams as
        ``(stream_id, tokens)``, ``tokens`` an int32 array of the emitted
        (non-blank) token ids."""
        B, C_in = self._capacity, self._scfg.chunk

        # admit queued streams into free slots
        reset = np.zeros((B,), bool)
        for b in range(B):
            if self._slots[b] is None and self._pending:
                self._slots[b] = self._pending.popleft()
                reset[b] = True

        # assemble this step's chunk
        feats = np.zeros((B, C_in, self._F), np.float32)
        lens = np.zeros((B,), np.int32)
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            n = min(C_in, len(slot.feats) - slot.cursor)
            # a partial chunk is exact only as a stream's final chunk
            # (streaming_step): a held-open stream's partial waits for more
            # audio or finish()
            if n < C_in and slot.stream_id in self._open:
                continue
            if n > 0:
                feats[b, :n] = slot.feats[slot.cursor : slot.cursor + n]
                lens[b] = n
                slot.cursor += n

        state = self._state
        if reset.any():
            state = streaming_reset(self._model, self._scfg, state,
                                    torch.from_numpy(reset).to(self._device))
        self._state, (hyps, hyp_lens) = streaming_step(
            self._model, self._scfg, state,
            torch.from_numpy(feats).to(self._device), torch.from_numpy(lens).to(self._device),
        )

        # a stream is finished once all its input has been fed (a fed frame
        # is decoded in the step that feeds it) and it is not held open;
        # the host reads the hypotheses only then
        finished = []
        done_slots = [
            b for b, s in enumerate(self._slots)
            if s is not None and s.done_feeding and s.stream_id not in self._open
        ]
        if done_slots:
            h, hl = hyps.cpu().numpy(), hyp_lens.cpu().numpy()
            for b in done_slots:
                finished.append((self._slots[b].stream_id, h[b, : hl[b]].copy()))
                self._slots[b] = None  # re-armed at the next admission
        self._progressed = bool(reset.any() or lens.any() or finished)
        return finished

    def run(self) -> Dict[Any, np.ndarray]:
        """Drive :meth:`step` until idle; return {stream_id: tokens}.

        Raises if the server would spin without progress: every remaining
        stream is held open (``final=False``) waiting for an
        :meth:`extend` or :meth:`finish` that run() cannot deliver."""
        out: Dict[Any, np.ndarray] = {}
        while not self.idle:
            for sid, toks in self.step():
                out[sid] = toks
            if not self._progressed:
                raise RuntimeError(
                    "run() cannot finish: streams submitted with final=False "
                    "are waiting for extend()/finish()"
                )
        return out
