"""Streaming feature extraction: chunked log-mel fbank with exact parity
to the offline extractor (the port's copy of
``fast_rnnt_tpu/data/features.py``).

Audio arrives in pieces of any size; each :meth:`StreamingFbank.process`
call emits every frame whose window is complete, carrying the window
overlap and the one-sample pre-emphasis context across calls
(csrc/host/features.cc:frt_fbank_ctx).  The concatenated streamed frames
are bit-identical to one offline :func:`fast_rnnt_tpu_torch.csrc.fbank_cpu`
call over the whole waveform (tests/test_torch_data.py).
"""

from __future__ import annotations

import numpy as np

from ..csrc import check_fft, load_library

__all__ = ["StreamingFbank"]


class StreamingFbank:
    """Stateful chunked fbank extractor (one stream per instance).

    Args match :func:`fast_rnnt_tpu_torch.csrc.fbank_cpu`; defaults are
    the usual ASR config (25 ms window / 10 ms hop at 16 kHz, 80 mels).
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        win_len: int = 400,
        hop: int = 160,
        n_fft: int = 512,
        n_mels: int = 80,
        low_hz: float = 20.0,
        high_hz: float = 0.0,
        preemph: float = 0.97,
    ):
        check_fft(n_fft, win_len)
        self.sample_rate = sample_rate
        self.win_len = win_len
        self.hop = hop
        self.n_fft = n_fft
        self.n_mels = n_mels
        self.low_hz = low_hz
        self.high_hz = high_hz
        self.preemph = preemph
        self.reset()

    def reset(self) -> None:
        """Start a new stream."""
        # _carry holds the unconsumed tail; once started, _carry[0] is the
        # pre-emphasis context sample (the sample before the next frame)
        self._carry = np.zeros((0,), np.float32)
        self._started = False

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Consume one audio chunk; returns (n_new_frames, n_mels) float32
        (possibly 0 rows while the first window fills)."""
        lib = load_library()
        chunk = np.ascontiguousarray(np.asarray(chunk).reshape(-1), np.float32)
        buf = np.concatenate([self._carry, chunk])
        off = 1 if self._started else 0
        avail = len(buf) - off
        if avail < self.win_len:
            self._carry = buf
            return np.zeros((0, self.n_mels), np.float32)
        n_frames = (avail - self.win_len) // self.hop + 1
        out = np.empty((n_frames, self.n_mels), np.float32)
        wav = np.ascontiguousarray(buf[off:])
        n = lib.frt_fbank_ctx(
            wav, len(wav), self.sample_rate, self.win_len, self.hop,
            self.n_fft, self.n_mels, np.float32(self.low_hz),
            np.float32(self.high_hz), np.float32(self.preemph),
            out, n_frames,
            np.int32(1 if self._started else 0),
            np.float32(buf[off - 1] if self._started else 0.0),
        )
        # keep the tail from one sample before the next frame's start
        keep_from = off + n * self.hop - 1
        self._carry = buf[max(keep_from, 0):].copy()
        self._started = True
        return out[:n]
