"""Streaming (online) FDLP feature extraction.

Port of speech_recognition_tools_tpu/dsp/streaming.py: feed audio in
chunks of any size, receive finalised feature frames with bounded latency,
equal to `fdlp_spectrogram_batch` on the concatenated signal.

FDLP's analysis windows start every `hop` samples and each contributes a
kk-frame envelope to the 100 Hz output by overlap-add. The streamer

  * buffers raw samples on the host; analysis window k (original samples
    [k*hop - extend, k*hop - extend + flen)) can be computed once the
    stream holds k*hop + flen - extend samples (the left reflect pad comes
    from the first samples);
  * runs blocks of up to `block_frames` ready windows through
    dsp/fdlp.py::window_envelopes, the batch path's own function (K1 on a
    CUDA float32 block, its plain version on the CPU);
  * overlap-adds the envelopes into a float64 host accumulator and emits
    output frame t, as log(clip(., 1e-14)) in float64 cast to float32,
    once no later analysis window can touch it;
  * `finish()` reflects the tail exactly as the batch framing does and
    flushes the remaining frames, ceil(n * frate / srate) in all.

A block solves F x nfilters LPC problems (F <= block_frames). K1's launch
plan depends only on (order, lim), so each row's cepstra do not depend on
the block size; the banded-autocorrelation products may take another
cuBLAS algorithm at another batch size, so on a card streamed and batch
features agree to the float32 chain's sensitivity, not bit for bit. On the
CPU they agree to ~1e-5.
"""

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.dsp.fdlp import (
    FdlpConfig,
    _setup,
    window_envelopes,
)
from speech_recognition_tools_tpu_torch.ops.framing import frame_count


class StreamingFdlp:
    """Chunked FDLP extraction:

        s = StreamingFdlp(cfg, device="cuda")
        for chunk in audio_chunks:
            feats = s.process(chunk)   # (t, nfilters) finalised frames
        feats_tail = s.finish()        # the remaining frames

    `block_frames` is how many analysis windows go to the device at once;
    `dtype` float64 serves the CPU parity tests. `device` defaults to
    "cuda" and raises without a card.
    """

    def __init__(self, cfg: FdlpConfig = FdlpConfig(), block_frames: int = 8,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if cfg.precision != "fast":
            raise ValueError("streaming supports the fast (f32) path")
        self.cfg = cfg
        self.block_frames = block_frames
        self.dtype = dtype
        self.device, c, self._k = _setup(cfg, dtype, device)
        self._c = c
        self._fp = c["fp"]
        self._buf = np.zeros(0, np.float32)
        self._next_frame = 0  # next analysis window to compute
        self._emitted = 0  # output frames already emitted
        self._acc = np.zeros((c["fbank"].shape[0], 0), np.float64)
        self._acc_start = 0  # output index of acc[:, 0]
        self._finished = False

    def _window(self, k, total=None):
        """Original-coordinate samples of analysis window k, reflected at
        the start (and at the end when `total` is given)."""
        fp = self._fp
        lo = k * fp.frate_samples - fp.extend
        idx = np.arange(lo, lo + fp.flength_samples)
        n = total if total is not None else self._buf.size
        period = max(2 * (n - 1), 1)
        m = np.mod(idx, period)
        return self._buf[np.minimum(m, period - m)]

    def block_windows(self, ks, total=None):
        """(len(ks), flen) raw analysis windows ks as one block."""
        return np.stack([self._window(k, total) for k in ks])

    def _compute_frames(self, upto, total=None):
        """Run analysis windows [_next_frame, upto) and overlap-add them."""
        while self._next_frame < upto:
            hi = min(upto, self._next_frame + self.block_frames)
            ks = range(self._next_frame, hi)
            wins = torch.as_tensor(self.block_windows(ks, total)).to(
                device=self.device, dtype=self.dtype)
            env = window_envelopes(wins, self.cfg, self._k).cpu().numpy()  # (F, nb, kk)
            for j, k in enumerate(ks):
                self._ola_add(k, env[j])
            self._next_frame = hi

    def _ola_add(self, k, env_k):
        """Add window k's (nb, kk) envelope at its batch OLA position."""
        c = self._c
        kkb2, hop = c["kkb2"], c["hop"]
        if k == 0:
            pos, vals = 0, env_k[:, kkb2:]
        else:
            pos, vals = (hop - kkb2) + (k - 1) * hop, env_k
        need = pos + vals.shape[1] - self._acc_start
        if need > self._acc.shape[1]:
            self._acc = np.concatenate(
                [self._acc, np.zeros((self._acc.shape[0], need - self._acc.shape[1]))], axis=1)
        lo = pos - self._acc_start
        if lo < 0:  # contributions before already-emitted frames: clipped
            vals = vals[:, -lo:]
            lo = 0
        self._acc[:, lo : lo + vals.shape[1]] += vals

    def _emit(self, final_upto):
        """The finalised output frames [_emitted, final_upto)."""
        if final_upto <= self._emitted:
            return np.zeros((0, self._acc.shape[0]), np.float32)
        take = final_upto - self._emitted
        if take > self._acc.shape[1]:
            self._acc = np.concatenate(
                [self._acc, np.zeros((self._acc.shape[0], take - self._acc.shape[1]))], axis=1)
        chunk = self._acc[:, :take]
        self._acc = self._acc[:, take:]
        self._acc_start += take
        self._emitted = final_upto
        return np.log(np.clip(chunk.T, 1e-14, None)).astype(np.float32)

    def process(self, samples):
        """Feed a chunk; returns the finalised (t, nfilters) log frames."""
        assert not self._finished, "stream already finished"
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        n = self._buf.size
        fp = self._fp
        # window k needs no end reflection iff its last tap is inside the
        # stream (k*hop + flen - ext <= n); the left reflection needs ext+1
        if n < fp.extend + 2:
            return np.zeros((0, self._acc.shape[0]), np.float32)
        ready = max((n - fp.flength_samples + fp.extend) // fp.frate_samples + 1, 0)
        self._compute_frames(ready)
        if self._next_frame == 0:
            return self._emit(0)
        # output frame t is final once no later window overlaps it: window
        # k >= 1 starts at (hop - kkb2) + (k-1)*hop
        c = self._c
        safe = (c["hop"] - c["kkb2"]) + (self._next_frame - 1) * c["hop"]
        return self._emit(max(safe, 0))

    def finish(self):
        """Compute the tail windows with end reflection and emit the rest;
        the stream's frames total ceil(n * frate / srate)."""
        assert not self._finished
        self._finished = True
        n = self._buf.size
        self._compute_frames(int(frame_count(n, self._fp)), total=n)
        return self._emit(int(-((-n * self.cfg.frate) // self.cfg.srate)))
