"""Batched overlapping-frame extraction with reflect padding.

Port of speech_recognition_tools_tpu/ops/framing.py. The frame geometry is
the reference generator's (featgen/features.py:118-154 getFrames): the
signal is reflect-padded by `extend` samples, frames of `flength` seconds
are taken every `srate/frate` samples, and each frame is windowed.

All frames are cut with one gather (the JAX package's
`_frame_signal_gather` formulation). Reflection happens at each
utterance's true length num_samples[b], not at the padded length. The JAX
package's strided-slice paths exist for XLA's static shapes and produce
the same frames.
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FrameParams:
    """Static frame geometry (all Python ints, computed like the reference)."""

    flength_samples: int  # window length in samples
    frate_samples: int  # hop in samples
    sp_b: int  # samples before center
    sp_f: int  # samples after center
    extend: int  # reflect-pad amount


def frame_params(srate: float, frate: float, flength: float) -> FrameParams:
    """Mirror the int()/float arithmetic of the reference exactly; the hop is
    int(srate / frate) (frate may be a float such as the FDLP low frame
    rate)."""
    flength_samples = int(srate * flength)
    frate_samples = int(srate / frate)
    if flength_samples % 2 == 0:
        sp_b = flength_samples // 2 - 1
        sp_f = flength_samples // 2
        extend = flength_samples // 2 - 1
    else:
        sp_b = (flength_samples - 1) // 2
        sp_f = (flength_samples - 1) // 2
        extend = (flength_samples - 1) // 2
    return FrameParams(flength_samples, frate_samples, sp_b, sp_f, extend)


def frame_count(num_samples, params: FrameParams):
    """Frames the reference generator yields for `num_samples` samples: the
    number of k >= 0 with sp_b + k*hop + sp_f < n + 2*extend.

    Takes a Python int (returns an int) or an integer tensor."""
    hop = params.frate_samples
    limit = num_samples + 2 * params.extend - params.sp_b - params.sp_f
    if isinstance(num_samples, torch.Tensor):
        return torch.clamp(-torch.div(-limit, hop, rounding_mode="floor"), min=0)
    return max(0, -(-int(limit) // hop))


def _reflect_index(g: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Map integer indices g onto [0, n) by numpy's 'reflect' rule (no edge
    repetition), any number of reflections; safe for n == 1."""
    period = torch.clamp(2 * (n - 1), min=1)
    m = torch.remainder(g, period)
    return torch.minimum(m, period - m)


def frame_signal(
    signals: torch.Tensor,
    num_samples: torch.Tensor,
    params: FrameParams,
    window: torch.Tensor,
    max_frames: int,
):
    """Windowed frames of a zero-padded batch.

    Args:
      signals: (B, Nmax) zero-padded waveforms.
      num_samples: (B,) integer tensor of true lengths.
      params: frame geometry.
      window: (flength_samples,) window values.
      max_frames: frame-count bound (frame_count(Nmax, params)).

    Returns:
      frames: (B, max_frames, flength_samples); frames past an utterance's
        frame count are garbage (mask with num_frames).
      num_frames: (B,) valid frame counts.
    """
    B = signals.shape[0]
    hop, flen = params.frate_samples, params.flength_samples
    dev = signals.device
    k = torch.arange(max_frames, device=dev)[:, None]
    t = torch.arange(flen, device=dev)[None, :]
    g = k * hop + t - params.extend  # (F, flen) original-coordinate index
    n = num_samples.to(device=dev, dtype=torch.int64)
    idx = _reflect_index(g[None], n[:, None, None])  # (B, F, flen)
    frames = torch.gather(signals, 1, idx.reshape(B, -1)).reshape(
        B, max_frames, flen
    )
    return frames * window, frame_count(n, params)
