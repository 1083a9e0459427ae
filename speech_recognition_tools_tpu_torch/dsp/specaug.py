"""SpecAugment: time warp, frequency masking, time masking.

Port of speech_recognition_tools_tpu/dsp/specaug.py (the reference's
e2e/wsj/conf/specaug.yaml: time warp max 5, 2 freq masks F = 30, 2 time
masks T = 40, filled with the utterance mean). The random draws are split
from the arithmetic: `draw_specaug` makes them from a torch.Generator,
`spec_augment_apply` applies a given set, so a test can feed it the draws
jax.random makes and hold the result to the JAX function's. Draws are
per utterance:

  warp_center (B,) uniform [0, 1), warp_shift (B,) int in [-W, W];
  freq_width / time_width (n_masks, B) int in [0, width],
  freq_start / time_start (n_masks, B) uniform [0, 1).

The fill (the utterance mean over its valid frames) is taken from the
features before the warp, as the JAX function takes it.
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SpecAugConfig:
    max_time_warp: int = 5
    freq_mask_width: int = 30
    n_freq_masks: int = 2
    time_mask_width: int = 40
    n_time_masks: int = 2
    replace_with_zero: bool = False  # False = utterance mean (yaml default)


def draw_specaug(generator: torch.Generator, batch: int,
                 cfg: SpecAugConfig = SpecAugConfig()) -> dict:
    """The random draws of one batch, on the CPU, from `generator`."""
    W = cfg.max_time_warp

    def ints(n, hi, lo=0):
        return torch.randint(lo, hi + 1, (n, batch), generator=generator)

    def uniform(*shape):
        return torch.rand(shape, generator=generator)

    return {
        "warp_center": uniform(batch),
        "warp_shift": ints(1, W, -W)[0],
        "freq_width": ints(cfg.n_freq_masks, cfg.freq_mask_width),
        "freq_start": uniform(cfg.n_freq_masks, batch),
        "time_width": ints(cfg.n_time_masks, cfg.time_mask_width),
        "time_start": uniform(cfg.n_time_masks, batch),
    }


def _mask_axis(feats, size_axis, widths, starts, axis, fill):
    """Masks of width widths[i] (B,) starting at starts[i] * max(size - w, 1)
    along `axis` (1 = time, 2 = freq)."""
    B = feats.shape[0]
    size = feats.shape[axis]
    idx = torch.arange(size, device=feats.device)
    out = feats
    for w, u in zip(widths, starts):
        start = (u * (size_axis - w).clamp_min(1)).to(torch.int32)
        mask = (idx[None, :] >= start[:, None]) & (idx[None, :] < (start + w)[:, None])
        shape = [B, 1, 1]
        shape[axis] = size
        out = torch.where(mask.reshape(shape), fill, out)
    return out


def _time_warp(feats, lengths, center_u, shift, max_warp):
    """Piecewise-linear warp: the anchor `center` moves to center + shift;
    frames gather from the rounded source grid, valid frames only."""
    B, T, D = feats.shape
    center = (max_warp + center_u * (lengths - 2 * max_warp).clamp_min(1)).to(torch.int32)
    tgt = torch.arange(T, device=feats.device)[None, :].float()
    c = center[:, None].float()
    s = (center + shift)[:, None].float()
    L = lengths[:, None].float()
    src = torch.where(
        tgt < s,
        tgt * c / s.clamp_min(1.0),
        c + (tgt - s) * (L - c) / (L - s).clamp_min(1.0),
    )
    src = torch.round(src).to(torch.int64).clamp(0, T - 1)
    warped = feats.gather(1, src[..., None].expand(B, T, D))
    valid = torch.arange(T, device=feats.device)[None, :, None] < lengths[:, None, None]
    return torch.where(valid, warped, feats)


def spec_augment_apply(feats, lengths, draws: dict, cfg: SpecAugConfig = SpecAugConfig()):
    """Apply SpecAugment with the given draws to a padded (B, T, D) batch."""
    B, T, D = feats.shape
    d = {k: v.to(feats.device) for k, v in draws.items()}
    if cfg.replace_with_zero:
        fill = torch.zeros((B, 1, 1), dtype=feats.dtype, device=feats.device)
    else:
        m = (torch.arange(T, device=feats.device)[None, :] < lengths[:, None]).to(feats.dtype)
        mean = (feats * m[..., None]).sum((1, 2)) / (m.sum(1) * D).clamp_min(1.0)
        fill = mean[:, None, None]
    out = feats
    if cfg.max_time_warp:
        out = _time_warp(out, lengths, d["warp_center"], d["warp_shift"], cfg.max_time_warp)
    out = _mask_axis(out, torch.full((B,), D, device=feats.device), d["freq_width"],
                     d["freq_start"], axis=2, fill=fill)
    out = _mask_axis(out, lengths, d["time_width"], d["time_start"], axis=1, fill=fill)
    return out


def spec_augment(feats, lengths, generator: torch.Generator,
                 cfg: SpecAugConfig = SpecAugConfig()):
    """Apply SpecAugment to a padded (B, T, D) batch, drawing from `generator`."""
    return spec_augment_apply(feats, lengths, draw_specaug(generator, feats.shape[0], cfg), cfg)
