"""Cepstral mean/variance normalisation over padded batches.

Port of speech_recognition_tools_tpu/utils/cmvn.py: cmvn_stats,
cmvn_stats_masked, apply_cmvn and apply_cmvn_per_utterance (the reference
shells out to Kaldi compute-cmvn-stats / apply-cmvn). Every standard
deviation is the population one (jnp.std's ddof 0).
"""

import torch


def _frame_mask(feats: torch.Tensor, num_frames: torch.Tensor) -> torch.Tensor:
    T = feats.shape[1]
    idx = torch.arange(T, device=feats.device)[None, :]
    return (idx < num_frames.to(feats.device)[:, None]).to(feats.dtype)


def cmvn_stats(feats: torch.Tensor):
    """Global mean/std over every axis but the last. feats: (T, D) or
    (B, T, D). Returns ((D,), (D,))."""
    dims = tuple(range(feats.ndim - 1))
    return feats.mean(dim=dims), feats.std(dim=dims, correction=0)


def cmvn_stats_masked(feats: torch.Tensor, num_frames: torch.Tensor):
    """Global mean/std over the valid frames of a padded batch.

    feats: (B, T, D); num_frames: (B,). Returns ((D,), (D,)).
    """
    m = _frame_mask(feats, num_frames)[..., None]
    count = m.sum()
    mean = (feats * m).sum(dim=(0, 1)) / count
    var = ((feats - mean) ** 2 * m).sum(dim=(0, 1)) / count
    return mean, torch.sqrt(var)


def apply_cmvn(feats, mean, std, norm_var: bool = True):
    out = feats - mean
    if norm_var:
        out = out / torch.where(std == 0, torch.ones_like(std), std)
    return out


def apply_cmvn_per_utterance(feats, num_frames, norm_var: bool = True):
    """Per-utterance CMVN over a padded batch (the reference's apply-cmvn
    per-utt mode). feats: (B, T, D); num_frames: (B,)."""
    m = _frame_mask(feats, num_frames)
    m3 = m[..., None]
    count = torch.clamp(m.sum(dim=1), min=1.0)[:, None]
    mean = (feats * m3).sum(dim=1) / count
    out = (feats - mean[:, None, :]) * m3
    if norm_var:
        var = ((feats - mean[:, None, :]) ** 2 * m3).sum(dim=1) / count
        std = torch.sqrt(var)
        out = out / torch.where(std == 0, torch.ones_like(std), std)[:, None, :]
    return out
