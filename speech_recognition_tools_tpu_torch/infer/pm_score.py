"""Per-utterance performance-monitoring (PM) confidence scores.

Port of speech_recognition_tools_tpu/infer/pm_score.py (reference
pm_score_contrastive_ae_multilayer.py :150-260, pm_score_feedforward_AEAR.py,
pm_score_feedforward_generative.py): a frozen autoencoder reconstructs
mean-normalised AM outputs; the score is the mean reconstruction loss, or
the contrastive mean over frames of the positive loss over the time-shifted
negatives' loss. `pm(seq, lengths)` is the PM model's call; its first
output (or its output) is the reconstruction.
"""

import torch


def _framewise(kind, pred, target):
    if kind == "l1":
        return (pred - target).abs().mean(-1)
    return ((pred - target) ** 2).mean(-1)


def _recon(pm, seq, lengths):
    out = pm(seq, lengths)
    return out[0] if isinstance(out, tuple) else out


def pm_score_reconstruction(pm, seq, lengths, loss="mse"):
    """Mean reconstruction loss per utterance of seq (B, T, D) -> (B,)."""
    fw = _framewise(loss, _recon(pm, seq, lengths), seq)
    mask = (torch.arange(seq.shape[1], device=seq.device)[None, :]
            < lengths[:, None]).to(fw.dtype)
    return (fw * mask).sum(1) / mask.sum(1).clamp_min(1.0)


def pm_score_contrastive(pm, seq, lengths, time_shifts=(3, 5, 7), loss="l1",
                         neg_weight=1.0):
    """mean(pos / neg) per utterance over the frames [max_ts, T - max_ts - 1)
    that are valid before lengths - max_ts - 1, the negatives at +- each
    time shift (reference :227-257)."""
    recon = _recon(pm, seq, lengths)
    max_ts = max(time_shifts)
    lo, hi = max_ts, seq.shape[1] - max_ts - 1
    pos = _framewise(loss, recon[:, lo:hi], seq[:, lo:hi])
    neg = torch.zeros_like(pos)
    for t in time_shifts:
        neg = neg + _framewise(loss, recon[:, lo:hi], seq[:, lo + t:hi + t])
        neg = neg + _framewise(loss, recon[:, lo:hi], seq[:, lo - t:hi - t])
    neg = neg * neg_weight / (2 * len(time_shifts))
    ratio = pos / neg.clamp_min(1e-12)
    valid = (torch.arange(lo, hi, device=seq.device)[None, :]
             < (lengths[:, None] - max_ts - 1)).to(ratio.dtype)
    return (ratio * valid).sum(1) / valid.sum(1).clamp_min(1.0)
