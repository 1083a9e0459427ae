"""Masked sequence losses.

Port of speech_recognition_tools_tpu/train/losses.py: padded batches are
masked by length rather than flattened, the same arithmetic as the JAX
package (optax's integer-label softmax cross-entropy is log_softmax and a
gather).
"""

import torch


def _mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def masked_cross_entropy(logits, labels, lengths):
    """Mean CE over valid frames. logits (B,T,C), labels (B,T) int."""
    m = _mask(lengths, logits.shape[1]).to(logits.dtype)
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[..., None].long())[..., 0]
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def masked_frame_error(logits, labels, lengths):
    """Frame error rate (%) over valid frames."""
    m = _mask(lengths, logits.shape[1])
    wrong = (logits.argmax(-1) != labels) & m
    return 100.0 * wrong.sum() / m.sum().clamp_min(1)


def masked_mse(pred, target, lengths):
    m = _mask(lengths, pred.shape[1]).to(pred.dtype)[..., None]
    return ((pred - target) ** 2 * m).sum() / (m.sum() * pred.shape[-1]).clamp_min(1.0)


def masked_l1(pred, target, lengths):
    m = _mask(lengths, pred.shape[1]).to(pred.dtype)[..., None]
    return ((pred - target).abs() * m).sum() / (m.sum() * pred.shape[-1]).clamp_min(1.0)
