"""Autoregressive Predictive Coding (APC) pretraining.

Port of speech_recognition_tools_tpu/models/apc.py: a unidirectional GRU
stack predicts the frame `time_shift` steps ahead with an L1 loss over
valid frames (the reference drives the external APC repo from
recipes/wsj/run_apc.sh:70-80).
"""

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.models.recurrent import GRUStack, dense


class APC(nn.Module):
    """GRU stack `rnn` -> Dense `postnet` back to the input width. Returns
    (prediction, hidden states)."""

    def __init__(self, input_size: int, num_layers: int = 3, hidden_size: int = 512,
                 *, device=None):
        super().__init__()
        self.rnn = GRUStack(input_size, num_layers, hidden_size, device=device)
        self.postnet = dense(hidden_size, input_size, device=device)

    def forward(self, feats, lengths):
        h = self.rnn(feats, lengths)
        return self.postnet(h), h


def apc_loss(pred, feats, lengths, time_shift: int = 3):
    """L1 between pred[:, :-k] and feats[:, k:] over valid frames."""
    k = time_shift
    p, t = pred[:, :-k], feats[:, k:]
    valid = (torch.arange(p.shape[1], device=p.device)[None, :]
             < (lengths - k)[:, None]).to(p.dtype)[..., None]
    return ((p - t).abs() * valid).sum() / (valid.sum() * p.shape[-1]).clamp_min(1.0)
