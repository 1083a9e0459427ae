"""Recurrent acoustic model: masked GRU stack + frame classifier.

Port of speech_recognition_tools_tpu/models/recurrent.py::length_mask,
MaskedGRULayer, GRUStack and RNNClassifier (reference nnetRNN,
nnet_models.py:54). Each layer runs over the padded batch with its carry
frozen past each utterance's length and its padded outputs zeroed, which
matches packed-sequence semantics on valid frames.

The gate algebra is flax.linen.GRUCell's:

    r  = sigmoid(W_ir x + b_ir + W_hr h)
    z  = sigmoid(W_iz x + b_iz + W_hz h)
    n  = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Weights are stored gate-stacked (r|z|n) as weight_ih (3H, D), bias_ih
(3H,), weight_hh (3H, H) and bias_hn (H,); io/jax_params.py maps the JAX
package's parameter tree onto them. The input projection runs as one matmul
over all frames, then a loop over time steps does the recurrent part (plain
PyTorch; cuDNN's GRU is not used).
"""

import math

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, T) boolean validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


class MaskedGRULayer(nn.Module):
    """One GRU layer over (B, T, D) with the carry frozen past `lengths`."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        H = hidden_size
        kw = dict(device=device, dtype=dtype)
        self.hidden_size = H
        self.weight_ih = nn.Parameter(torch.empty(3 * H, input_size, **kw))
        self.bias_ih = nn.Parameter(torch.empty(3 * H, **kw))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H, **kw))
        self.bias_hn = nn.Parameter(torch.empty(H, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.rand(p.shape, generator=generator, dtype=p.dtype)
                        .mul_(2 * bound).sub_(bound))

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = inputs.shape
        H = self.hidden_size
        mask = length_mask(lengths, T)
        xi = torch.nn.functional.linear(inputs, self.weight_ih, self.bias_ih)
        h = inputs.new_zeros((B, H))
        outs = []
        for t in range(T):
            hh = h @ self.weight_hh.T
            x_r, x_z, x_n = xi[:, t].split(H, dim=-1)
            h_r, h_z, h_n = hh.split(H, dim=-1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            n = torch.tanh(x_n + r * (h_n + self.bias_hn))
            h_new = (1.0 - z) * n + z * h
            keep = mask[:, t, None]
            h = torch.where(keep, h_new, h)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        return torch.stack(outs, dim=1)


class GRUStack(nn.Module):
    """Stack of masked GRU layers with dropout between layers only
    (reference nnetRNN :80-82); dropout acts in training mode only."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            MaskedGRULayer(input_size if i == 0 else hidden_size, hidden_size,
                           device=device, dtype=dtype)
            for i in range(num_layers)
        )
        self.dropout = nn.Dropout(dropout)

    def forward(self, inputs, lengths):
        x = inputs
        for i, layer in enumerate(self.layers):
            x = layer(x, lengths)
            if i + 1 < len(self.layers):
                x = self.dropout(x)
        return x


class RNNClassifier(nn.Module):
    """GRU stack + per-frame linear output (reference nnetRNN :54).

    `device` defaults to "cuda" and raises without a card; pass "cpu" to
    build the model on the CPU. On CUDA it switches TF32 off process-wide
    (device.configure_cuda), so its matmuls run in full float32.
    """

    def __init__(self, input_size: int, num_layers: int, hidden_size: int,
                 out_size: int, dropout: float = 0.0, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        self.gru = GRUStack(input_size, num_layers, hidden_size, dropout,
                            device=dev, dtype=dtype)
        self.regression = nn.Linear(hidden_size, out_size, device=dev, dtype=dtype)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T, D) features, (B,) lengths -> (B, T, out_size) logits."""
        return self.regression(self.gru(inputs, lengths))
