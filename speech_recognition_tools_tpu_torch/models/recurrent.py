"""Recurrent acoustic model: masked GRU stack + frame classifier.

Port of speech_recognition_tools_tpu/models/recurrent.py::length_mask,
MaskedGRULayer, GRUStack and RNNClassifier (reference nnetRNN,
nnet_models.py:54), and of models/cnn.py::MaskedLSTMLayer (the LSTM RNNLM's
layer; flax's OptimizedLSTMCell). Each layer runs over the padded batch with its carry
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
PyTorch; cuDNN's GRU is not used). The loop and `step` (one token at a
time, for the RNNLM's beam-search fusion) share `MaskedGRULayer.cell`, so
one gate algebra serves both.

Parameters are drawn as flax draws them (models/flax_init.py): the input
kernels lecun_normal, each recurrent gate kernel orthogonal, the biases
zero, the output layer a flax Dense; `reset_parameters(generator)` takes
an explicit torch.Generator. Dropout acts between GRU layers only and in
training mode only, as in the JAX GRUStack.
"""

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.models import flax_init


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
        """flax GRUCell's defaults: lecun_normal input kernels, orthogonal
        recurrent kernels (one draw per gate), zero biases."""
        H = self.hidden_size
        flax_init.lecun_normal_(self.weight_ih, self.weight_ih.shape[1], generator)
        for g in range(3):
            flax_init.orthogonal_(self.weight_hh[g * H:(g + 1) * H], generator)
        flax_init.zeros_(self.bias_ih)
        flax_init.zeros_(self.bias_hn)

    def cell(self, xi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step of the gate algebra: the input projection xi = W_i x +
        b_i (N, 3H) and the carry h (N, H) -> the new carry (N, H)."""
        H = self.hidden_size
        hh = h @ self.weight_hh.T
        x_r, x_z, x_n = xi.split(H, dim=-1)
        h_r, h_z, h_n = hh.split(H, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h

    def step(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One time step for a batch of inputs x (N, D) and carries h (N, H)."""
        return self.cell(torch.nn.functional.linear(x, self.weight_ih, self.bias_ih), h)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = inputs.shape
        mask = length_mask(lengths, T)
        xi = torch.nn.functional.linear(inputs, self.weight_ih, self.bias_ih)
        h = inputs.new_zeros((B, self.hidden_size))
        outs = []
        # unbind, not xi[:, t]: autograd then stacks the per-step gradients
        # once instead of filling and adding a full-size xi gradient per step
        for xi_t, keep in zip(xi.unbind(1), mask[..., None].unbind(1)):
            h_new = self.cell(xi_t, h)
            h = torch.where(keep, h_new, h)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        return torch.stack(outs, dim=1)


class MaskedLSTMLayer(nn.Module):
    """One LSTM layer over (B, T, D) with the carry (h, c) frozen past
    `lengths` and padded outputs zeroed. The gate algebra is flax's
    OptimizedLSTMCell:

        i = sigmoid(W_ii x + W_hi h + b_hi)    f, o likewise
        g = tanh(W_ig x + W_hg h + b_hg)
        c' = f * c + i * g,    h' = o * tanh(c')

    The input kernels carry no bias and the recurrent ones do, as in flax.
    Weights are stored gate-stacked (i|f|g|o): weight_ih (4H, D),
    weight_hh (4H, H) and bias_hh (4H,)."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None):
        super().__init__()
        H = hidden_size
        self.hidden_size = H
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_size, device=device))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H, device=device))
        self.bias_hh = nn.Parameter(torch.empty(4 * H, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax OptimizedLSTMCell's defaults: lecun_normal input kernels,
        orthogonal recurrent kernels (one draw per gate), zero biases."""
        H = self.hidden_size
        for g in range(4):
            flax_init.lecun_normal_(self.weight_ih[g * H:(g + 1) * H],
                                    self.weight_ih.shape[1], generator)
            flax_init.orthogonal_(self.weight_hh[g * H:(g + 1) * H], generator)
        flax_init.zeros_(self.bias_hh)

    def cell(self, xi: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """One step: the input projection xi = W_i x (N, 4H) and the carry
        (h, c) -> the new (h, c)."""
        i, f, g, o = (h @ self.weight_hh.T + self.bias_hh + xi).split(self.hidden_size, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = inputs.shape
        mask = length_mask(lengths, T)
        xi = inputs @ self.weight_ih.T
        h = c = inputs.new_zeros((B, self.hidden_size))
        outs = []
        for xi_t, keep in zip(xi.unbind(1), mask[..., None].unbind(1)):
            h_new, c_new = self.cell(xi_t, h, c)
            h, c = torch.where(keep, h_new, h), torch.where(keep, c_new, c)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        return torch.stack(outs, dim=1)


class LSTMStack(nn.Module):
    """Masked LSTM layers one after another, without dropout between them
    (the JAX RNNLM's `rnn_{i}` layers)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, *, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            MaskedLSTMLayer(input_size if i == 0 else hidden_size, hidden_size, device=device)
            for i in range(num_layers))

    def forward(self, inputs, lengths):
        x = inputs
        for layer in self.layers:
            x = layer(x, lengths)
        return x

    def step(self, x: torch.Tensor, state):
        """One time step through every layer: x (N, D), state (h, c), each
        (layers, N, H) -> the new (h, c); h's last layer is the output."""
        hs, cs = [], []
        for i, layer in enumerate(self.layers):
            x, c = layer.cell(x @ layer.weight_ih.T, state[0][i], state[1][i])
            hs.append(x)
            cs.append(c)
        return torch.stack(hs), torch.stack(cs)


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

    def step(self, x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """One time step through every layer: x (N, D), state (layers, N, H)
        -> the new state (layers, N, H); its last layer is the output."""
        new = []
        for i, layer in enumerate(self.layers):
            x = layer.step(x, state[i])
            new.append(x)
            if i + 1 < len(self.layers):
                x = self.dropout(x)
        return torch.stack(new)


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
        flax_init.dense_(self.regression)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw every parameter as the JAX model's `init` does, from
        `generator` (a CPU torch.Generator) in a fixed order."""
        for layer in self.gru.layers:
            layer.reset_parameters(generator)
        flax_init.dense_(self.regression, generator)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T, D) features, (B,) lengths -> (B, T, out_size) logits."""
        return self.regression(self.gru(inputs, lengths))
