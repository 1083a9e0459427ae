"""Learned-modulation networks (modnet).

Port of speech_recognition_tools_tpu/models/modnet.py (reference
nnet_models.py: modnetEncoder :755, modnetClassifier :828, modulationNet
:845, gumbel_softmax :862-883, modnetSigmoidEncoder :886,
modulationSigmoidNet :950).

A VALID conv stack looks at a (freq x time) patch; each head picks a
modulation frequency by straight-through gumbel-softmax (or, in the
sigmoid variant, weights every candidate by a sigmoid gate), the patch is
projected onto sinusoids of the picked frequencies, and an MLP classifies
the projections. The gumbel draws are uniforms on [0, 1) of the logits'
shape, one set per head, passed in (`uniforms`, a list) or drawn from a
torch.Generator (`draw_uniform`); without either the encoder raises, as the
JAX module raises without a "gumbel" rng. The candidate frequencies, the
time axis and the sigmoid variant's sin/cos tables are computed in float64
and cast to the input's dtype (under x64 the JAX modules compute them, and
what follows them, in float64).
"""

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_recognition_tools_tpu_torch.models import flax_init
from speech_recognition_tools_tpu_torch.models.cnn import Conv, _flat, _named
from speech_recognition_tools_tpu_torch.models.recurrent import dense
from speech_recognition_tools_tpu_torch.models.vae import MissingNoiseError


def draw_uniform(like: torch.Tensor, generator: torch.Generator | None):
    """U[0, 1) of `like`'s shape, dtype and device, from `generator`."""
    if generator is None:
        raise MissingNoiseError("the gumbel heads draw uniforms: pass `uniforms` or a "
                                "torch.Generator (the JAX model needs a 'gumbel' rng)")
    u = torch.rand(like.shape, generator=generator, device=generator.device, dtype=like.dtype)
    return u.to(like.device)


def gumbel_softmax(logits, temperature, u):
    """Straight-through gumbel-softmax on the uniforms `u` (reference
    gumbel_softmax :872-883): the forward value is the one-hot of the
    perturbed argmax, the gradient the soft sample's."""
    eps = 1e-20
    g = -torch.log(-torch.log(u + eps) + eps)
    y = torch.softmax((logits + g) / temperature, dim=-1)
    hard = F.one_hot(y.argmax(-1), y.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


def _grid(freq_num, wind_size, W):
    """The candidate frequencies (freq_num,) and the patch's time axis (W,),
    float64."""
    fs = (1.0 / wind_size) * torch.linspace(1.0, freq_num, freq_num, dtype=torch.float64)
    return fs, torch.linspace(0.0, wind_size, W, dtype=torch.float64)


class ModnetClassifier(nn.Module):
    """Plain ReLU MLP head (reference modnetClassifier :828)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.dense = _named(self, "dense_", [
            dense(input_size if i == 0 else hidden_size, hidden_size, device=device)
            for i in range(num_layers - 1)])
        self.out = dense(hidden_size if num_layers > 1 else input_size, out_size,
                         device=device)

    def forward(self, x):
        for layer in self.dense:
            x = torch.relu(layer(x))
        return self.out(x)


def _valid_convs(module, input_hw, in_channels, out_channels, kernel, device):
    """The VALID conv stack `conv_{i}` and the width of its flattened output."""
    ins = [in_channels[0], *out_channels[:-1]]
    module.convs = _named(module, "conv_", [Conv(i, o, (kernel, kernel), "VALID",
                                                   device=device)
                                            for i, o in zip(ins, out_channels)])
    shrink = len(out_channels) * (kernel - 1)
    return (input_hw[0] - shrink) * (input_hw[1] - shrink) * out_channels[-1]


def _conv_flat(module, inputs):
    x = inputs
    for conv in module.convs:
        x = torch.relu(conv(x))
    return _flat(x)


class ModnetEncoder(nn.Module):
    """CNN -> per-head gumbel-softmax frequency pick -> sine projections
    (reference modnetEncoder :755-825). (B, C, H, W) patches ->
    (modulations (B, H * head_num), picked frequencies (B, head_num))."""

    def __init__(self, input_hw, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel: int, freq_num: int, wind_size: float, head_num: int,
                 temperature: float = 0.8, *, device=None):
        super().__init__()
        self.freq_num, self.wind_size, self.temperature = freq_num, wind_size, temperature
        flat = _valid_convs(self, input_hw, in_channels, out_channels, kernel, device)
        self.regressors = _named(self, "regressor_", [dense(flat, freq_num, device=device)
                                                      for _ in range(head_num)])

    def forward(self, inputs, *, uniforms=None, generator=None):
        x = _conv_flat(self, inputs)
        fs, t = (v.to(x) for v in _grid(self.freq_num, self.wind_size, inputs.shape[3]))
        mods, mod_f = [], []
        for h, regressor in enumerate(self.regressors):
            logits = regressor(x)
            u = uniforms[h] if uniforms is not None else draw_uniform(logits, generator)
            pick = gumbel_softmax(logits, self.temperature, u.to(logits))
            f = (pick * fs[None, :]).sum(dim=1)  # (B,)
            mod_f.append(f[:, None])
            sins = torch.sin(2 * np.pi * f[:, None] * t[None, :])  # (B, W)
            mods.append((sins[:, None, :] * inputs[:, 0]).mean(dim=2))  # (B, H)
        return torch.cat(mods, dim=1), torch.cat(mod_f, dim=1)


class ModulationNet(nn.Module):
    """ModnetEncoder + MLP classifier (reference modulationNet :845).
    (B, C, H, W) patches of (input_h, input_w) -> (logits, frequencies)."""

    def __init__(self, input_h: int, input_w: int, in_channels: Sequence[int],
                 out_channels: Sequence[int], kernel: int, freq_num: int, wind_size: float,
                 head_num: int, num_layers_dec: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.encoder = ModnetEncoder((input_h, input_w), in_channels, out_channels, kernel,
                                     freq_num, wind_size, head_num, device=device)
        self.classifier = ModnetClassifier(input_h * head_num, num_layers_dec, hidden_size,
                                           out_size, device=device)

    def forward(self, inputs, *, uniforms=None, generator=None):
        mods, mod_f = self.encoder(inputs, uniforms=uniforms, generator=generator)
        return self.classifier(mods), mod_f


class ModnetSigmoidEncoder(nn.Module):
    """Sigmoid-gated variant (reference modnetSigmoidEncoder :886-947): the
    input is smoothed along time by a learned 1-D SAME filter, and the
    sin/cos magnitude at every candidate frequency is weighted by a sigmoid
    gate. -> (modulations (B, H * freq_num), mean gated frequency)."""

    def __init__(self, input_hw, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel: int, input_filter_kernel: int, freq_num: int, wind_size: float,
                 *, device=None):
        super().__init__()
        self.freq_num, self.wind_size = freq_num, wind_size
        self.input_filter = nn.Conv1d(1, 1, input_filter_kernel, padding="same", device=device)
        flax_init.conv_(self.input_filter)
        flat = _valid_convs(self, input_hw, in_channels, out_channels, kernel, device)
        self.regression = dense(flat, freq_num, device=device)

    def forward(self, inputs):
        B, C, H, W = inputs.shape
        feats = self.input_filter(inputs.reshape(B * C * H, 1, W)).reshape(B, C, H, W)
        gates = torch.sigmoid(self.regression(_conv_flat(self, inputs)))
        fs, t = _grid(self.freq_num, self.wind_size, W)
        wtd_mean_mod = (gates * fs.to(gates)[None, :]).mean()
        arg = 2 * np.pi * fs[:, None] * t[None, :]  # (freq_num, W), float64
        sin, cos = torch.sin(arg).to(feats), torch.cos(arg).to(feats)
        mods = []
        for idx in range(self.freq_num):
            sins = (sin[idx][None, None, :] * feats[:, 0]).mean(dim=2)
            coss = (cos[idx][None, None, :] * feats[:, 0]).mean(dim=2)
            mods.append(torch.sqrt(sins**2 + coss**2) * gates[:, idx][:, None])
        return torch.cat(mods, dim=1), wtd_mean_mod


class ModulationSigmoidNet(nn.Module):
    """ModnetSigmoidEncoder + MLP classifier (reference
    modulationSigmoidNet :950)."""

    def __init__(self, input_h: int, input_w: int, in_channels: Sequence[int],
                 out_channels: Sequence[int], kernel: int, input_filter_kernel: int,
                 freq_num: int, wind_size: float, num_layers_dec: int, hidden_size: int,
                 out_size: int, *, device=None):
        super().__init__()
        self.encoder = ModnetSigmoidEncoder((input_h, input_w), in_channels, out_channels,
                                            kernel, input_filter_kernel, freq_num, wind_size,
                                            device=device)
        self.classifier = ModnetClassifier(input_h * freq_num, num_layers_dec, hidden_size,
                                           out_size, device=device)

    def forward(self, inputs):
        mods, mean_mod = self.encoder(inputs)
        return self.classifier(mods), mean_mod
