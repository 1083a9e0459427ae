"""Convolutional acoustic models and conv VAEs.

Port of speech_recognition_tools_tpu/models/cnn.py, all of it (reference
nnet_models_cnn.py: nnetCNNClassifier :8, nnetCLDNN :32, nnetCLDNN3D :85,
the pooled and unpooled conv VAEs :145-302, nnetCNNAE :347, rsconv2d :360,
rsconvTranspose2d :401, nnetVaeRsModulation :510; and nnet_models.py's
patch cnnClassifier :966).

The modules take (B, C, H, W) inputs (H = feature bins, W = frames) and
compute in torch's NCHW, where the JAX modules transpose to NHWC; every
flatten is written so that it orders the elements as flax's NHWC reshape
does, so the Dense weights carry over unchanged. Flax infers input widths
at init; here each constructor takes the input geometry it needs: the
feature bins `input_h`, and for the models whose Dense layers see the
frames too (the patch classifier, the pooled VAE) `input_hw`.

Padding is flax's:

  - nn.Conv(padding="SAME") at stride 1 pads (k-1)//2 before and the
    rest after (torch's padding="same"; `Conv` pads an even kernel itself),
    "VALID" not at all;
  - nn.ConvTranspose(padding="SAME") at stride 1 (lax.conv_transpose, the
    kernel not flipped) is a plain correlation padded (k-1) - (k-1)//2
    before and (k-1)//2 after: the odd pad *before* the data.
    `ConvTranspose` below computes exactly that; torch's conv_transpose2d
    (which flips the kernel) is not it.

The pooled VAE pools 2x2 windows by argmax as the JAX package writes it (a
reshape into windows, argmax, amax): the first of tied maxima wins, and the
gradient of the max is split evenly among ties (torch.amax, as jnp.max);
unpooling scatters each value back to its argmax slot and zero-pads the
odd row and column the pool cropped. The rate-scale convs synthesise
their kernels sin(rate * t + scale * f) * hanning2d from the learnable
`rates` and `scales`.

A sampling model takes its noise as `eps` or a torch.Generator
(models/vae.py::draw_eps); kernels and biases are drawn as flax draws them
(lecun_normal, zeros; `rates` uniform on [0, 1), `scales` zero) by
models/recurrent.py::flax_reset_.
"""

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_recognition_tools_tpu_torch.models import flax_init, vae
from speech_recognition_tools_tpu_torch.models.recurrent import MaskedLSTMLayer, dense


def _pads(kernel, odd_before: bool):
    """F.pad's (left, right, top, bottom) for a stride-1 SAME conv: an even
    kernel's odd pad goes after the data (Conv) or before it
    (ConvTranspose)."""
    pads = []
    for k in reversed(kernel):
        lo = (k - 1) // 2
        pads += [k - 1 - lo, lo] if odd_before else [lo, k - 1 - lo]
    return tuple(pads)


class Conv(nn.Conv2d):
    """flax nn.Conv at stride 1, `padding` "SAME" or "VALID", drawn as flax
    draws. The weight is (out, in, kh, kw), flax's HWIO kernel transposed."""

    odd_before = False

    def __init__(self, in_ch: int, out_ch: int, kernel, padding: str = "SAME", *,
                 device=None):
        kernel = tuple(kernel)
        symmetric = padding == "VALID" or all(k % 2 for k in kernel)
        # an odd kernel pads alike on both sides: torch's own padding does it
        super().__init__(in_ch, out_ch, kernel, device=device,
                         padding=padding.lower() if symmetric else 0)
        self.pads = None if symmetric else _pads(kernel, self.odd_before)
        flax_init.conv_(self)

    def forward(self, x):
        return super().forward(x if self.pads is None else F.pad(x, self.pads))


class ConvTranspose(Conv):
    """flax nn.ConvTranspose(padding="SAME") at stride 1: the unflipped
    kernel correlated over the input padded (k-1) - (k-1)//2 before and
    (k-1)//2 after on each axis. The weight is (out, in, kh, kw), flax's
    (kh, kw, in, out) kernel transposed as a Conv's."""

    odd_before = True


def _seq(x):
    """(B, C, H, W) -> (B, W, H * C), channel-minor, as flax's
    (B, H, W, C) -> (B, W, H, C) -> (B, W, H * C)."""
    B, C, H, W = x.shape
    return x.permute(0, 3, 2, 1).reshape(B, W, H * C)


def _unseq(y, H):
    """(B, W, H * C) -> (B, C, H, W), the inverse of _seq."""
    B, W, HC = y.shape
    return y.reshape(B, W, H, HC // H).permute(0, 3, 2, 1)


def _flat(x):
    """(B, C, H, W) -> (B, H * W * C) in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _relu_convs(convs, x):
    for conv in convs:
        x = torch.relu(conv(x))
    return x


def _decode(convs, y):
    """Transposed convs, ReLU between them (not after the last)."""
    for i, conv in enumerate(convs):
        y = conv(y)
        if i + 1 < len(convs):
            y = torch.relu(y)
    return y


def _named(module, prefix, layers):
    """Register `layers` as module attributes `<prefix>{i}` (flax's names)
    and return them as a list."""
    for i, layer in enumerate(layers):
        module.add_module(f"{prefix}{i}", layer)
    return list(layers)


class CnnClassifier(nn.Module):
    """Patch classifier: VALID conv stack -> flatten -> MLP (reference
    nnet_models.py cnnClassifier :966). `in_channels` are the convs' input
    channels, `input_hw` the patches' (H, W)."""

    def __init__(self, input_hw, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel: int, num_layers_dec: int, hidden_size: int, output_size: int,
                 *, device=None):
        super().__init__()
        self.convs = _named(self, "conv_", [
            Conv(cin, cout, (kernel, kernel), "VALID", device=device)
            for cin, cout in zip(in_channels, out_channels)])
        shrink = len(out_channels) * (kernel - 1)
        width = (input_hw[0] - shrink) * (input_hw[1] - shrink) * out_channels[-1]
        self.dense = _named(self, "dense_", [
            dense(width if i == 0 else hidden_size, hidden_size, device=device)
            for i in range(num_layers_dec - 1)])
        self.out = dense(hidden_size if num_layers_dec > 1 else width, output_size,
                         device=device)

    def forward(self, inputs):
        x = _flat(_relu_convs(self.convs, inputs))
        for layer in self.dense:
            x = torch.relu(layer(x))
        return self.out(x)


class CNNFrameClassifier(nn.Module):
    """Frame-wise CNN AM: SAME conv stack over (freq, time), freq folded
    into channels, a Dense over each frame (reference nnetCNNClassifier
    :8). (B, C, H, W) -> (B, W, out)."""

    def __init__(self, input_h: int, out_channels: Sequence[int], kernel, output_size: int,
                 in_channels: int = 1, *, device=None):
        super().__init__()
        ins = [in_channels, *out_channels[:-1]]
        self.convs = _named(self, "conv_", [Conv(i, o, kernel, "SAME", device=device)
                                            for i, o in zip(ins, out_channels)])
        self.lin = dense(input_h * out_channels[-1], output_size, device=device)

    def forward(self, inputs):
        return self.lin(_seq(_relu_convs(self.convs, inputs)))


class CLDNN(nn.Module):
    """CNN -> dim-reduce -> masked LSTM stack -> DNN (reference nnetCLDNN
    :32). (B, C, H, W) and lengths over W -> (B, W, out)."""

    def __init__(self, input_h: int, out_channels: Sequence[int], kernel, hidden_size: int,
                 l_num_layers: int, d_num_layers: int, output_size: int, in_channels: int = 1,
                 *, device=None):
        super().__init__()
        ins = [in_channels, *out_channels[:-1]]
        self.convs = _named(self, "conv_", [Conv(i, o, kernel, "SAME", device=device)
                                            for i, o in zip(ins, out_channels)])
        self.dim_reduce = dense(input_h * out_channels[-1], hidden_size, device=device)
        _head_init(self, hidden_size, l_num_layers, d_num_layers, output_size, device)

    def forward(self, inputs, lengths):
        x = self.dim_reduce(_seq(_relu_convs(self.convs, inputs)))
        return _lstm_dnn(self, x, lengths)


def _head_init(module, hidden, l_num_layers, d_num_layers, output_size, device):
    """CLDNN's LSTM layers `lstm_{i}`, DNN layers `dnn_{i}` and `dnn_out`."""
    module.lstms = _named(module, "lstm_", [MaskedLSTMLayer(hidden, hidden, device=device)
                                            for _ in range(l_num_layers)])
    module.dnns = _named(module, "dnn_", [dense(hidden, hidden, device=device)
                                          for _ in range(d_num_layers - 1)])
    module.dnn_out = dense(hidden, output_size, device=device)


def _lstm_dnn(module, x, lengths):
    for lstm in module.lstms:
        x = lstm(x, lengths)
    for layer in module.dnns:
        x = torch.relu(layer(x))
    return module.dnn_out(x)


class CLDNN3D(nn.Module):
    """Per-stream CNNs -> channels concatenated -> LSTM -> DNN (reference
    nnetCLDNN3D :85). (B, C, S, H, W) and lengths over W -> (B, W, out)."""

    def __init__(self, input_h: int, num_streams: int, out_channels: Sequence[int], kernel,
                 hidden_size: int, l_num_layers: int, d_num_layers: int, output_size: int,
                 in_channels: int = 1, *, device=None):
        super().__init__()
        ins = [in_channels, *out_channels[:-1]]
        self.streams = []
        for s in range(num_streams):
            self.streams.append(_named(self, f"conv_s{s}_", [
                Conv(i, o, kernel, "SAME", device=device) for i, o in zip(ins, out_channels)]))
        self.dim_reduce = dense(input_h * num_streams * out_channels[-1], hidden_size,
                                device=device)
        _head_init(self, hidden_size, l_num_layers, d_num_layers, output_size, device)

    def forward(self, inputs, lengths):
        x = torch.cat([_relu_convs(convs, inputs[:, :, s])
                       for s, convs in enumerate(self.streams)], dim=1)
        return _lstm_dnn(self, self.dim_reduce(_seq(x)), lengths)


def _maxpool_with_indices(x):
    """2x2 / stride-2 max pool of (B, H, W, C) returning each window's
    argmax slot (2 * row + column), the first of tied maxima; the odd row
    and column are cropped."""
    B, H, W, C = x.shape
    H2, W2 = H // 2, W // 2
    xw = x[:, : H2 * 2, : W2 * 2, :].reshape(B, H2, 2, W2, 2, C)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(B, H2, W2, 4, C)
    return torch.amax(xw, dim=3), torch.argmax(xw, dim=3)


def _maxunpool(x, idx, out_hw):
    """Inverse of _maxpool_with_indices: each pooled value of (B, H2, W2,
    C) back at its argmax slot, the rest zero, zero-padded to out_hw."""
    B, H2, W2, C = x.shape
    onehot = F.one_hot(idx, 4).to(x.dtype).transpose(-1, -2)  # (B, H2, W2, 4, C)
    spread = (onehot * x[:, :, :, None, :]).reshape(B, H2, W2, 2, 2, C)
    out = spread.permute(0, 1, 3, 2, 4, 5).reshape(B, H2 * 2, W2 * 2, C)
    H, W = out_hw
    return F.pad(out, (0, 0, 0, W - W2 * 2, 0, H - H2 * 2))


def _sample(means, logvars, eps, generator):
    return vae.sample_latent(means, logvars, vae.draw_eps(means, eps, generator))


class VAECNN(nn.Module):
    """Pooled conv VAE with index-preserving unpooling (reference
    nnetVAECNN :286). (B, C, H, W) patches of `input_hw` -> (recon (B, C,
    H, W), (means, logvars) (B, bn))."""

    def __init__(self, input_hw, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel, bn_size: int, *, device=None):
        super().__init__()
        ins = [in_channels[0], *out_channels[:-1]]
        self.enc = _named(self, "enc_conv_", [Conv(i, o, kernel, "SAME", device=device)
                                              for i, o in zip(ins, out_channels)])
        h, w = input_hw
        for _ in out_channels:
            h, w = h // 2, w // 2
        self.bn_hw = (h, w)
        flat = h * w * out_channels[-1]
        self.means = dense(flat, bn_size, device=device)
        self.vars = dense(flat, bn_size, device=device)
        self.expand = dense(bn_size, flat, device=device)
        dec = list(in_channels[::-1])
        self.dec = _named(self, "dec_conv_", [
            ConvTranspose(i, o, kernel, device=device)
            for i, o in zip([out_channels[-1], *dec[:-1]], dec)])

    def forward(self, inputs, *, eps=None, generator=None):
        x = inputs
        indices, sizes = [], []
        for conv in self.enc:
            x = torch.relu(conv(x)).permute(0, 2, 3, 1)  # NHWC for the pool
            sizes.append((x.shape[1], x.shape[2]))
            x, idx = _maxpool_with_indices(x)
            indices.append(idx)
            x = x.permute(0, 3, 1, 2)
        B = x.shape[0]
        flat = _flat(x)
        means, logvars = self.means(flat), self.vars(flat)
        z = _sample(means, logvars, eps, generator)
        y = self.expand(z).reshape(B, *self.bn_hw, -1)  # NHWC
        for i, conv in enumerate(self.dec):
            y = _maxunpool(y, indices[-1 - i], sizes[-1 - i]).permute(0, 3, 1, 2)
            y = conv(y)
            if i + 1 < len(self.dec):
                y = torch.relu(y)
            y = y.permute(0, 2, 3, 1)
        return y.permute(0, 3, 1, 2), (means, logvars)


class _SeqConvAE(nn.Module):
    """The unpooled conv autoencoders' shared layout: SAME encoder convs
    `enc_conv_{i}` over `out_channels`, 1x1-over-time heads, `expand` back
    to H x out_channels[-1], transposed decoder convs `dec_conv_{i}` over
    the reversed `in_channels` (`skip_dec` of them replaced by a first
    layer of the subclass's own)."""

    def __init__(self, input_h, in_channels, out_channels, kernel, bn_size, heads,
                 enc_out, skip_dec=0, *, device=None):
        super().__init__()
        self.input_h = input_h
        ins = [in_channels[0], *out_channels[:-1]]
        self.enc = _named(self, "enc_conv_", [
            Conv(i, o, kernel, "SAME", device=device)
            for i, o in list(zip(ins, out_channels))[:enc_out]])
        c_top = out_channels[-1]
        for name in heads:
            setattr(self, name, dense(input_h * c_top, bn_size, device=device))
        self.expand = dense(bn_size, input_h * c_top, device=device)
        dec = list(in_channels[::-1])
        first = c_top if not skip_dec else dec[skip_dec - 1]
        dec = dec[skip_dec:]
        self.dec = _named(self, "dec_conv_", [
            ConvTranspose(i, o, kernel, device=device) for i, o in zip([first, *dec[:-1]], dec)])


class VAECNNNopool(_SeqConvAE):
    """Sequence-preserving conv VAE (reference nnetVAECNNNopool :302): no
    pooling, per-frame mean / log-std heads. (B, C, H, W) -> (recon, (means,
    logvars) (B, W, bn))."""

    def __init__(self, input_h: int, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel, bn_size: int, *, device=None):
        super().__init__(input_h, in_channels, out_channels, kernel, bn_size, ("means", "vars"),
                         len(out_channels), device=device)

    def forward(self, inputs, *, eps=None, generator=None):
        seq = _seq(_relu_convs(self.enc, inputs))
        means, logvars = self.means(seq), self.vars(seq)
        z = _sample(means, logvars, eps, generator)
        return _decode(self.dec, _unseq(self.expand(z), self.input_h)), (means, logvars)


class CNNAE(_SeqConvAE):
    """Plain conv AE with a ReLU bottleneck (reference nnetCNNAE :347).
    (B, C, H, W) -> (recon, z (B, W, bn))."""

    def __init__(self, input_h: int, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel, bn_size: int, *, device=None):
        super().__init__(input_h, in_channels, out_channels, kernel, bn_size, ("bn",),
                         len(out_channels), device=device)

    def forward(self, inputs):
        z = torch.relu(self.bn(_seq(_relu_convs(self.enc, inputs))))
        return _decode(self.dec, _unseq(self.expand(z), self.input_h)), z


def _rs_kernel(rates, scales, kf, kt):
    """sin(rate * t + scale * f) * hanning(kf) x hanning(kt): (A, B, kf, kt)
    from (A, B) rates and scales."""
    t = torch.arange(kt, dtype=rates.dtype, device=rates.device)[None, None, None, :]
    f = torch.arange(kf, dtype=rates.dtype, device=rates.device)[None, None, :, None]
    ww = torch.tensor(np.outer(np.hanning(kf), np.hanning(kt)), dtype=rates.dtype,
                      device=rates.device)
    return torch.sin(rates[:, :, None, None] * t + scales[:, :, None, None] * f) * ww


class RateScaleConv(flax_init.FlaxDrawn):
    """Rate-scale (Gabor-like) conv, SAME, no bias (reference rsconv2d
    :360-398): the kernel of (out, in) is synthesised from `rates` and
    `scales` (out, in). (B, in, H, W) -> (B, out, H, W)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size, *, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.rates = nn.Parameter(torch.empty(out_channel, in_channel, device=device))
        self.scales = nn.Parameter(torch.empty(out_channel, in_channel, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        flax_init.uniform_(self.rates, generator)
        flax_init.zeros_(self.scales)

    def forward(self, x):
        w = _rs_kernel(self.rates.to(x.dtype), self.scales.to(x.dtype), *self.kernel_size)
        return F.conv2d(F.pad(x, _pads(self.kernel_size, False)), w)


class RateScaleConvTranspose(RateScaleConv):
    """Transposed rate-scale conv (reference rsconvTranspose2d :401):
    `rates` and `scales` are (in, out); the synthesised kernel is flipped
    and run as flax's SAME transposed conv (the odd pad before)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size, *, device=None):
        super().__init__(out_channel, in_channel, kernel_size, device=device)

    def forward(self, x):
        w = _rs_kernel(self.rates.to(x.dtype), self.scales.to(x.dtype), *self.kernel_size)
        w = w.flip(2, 3).transpose(0, 1)  # (out, in, kf, kt)
        return F.conv2d(F.pad(x, _pads(self.kernel_size, True)), w)


class VaeRsModulation(_SeqConvAE):
    """Conv VAE whose last encoder and first decoder conv are rate-scale
    (reference nnetVaeRsModulation :510). (B, C, H, W) -> (recon, (means,
    logvars) (B, W, bn))."""

    def __init__(self, input_h: int, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel, bn_size: int, *, device=None):
        super().__init__(input_h, in_channels, out_channels, kernel, bn_size, ("means", "vars"),
                         len(out_channels) - 1, skip_dec=1, device=device)
        self.enc_rs = RateScaleConv(in_channels[-1], out_channels[-1], kernel, device=device)
        self.dec_rs = RateScaleConvTranspose(out_channels[-1], in_channels[-1], kernel,
                                             device=device)

    def forward(self, inputs, *, eps=None, generator=None):
        x = torch.relu(self.enc_rs(_relu_convs(self.enc, inputs)))
        seq = _seq(x)
        means, logvars = self.means(seq), self.vars(seq)
        z = _sample(means, logvars, eps, generator)
        y = torch.relu(self.dec_rs(_unseq(self.expand(z), self.input_h)))
        return _decode(self.dec, y), (means, logvars)
