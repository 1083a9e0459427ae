"""Recurrent (and transformer) VAEs and the VAE-based classifiers.

Port of speech_recognition_tools_tpu/models/vae.py (reference
nnet_models.py: VAEEncoder :262, VAEEncoderTransformer :300,
VAEDecoderTransformer :326, VAEDecoder :344, latentSampler :372,
nnetVAEClassifier :385, nnetVAE :401 with vae_loss :432, compute_llhood
:446 and generate :460, nnetARVAE :470, VAEEncodedClassifier :488).

A model that samples takes its noise as an argument: `eps` (a tensor of
the latent's shape) or a torch.Generator from which it draws `eps` (on the
generator's device, then moved to the latent's). Given neither it raises
MissingNoiseError, where the JAX model, applied without a "sample" rng,
raises flax's InvalidRngError. The sample is means + exp(logvars) * eps:
the head predicts a log *std*, as the reference's sampler has it.

The transformer pair behind `use_transformer` is pre-LN blocks of flax's
MultiHeadDotProductAttention (16 heads by default, over the block's input
width, which must divide by them) and a ReLU FFN, written out with matmuls
(models/transformer_asr.py::MultiHeadAttention).
"""

import math

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.models.recurrent import (
    DecoderRNN,
    GRUStack,
    LinearConvStack,
    dense,
    length_mask,
)
from speech_recognition_tools_tpu_torch.models.transformer_asr import (
    LayerNorm,
    MultiHeadAttention,
)

LOG_2PI = math.log(2 * math.pi)


class MissingNoiseError(ValueError):
    """A sampling model was called with neither `eps` nor a generator."""


def draw_eps(like: torch.Tensor, eps=None, generator: torch.Generator | None = None):
    """The standard normal noise of `like`'s shape, dtype and device:
    `eps` as given, or drawn from `generator`."""
    if eps is None:
        if generator is None:
            raise MissingNoiseError(
                "this model draws a latent sample: pass `eps` or a torch.Generator "
                "(the JAX model needs a 'sample' rng and raises without one)")
        eps = torch.randn(like.shape, generator=generator, device=generator.device,
                          dtype=like.dtype)
    return eps.to(device=like.device, dtype=like.dtype)


def sample_latent(means, logvars, eps):
    """mu + exp(logvar) * eps (reference latentSampler :377-382)."""
    return means + torch.exp(logvars) * eps


class VAEEncoder(nn.Module):
    """GRU stack -> (means, logvars, hidden) (reference VAEEncoder :262)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, bn_size: int,
                 dropout: float = 0.0, *, device=None):
        super().__init__()
        self.GRUStack_0 = GRUStack(input_size, num_layers, hidden_size, dropout, device=device)
        self.means = dense(hidden_size, bn_size, device=device)
        self.vars = dense(hidden_size, bn_size, device=device)

    def forward(self, inputs, lengths):
        x = self.GRUStack_0(inputs, lengths)
        return self.means(x), self.vars(x), x


class VAEDecoder(nn.Module):
    """GRU stack -> mean head (reference VAEDecoder :344)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.GRUStack_0 = GRUStack(input_size, num_layers, hidden_size, device=device)
        self.means = dense(hidden_size, out_size, device=device)

    def forward(self, inputs, lengths):
        return self.means(self.GRUStack_0(inputs, lengths))


class TransformerBlock(nn.Module):
    """Pre-LN self-attention over valid keys + ReLU FFN, each residual."""

    def __init__(self, d_model: int, nhead: int, d_ff: int, *, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model, device=device)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(d_model, nhead, device=device)
        self.LayerNorm_1 = LayerNorm(d_model, device=device)
        self.Dense_0 = dense(d_model, d_ff, device=device)
        self.Dense_1 = dense(d_ff, d_model, device=device)

    def forward(self, x, mask):
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(h, h, mask[:, None, None, :])
        h = torch.relu(self.Dense_0(self.LayerNorm_1(x)))
        return x + self.Dense_1(h)


class _TransformerStack(nn.Module):
    def __init__(self, d_model: int, num_layers: int, hidden_size: int, nhead: int, *,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(d_model, nhead, hidden_size,
                                                           device=device))

    def blocks(self, inputs, lengths):
        mask = length_mask(lengths, inputs.shape[1])
        x = inputs
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        return x


class VAEEncoderTransformer(_TransformerStack):
    """Transformer blocks at the input width -> (means, logvars, hidden)
    (reference VAEEncoderTransformer :300, implemented for real)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, bn_size: int,
                 nhead: int = 16, *, device=None):
        super().__init__(input_size, num_layers, hidden_size, nhead, device=device)
        self.means = dense(input_size, bn_size, device=device)
        self.vars = dense(input_size, bn_size, device=device)

    def forward(self, inputs, lengths):
        x = self.blocks(inputs, lengths)
        return self.means(x), self.vars(x), x


class VAEDecoderTransformer(_TransformerStack):
    """Transformer blocks at the latent width -> mean head (reference
    VAEDecoderTransformer :326)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 nhead: int = 16, *, device=None):
        super().__init__(input_size, num_layers, hidden_size, nhead, device=device)
        self.means = dense(input_size, out_size, device=device)

    def forward(self, inputs, lengths):
        return self.means(self.blocks(inputs, lengths))


class VAE(nn.Module):
    """Recurrent VAE (reference nnetVAE :401): `only_ae` decodes the means
    without sampling; `use_transformer` swaps both halves. Returns
    (reconstruction, (means, logvars)). `recon_size` is the flax
    `input_size` (the output width, by default the input's)."""

    def __init__(self, input_size: int, num_layers_enc: int, num_layers_dec: int,
                 hidden_size: int, bn_size: int, dropout: float = 0.0, only_ae: bool = False,
                 use_transformer: bool = False, recon_size: int | None = None,
                 nhead: int = 16, *, device=None):
        super().__init__()
        out = recon_size or input_size
        self.only_ae = only_ae
        self.bn_size = bn_size
        if use_transformer:
            self.encoder = VAEEncoderTransformer(input_size, num_layers_enc, hidden_size,
                                                 bn_size, nhead, device=device)
            self.decoder = VAEDecoderTransformer(bn_size, num_layers_dec, hidden_size, out,
                                                 nhead, device=device)
        else:
            self.encoder = VAEEncoder(input_size, num_layers_enc, hidden_size, bn_size,
                                      dropout, device=device)
            self.decoder = VAEDecoder(bn_size, num_layers_dec, hidden_size, out, device=device)

    def forward(self, inputs, lengths, *, eps=None, generator=None):
        means, logvars, _ = self.encoder(inputs, lengths)
        if self.only_ae:
            z = means
        else:
            z = sample_latent(means, logvars, draw_eps(means, eps, generator))
        return self.decoder(z, lengths), (means, logvars)


def vae_loss(x, ae_out, latent, out_dist="gauss", mask=None):
    """(log-likelihood, kl) as the reference's nnetVAE.vae_loss :432-444
    writes them (the kl is *added*: loss = -(ll + kl)); `mask` (B, T)
    restricts both means to valid frames."""
    means, logvars = latent
    if out_dist == "gauss":
        ll = -0.5 * (x - ae_out) ** 2 - 0.5 * LOG_2PI
    elif out_dist == "laplace":
        ll = -(x - ae_out).abs() - math.log(2)
    else:
        raise ValueError("out_dist must be 'gauss' or 'laplace'")
    kl = 0.5 * (1 - means**2 - torch.exp(logvars) ** 2 + 2 * logvars)
    if mask is None:
        return ll.mean(), kl.mean()
    m = mask[..., None].to(ll.dtype)
    return (ll * m).sum() / (m.sum() * ll.shape[-1]), (kl * m).sum() / (m.sum() * kl.shape[-1])


def vae_generate(model: VAE, size: int = 512, batch: int = 1, *, z=None, generator=None):
    """Decode z ~ N(0, I) of shape (batch, size, bn) (reference
    nnetVAE.generate :460-467); `z` as given, or drawn from `generator`."""
    w = model.decoder.means.weight
    like = torch.empty((batch, size, model.bn_size), dtype=w.dtype, device=w.device)
    z = draw_eps(like, z, generator)
    lengths = torch.full((batch,), size, dtype=torch.int64, device=w.device)
    return model.decoder(z, lengths)


def vae_llhood(model: VAE, inputs, lengths, sample_num: int = 10, out_dist: str = "gauss",
               *, eps=None, generator=None):
    """Mean reconstruction log-likelihood and mean -kl over `sample_num`
    latent draws (reference compute_llhood :446-458); `eps` is a sequence of
    sample_num noise tensors, or each is drawn from `generator`."""
    recon_ll = kl_acc = 0.0
    for i in range(sample_num):
        recon, latent = model(inputs, lengths, eps=None if eps is None else eps[i],
                              generator=generator)
        ll, kl = vae_loss(inputs, recon, latent, out_dist)
        recon_ll = recon_ll + ll
        kl_acc = kl_acc - kl
    return recon_ll / sample_num, kl_acc / sample_num


class VAEClassifier(nn.Module):
    """VAE + a classifier head on the sampled latent (reference
    nnetVAEClassifier :385). Returns (logits, reconstruction, latent)."""

    def __init__(self, input_size: int, out_size: int, num_layers_enc: int,
                 num_layers_class: int, num_layers_ae: int, hidden_size: int, bn_size: int,
                 dropout: float = 0.0, recon_size: int | None = None, *, device=None):
        super().__init__()
        self.vae_encoder = VAEEncoder(input_size, num_layers_enc, hidden_size, bn_size, dropout,
                                      device=device)
        self.classifier = DecoderRNN(bn_size, num_layers_class, hidden_size, out_size,
                                     device=device)
        self.vae_decoder = VAEDecoder(bn_size, num_layers_ae, hidden_size,
                                      recon_size or input_size, device=device)

    def forward(self, inputs, lengths, *, eps=None, generator=None):
        means, logvars, _ = self.vae_encoder(inputs, lengths)
        z = sample_latent(means, logvars, draw_eps(means, eps, generator))
        return (self.classifier(z, lengths), self.vae_decoder(z, lengths),
                (means, logvars))


class ARVAE(nn.Module):
    """One encoder, `num_outs` decoders for multi-shift autoregressive
    prediction (reference nnetARVAE :470). Returns (stacked outputs,
    latent)."""

    def __init__(self, input_size: int, num_layers_enc: int, num_layers_dec: int,
                 hidden_size: int, bn_size: int, num_outs: int, dropout: float = 0.0,
                 recon_size: int | None = None, *, device=None):
        super().__init__()
        self.num_outs = num_outs
        self.vae_encoder = VAEEncoder(input_size, num_layers_enc, hidden_size, bn_size, dropout,
                                      device=device)
        for i in range(num_outs):
            self.add_module(f"decoder_{i}", VAEDecoder(bn_size, num_layers_dec, hidden_size,
                                                       recon_size or input_size, device=device))

    def forward(self, inputs, lengths, *, eps=None, generator=None):
        means, logvars, _ = self.vae_encoder(inputs, lengths)
        z = sample_latent(means, logvars, draw_eps(means, eps, generator))
        outs = [getattr(self, f"decoder_{i}")(z, lengths) for i in range(self.num_outs)]
        return torch.stack(outs), (means, logvars)


class VAEEncodedClassifier(nn.Module):
    """Dense classifier on a frozen VAE's latent means (reference
    VAEEncodedClassifier :488)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.head = LinearConvStack(input_size, num_layers, hidden_size, out_size, device=device)

    def forward(self, latent_means, lengths=None):
        return self.head(latent_means)
