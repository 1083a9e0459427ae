"""CURL: Gaussian-mixture-latent VAEs for lifelong learning.

Port of speech_recognition_tools_tpu/models/curl.py without the
expert-parallel layout (CurlMultistreamClassifierEP, curl_params_to_ep)
(reference nnet_models.py: curlEncoder :536, curlDecoder :573,
curlDecoderMultistream :602, curlLatentSampler :632, nnetCurlSupervised
:649, nnetCurlMultistreamClassifier :663 with expand_component :687 and its
gradient-scaling hooks :726-728, curlEncodedClassifier :511,
compute_latent_features :739; the losses of train_CURLclassifier_v2.py
:33-69).

The encoder's mean and log-var heads are one Dense each over comp_num *
bn_size outputs, the latents (K, B, T, bn) with the component axis first.
The shared CurlDecoder runs its K latents as one batch of K * B rows (each
row's recurrence is its own). As in models/vae.py, a sampling model takes
`eps` (the latents' shape) or a torch.Generator; `scale_gradient` is an
autograd Function whose backward returns g * scale, the JAX custom VJP's.
"""

import math

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.models.recurrent import (
    DecoderRNN,
    GRUStack,
    LinearConvStack,
    dense,
    flax_reset_,
)
from speech_recognition_tools_tpu_torch.models.vae import LOG_2PI, draw_eps


class _ScaleGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The identity forward; the gradient multiplied by `scale` backward."""
    return _ScaleGradient.apply(x, scale)


class CurlEncoder(nn.Module):
    """GRU stack -> (categorical posterior (B, T, K), means and logvars
    (K, B, T, bn)) (reference curlEncoder :536)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, bn_size: int,
                 comp_num: int, *, device=None):
        super().__init__()
        self.comp_num, self.bn_size = comp_num, bn_size
        self.GRUStack_0 = GRUStack(input_size, num_layers, hidden_size, device=device)
        self.means = dense(hidden_size, comp_num * bn_size, device=device)
        self.vars = dense(hidden_size, comp_num * bn_size, device=device)
        self.categorical = dense(hidden_size, comp_num, device=device)

    def forward(self, inputs, lengths):
        x = self.GRUStack_0(inputs, lengths)
        B, T = x.shape[:2]
        K, bn = self.comp_num, self.bn_size
        means = self.means(x).reshape(B, T, K, bn).permute(2, 0, 1, 3)
        logvars = self.vars(x).reshape(B, T, K, bn).permute(2, 0, 1, 3)
        return torch.softmax(self.categorical(x), dim=-1), means, logvars


class CurlDecoder(nn.Module):
    """One decoder shared by every component's latent (reference
    curlDecoder :573)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.DecoderRNN_0 = DecoderRNN(input_size, num_layers, hidden_size, out_size,
                                       device=device)

    def forward(self, all_latents, lengths):
        K, B = all_latents.shape[:2]
        out = self.DecoderRNN_0(all_latents.reshape(K * B, *all_latents.shape[2:]),
                                lengths.repeat(K))
        return out.reshape(K, B, *out.shape[1:])


class CurlDecoderMultistream(nn.Module):
    """One decoder per component (reference curlDecoderMultistream :602)."""

    def __init__(self, num_streams: int, input_size: int, num_layers: int, hidden_size: int,
                 out_size: int, *, device=None):
        super().__init__()
        self.num_streams = num_streams
        for i in range(num_streams):
            self.add_module(f"stream_{i}", DecoderRNN(input_size, num_layers, hidden_size,
                                                      out_size, device=device))

    def forward(self, all_latents, lengths):
        return torch.stack([getattr(self, f"stream_{i}")(all_latents[i], lengths)
                            for i in range(self.num_streams)])


def sample_curl_latent(means, logvars, eps):
    """Per-component samples z_k = mu_k + exp(logvar_k) * eps (reference
    curlLatentSampler :632)."""
    return means + torch.exp(logvars) * eps


class CurlSupervised(nn.Module):
    """CURL autoencoder (reference nnetCurlSupervised :649): (per-component
    reconstructions (K, B, T, D), (cat, means, logvars))."""

    def __init__(self, input_size: int, num_layers_enc: int, num_layers_dec: int,
                 hidden_size: int, bn_size: int, comp_num: int,
                 recon_size: int | None = None, *, device=None):
        super().__init__()
        self.curl_encoder = CurlEncoder(input_size, num_layers_enc, hidden_size, bn_size,
                                        comp_num, device=device)
        self.curl_decoder = CurlDecoder(bn_size, num_layers_dec, hidden_size,
                                        recon_size or input_size, device=device)

    def forward(self, inputs, lengths, *, eps=None, generator=None):
        latent = self.curl_encoder(inputs, lengths)
        sampled = sample_curl_latent(latent[1], latent[2], draw_eps(latent[1], eps, generator))
        return self.curl_decoder(sampled, lengths), latent


class CurlMultistreamClassifier(nn.Module):
    """CURL with one decoder and one classifier stream per component
    (reference nnetCurlMultistreamClassifier :663); the encoder's outputs
    pass gradients scaled by enc_scale (the reference's hooks :726-728).
    Returns (class logits (K, B, T, C), reconstructions, latent)."""

    def __init__(self, input_size: int, out_size: int, num_layers_enc: int,
                 num_layers_dec: int, num_layers_class: int, hidden_size: int,
                 hidden_size_classifier: int, bn_size: int, comp_num: int,
                 enc_scale: float = 0.2, recon_size: int | None = None, *, device=None):
        super().__init__()
        self.config = dict(input_size=input_size, out_size=out_size,
                           num_layers_enc=num_layers_enc, num_layers_dec=num_layers_dec,
                           num_layers_class=num_layers_class, hidden_size=hidden_size,
                           hidden_size_classifier=hidden_size_classifier, bn_size=bn_size,
                           comp_num=comp_num, enc_scale=enc_scale, recon_size=recon_size)
        self.comp_num, self.bn_size, self.enc_scale = comp_num, bn_size, enc_scale
        self.curl_encoder = CurlEncoder(input_size, num_layers_enc, hidden_size, bn_size,
                                        comp_num, device=device)
        for i in range(comp_num):
            self.add_module(f"classifier_{i}", DecoderRNN(
                bn_size, num_layers_class, hidden_size_classifier, out_size, device=device))
        self.curl_decoder = CurlDecoderMultistream(comp_num, bn_size, num_layers_dec,
                                                   hidden_size, recon_size or input_size,
                                                   device=device)

    def forward(self, inputs, lengths, *, eps=None, generator=None):
        cat, means, logvars = (scale_gradient(t, self.enc_scale)
                               for t in self.curl_encoder(inputs, lengths))
        sampled = sample_curl_latent(means, logvars, draw_eps(means, eps, generator))
        class_out = torch.stack([getattr(self, f"classifier_{i}")(sampled[i], lengths)
                                 for i in range(self.comp_num)])
        return class_out, self.curl_decoder(sampled, lengths), (cat, means, logvars)


def _gauss_elbo(x, recon_k, means_k, logvars_k, mean_p_k):
    """The per-frame gaussian log-likelihood plus the KL term to
    N(mean_p_k, I), as the reference writes it (summed over features)."""
    ll = (-0.5 * (x - recon_k) ** 2 - 0.5 * LOG_2PI).sum(-1)
    kl = 0.5 * (1 - (means_k - mean_p_k) ** 2 - torch.exp(logvars_k) ** 2
                + 2 * logvars_k).sum(-1)
    return ll + kl


def _masked_mean(v, mask):
    if mask is None:
        return v.mean()
    m = mask.to(v.dtype)
    return (v * m).sum() / m.sum().clamp_min(1.0)


def curl_loss_supervised(x, recon, latent, mean_p, comp_idx: int, mask=None):
    """Supervised CURL objective for a known component (reference
    train_CURLclassifier_v2.py curl_loss_supervised :33-49): its ELBO plus
    the log-posterior of the component (maximised)."""
    cat, means, logvars = latent
    per_frame = _gauss_elbo(x, recon[comp_idx], means[comp_idx], logvars[comp_idx],
                            mean_p[comp_idx])
    cat_reg = torch.log(cat[..., comp_idx].clamp_min(1e-12))
    return _masked_mean(per_frame, mask) + _masked_mean(cat_reg, mask)


def curl_loss_unsupervised(x, recon, latent, mean_p, mask=None):
    """Unsupervised CURL objective (reference curl_loss_unsupervised
    :52-69): posterior-weighted per-component ELBOs minus KL(q(y|x) ||
    uniform) (maximised)."""
    cat, means, logvars = latent
    K = recon.shape[0]
    total = 0.0
    for k in range(K):
        total = total + _masked_mean(
            cat[..., k] * _gauss_elbo(x, recon[k], means[k], logvars[k], mean_p[k]), mask)
    ent = (cat * torch.log(cat.clamp_min(1e-12))).sum(-1) + math.log(K)
    return total - _masked_mean(ent, mask)


def random_mixture_means(comp_num: int, bn_size: int, generator: torch.Generator,
                         scale: float = 1.0) -> torch.Tensor:
    """Random component prior means N(0, scale^2) of shape (K, bn)
    (reference train_CURLclassifier_v2.py :215), drawn on the CPU."""
    return torch.randn((comp_num, bn_size), generator=generator) * scale


def compute_latent_features(latent):
    """sum_k q(k|x) * mu_k (reference compute_latent_features :739)."""
    cat, means, _ = latent
    return torch.einsum("btk,kbtd->btd", cat, means)


class CurlEncodedClassifier(nn.Module):
    """Dense classifier on a frozen CURL model's mixture latent (reference
    curlEncodedClassifier :511)."""

    def __init__(self, input_size: int, num_layers: int, hidden_size: int, out_size: int,
                 *, device=None):
        super().__init__()
        self.head = LinearConvStack(input_size, num_layers, hidden_size, out_size, device=device)

    def forward(self, latent_feats, lengths=None):
        return self.head(latent_feats)


@torch.no_grad()
def expand_component(model: CurlMultistreamClassifier, generator: torch.Generator | None = None):
    """Lifelong growth by one component (reference expand_component
    :687-720): a CurlMultistreamClassifier with comp_num + 1 components on
    `model`'s device whose new leaves are drawn as flax's init draws them
    (from `generator`) and whose old component is copied exactly: the GRU
    trunk, the first K * bn outputs of the mean and var heads, the first K
    categorical logits, every decoder stream and classifier."""
    K, bn = model.comp_num, model.bn_size
    device = next(model.parameters()).device
    new = CurlMultistreamClassifier(**dict(model.config, comp_num=K + 1), device=device)
    flax_reset_(new, generator)
    old_enc, new_enc = model.curl_encoder, new.curl_encoder
    new_enc.GRUStack_0.load_state_dict(old_enc.GRUStack_0.state_dict())
    for head, n in (("means", K * bn), ("vars", K * bn), ("categorical", K)):
        o, w = getattr(old_enc, head), getattr(new_enc, head)
        w.weight[:n] = o.weight
        w.bias[:n] = o.bias
    for i in range(K):
        getattr(new.curl_decoder, f"stream_{i}").load_state_dict(
            getattr(model.curl_decoder, f"stream_{i}").state_dict())
        getattr(new, f"classifier_{i}").load_state_dict(
            getattr(model, f"classifier_{i}").state_dict())
    return new
