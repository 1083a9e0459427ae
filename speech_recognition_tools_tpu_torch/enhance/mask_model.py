"""Neural T-F mask estimators and their training.

Port of speech_recognition_tools_tpu/enhance/mask_model.py (parity target
nn-gev/nn_models.py:25-66): BLSTMMaskEstimator (513 -> BLSTM 256 -> two
clipped-ReLU 513 layers -> sigmoid speech / noise masks) and
SimpleFWMaskEstimator, trained with binary cross-entropy against ideal
binary masks (:20-23).

The modules carry flax's names (`blstm.fwd`, `blstm.bwd`, `relu_1`, ...),
so io/jax_params.py::mask_model_from_jax / mask_model_to_jax carry a
JAX-saved `<exp>/mask_model` checkpoint both ways. Initial weights are
drawn from flax's distributions with an explicit torch.Generator
(models/flax_init.py); training uses train/optim.py's Adam, which follows
optax.adam(3e-3)'s arithmetic.
"""

import numpy as np
import torch
from torch import nn

from speech_recognition_tools_tpu_torch.device import resolve_device
from speech_recognition_tools_tpu_torch.enhance.onchip import median
from speech_recognition_tools_tpu_torch.models import flax_init
from speech_recognition_tools_tpu_torch.models.recurrent import MaskedLSTMLayer


class _BiLSTM(nn.Module):
    """Forward LSTM plus an LSTM over each row reversed within its valid
    length (flipped back after), summed."""

    def __init__(self, input_size: int, features: int, *, device=None):
        super().__init__()
        self.fwd = MaskedLSTMLayer(input_size, features, device=device)
        self.bwd = MaskedLSTMLayer(input_size, features, device=device)

    def forward(self, x, lengths):
        fwd = self.fwd(x, lengths)
        T = x.shape[1]
        idx = lengths[:, None] - 1 - torch.arange(T, device=x.device)[None, :]
        idx = idx.clamp(0, T - 1)[..., None]
        rev = torch.gather(x, 1, idx.expand(-1, -1, x.shape[-1]))
        bwd = self.bwd(rev, lengths)
        return fwd + torch.gather(bwd, 1, idx.expand(-1, -1, bwd.shape[-1]))


def _reset(module, generator):
    for m in module.modules():
        if isinstance(m, MaskedLSTMLayer):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            flax_init.dense_(m, generator)


class BLSTMMaskEstimator(nn.Module):
    """(B, T, bins) magnitude spectra, (B,) lengths -> (speech_mask,
    noise_mask), each (B, T, bins)."""

    def __init__(self, bins: int = 513, hidden: int = 256, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device or "cuda")
        self.bins, self.hidden = bins, hidden
        self.blstm = _BiLSTM(bins, hidden, device=dev)
        self.relu_1 = nn.Linear(hidden, bins, device=dev)
        self.relu_2 = nn.Linear(bins, bins, device=dev)
        self.speech_mask = nn.Linear(bins, bins, device=dev)
        self.noise_mask = nn.Linear(bins, bins, device=dev)
        _reset(self, generator)

    def forward(self, y, lengths):
        x = self.blstm(y, lengths)
        x = torch.clamp(self.relu_1(x), 0.0, 1.0)
        x = torch.clamp(self.relu_2(x), 0.0, 1.0)
        return torch.sigmoid(self.speech_mask(x)), torch.sigmoid(self.noise_mask(x))


class SimpleFWMaskEstimator(nn.Module):
    """The feed-forward estimator: (B, T, bins) -> (speech, noise) masks."""

    def __init__(self, bins: int = 513, hidden: int = 1024, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device or "cuda")
        self.relu_1 = nn.Linear(bins, hidden, device=dev)
        self.speech_mask = nn.Linear(hidden, bins, device=dev)
        self.noise_mask = nn.Linear(hidden, bins, device=dev)
        _reset(self, generator)

    def forward(self, y, lengths=None):
        x = torch.clamp(self.relu_1(y), 0.0, 1.0)
        return torch.sigmoid(self.speech_mask(x)), torch.sigmoid(self.noise_mask(x))


def mask_estimator_loss(speech_mask, noise_mask, ibm_x, ibm_n, lengths=None):
    """Mean of the two binary cross-entropies (reference :20-23), over the
    valid frames when `lengths` is given."""
    eps = 1e-7

    def bce(pred, target):
        pred = torch.clamp(pred, eps, 1 - eps)
        e = -(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))
        if lengths is None:
            return e.mean()
        mask = (torch.arange(e.shape[1], device=e.device)[None, :]
                < lengths[:, None]).to(e.dtype)[..., None]
        return (e * mask).sum() / torch.clamp(mask.sum() * e.shape[-1], min=1)

    return 0.5 * (bce(speech_mask, ibm_x) + bce(noise_mask, ibm_n))


def normalize_mask_input(mag, device=None):
    """Scale-invariant input of the mask nets: float32 magnitudes divided by
    their utterance mean (sigmoid nets are not scale-equivariant, and corpus
    levels vary by tens of dB). Training and inference both use it."""
    from speech_recognition_tools_tpu_torch.enhance.stft import as_tensor

    mag = as_tensor(mag, device).to(torch.float32)
    return mag / torch.clamp(mag.mean(), min=1e-12)


def train_mask_estimator(examples, bins: int, *, hidden: int = 256, epochs: int = 10,
                         learning_rate: float = 3e-3, seed: int = 0, log_fn=None,
                         init_state: dict | None = None, device=None):
    """Train a BLSTMMaskEstimator on (clean_stft, noise_stft) pairs, the
    nn-gev flow (nn-gev/train.py): ideal binary masks |X|^2 > |N|^2 of the
    parallel spectra are the BCE targets, the mixture magnitude the input.

    examples: [((T, F) complex clean, (T, F) complex noise)], arrays or
    tensors. The initial weights are drawn from torch.Generator(seed), or
    taken from `init_state` (a state_dict, e.g. converted from the JAX
    package's init). Returns (model, state_dict, per-epoch mean losses)."""
    from speech_recognition_tools_tpu_torch.enhance.stft import as_tensor
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    dev = resolve_device(device or "cuda")
    model = BLSTMMaskEstimator(bins, hidden, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict(init_state)
    params = dict(model.named_parameters())
    opt = ClipAdam(learning_rate, None, inject=False)
    state = opt.init(params)
    losses = []
    for ep in range(epochs):
        ep_losses = []
        for X, N in examples:
            X, N = as_tensor(X, dev), as_tensor(N, dev)
            ibm_x = (X.abs() ** 2 > N.abs() ** 2)[None]
            y = normalize_mask_input((X + N).abs())[None]
            lengths = torch.tensor([X.shape[0]], device=dev)
            sm, nm = model(y, lengths)
            loss = mask_estimator_loss(sm, nm, ibm_x.to(torch.float32),
                                       (~ibm_x).to(torch.float32), lengths)
            grads = torch.autograd.grad(loss, list(params.values()))
            state, _ = opt.apply(params, dict(zip(params, grads)), state)
            ep_losses.append(float(loss.detach()))
        losses.append(float(np.mean(ep_losses)))
        if log_fn:
            log_fn(f"mask-net epoch {ep}: bce {losses[-1]:.4f}")
    return model, model.state_dict(), losses


@torch.no_grad()
def estimate_masks(model, mag_per_channel):
    """Per-channel masks, median-combined across channels (nn-gev
    beamform.py's rule; an even channel count averages the two middle
    values, as np.median does). mag_per_channel: (C, T, F) magnitudes.
    Returns (speech_mask, noise_mask), (T, F) tensors on the model's
    device."""
    dev = next(model.parameters()).device
    C, T, _ = mag_per_channel.shape
    y = torch.stack([normalize_mask_input(m, dev) for m in mag_per_channel])
    sm, nm = model(y, torch.full((C,), T, device=dev))
    return median(sm, 0), median(nm, 0)
