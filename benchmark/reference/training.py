"""Plain reference of the training steps: the hybrid GRU classifier's
masked cross-entropy, the e2e model's joint CTC/attention loss, and Adam
after clipping by the global norm, from the same first weights and
batches as the program.

The optimizer is optax's `clip_by_global_norm` then `adam` written out:
g <- g * c / |g| where |g| >= c; mu <- b1 mu + (1 - b1) g,
nu <- b2 nu + (1 - b2) g^2, p <- p - lr (mu / (1 - b1^t)) /
(sqrt(nu / (1 - b2^t)) + eps). Gradients come from autograd over the
reference's own forward pass. Imports nothing of the port.
"""

import torch
import torch.nn.functional as F

from benchmark.reference import transformer as ref
from benchmark.reference.precision import Precision


def gru_classifier_logits(W: ref.Weights, feats, lengths, layers: int):
    """Masked GRU stack (the carry frozen past each length, padded outputs
    zero) and the per-frame output layer: (B, T, D) -> (B, T, C)."""
    B, T, _ = feats.shape
    valid = torch.arange(T, device=feats.device)[None, :] < lengths[:, None]
    x = W.P.t(feats)
    for i in range(layers):
        p = f"gru.layers.{i}"
        xi = W.P.linear(x, W[p + ".weight_ih"], W[p + ".bias_ih"])
        h = xi.new_zeros(B, W[p + ".weight_hh"].shape[1])
        outs = []
        for t in range(T):
            h_new = ref.gru_cell(W.P, xi[:, t], h, W[p + ".weight_hh"], W[p + ".bias_hn"])
            keep = valid[:, t, None]
            h = torch.where(keep, h_new, h)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        x = torch.stack(outs, 1)
    return W.lin(x, "regression")


def hybrid_loss(W: ref.Weights, batch: dict, am: dict):
    """Mean cross-entropy over the valid frames."""
    feats = torch.as_tensor(batch["feats"])
    lengths = torch.as_tensor(batch["lengths"]).to(feats.device).long()
    labels = torch.as_tensor(batch["labels"]).to(feats.device).long()
    logits = gru_classifier_logits(W, feats, lengths, am["num_layers"])
    valid = (torch.arange(feats.shape[1], device=feats.device)[None, :]
             < lengths[:, None]).to(logits.dtype)
    nll = -torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum()


def e2e_loss(W: ref.Weights, batch: dict, am: dict):
    """mtlalpha CTC (per utterance, over its token count, averaged) +
    (1 - mtlalpha) label-smoothed attention cross-entropy over the
    token_len + 1 targets (eos last), smoothing lsm_weight * -mean(logp)
    over the whole vocabulary."""
    feats = torch.as_tensor(batch["feats"])
    dev = feats.device
    lengths = torch.as_tensor(batch["lengths"]).to(dev).long()
    tokens = torch.as_tensor(batch["tokens"]).to(dev).long()
    tlen = torch.as_tensor(batch["token_lengths"]).to(dev).long()
    eos = am["vocab_size"] - 1
    memory, enc_len, ctc_logp = ref.encode(W, feats, lengths, am)
    ctc = F.ctc_loss(ctc_logp.transpose(0, 1), tokens, enc_len, tlen, blank=0,
                     reduction="none", zero_infinity=False)
    ctc = (ctc / tlen.clamp_min(1).to(ctc.dtype)).mean()
    B, U = tokens.shape
    pos = torch.arange(U, device=dev)[None, :]
    tok_in = torch.cat([torch.full((B, 1), eos, dtype=torch.long, device=dev),
                        tokens[:, :-1]], 1)
    tok_in = torch.where(pos <= tlen[:, None], tok_in, -1)
    logp = ref.decoder_logp(W, tok_in, memory, enc_len, am)
    tgt = torch.where(pos == tlen[:, None], eos, tokens)
    valid = (pos <= tlen[:, None]).to(logp.dtype)
    nll = -logp.gather(-1, tgt.clamp_min(0)[..., None])[..., 0]
    ce = (1 - am["lsm_weight"]) * nll + am["lsm_weight"] * -logp.mean(-1)
    att = (ce * valid).sum() / valid.sum()
    return am["mtlalpha"] * ctc + (1 - am["mtlalpha"]) * att


LOSSES = {"rnn": hybrid_loss, "transformer_asr": e2e_loss}


def adam_steps(weights: dict, batches: list, am: dict, lr_at, clip: float, b2: float,
               P: Precision, b1: float = 0.9, eps: float = 1e-8):
    """len(batches) clipped Adam steps from `weights` (name -> tensor).

    lr_at(count) is the rate of the update after `count` earlier ones.
    Returns (losses, the first step's clipped gradients, the weights after
    the last step), tensors of P's dtype."""
    loss_fn = LOSSES[am["type"]]
    params = {k: P.t(v).clone().requires_grad_(True) for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for count, batch in enumerate(batches):
        loss = loss_fn(ref.Weights(params, P), batch, am)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if clip is not None and not gnorm < clip:
            grads = {k: g / gnorm.to(g.dtype) * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        t = count + 1
        lr = lr_at(count)
        with torch.no_grad():
            for k, p in params.items():
                mu[k] = b1 * mu[k] + (1 - b1) * grads[k]
                nu[k] = b2 * nu[k] + (1 - b2) * grads[k] ** 2
                upd = (mu[k] / (1 - b1**t)) / (torch.sqrt(nu[k] / (1 - b2**t)) + eps)
                p -= lr * upd
        losses.append(loss.detach())
    return losses, first, {k: v.detach() for k, v in params.items()}
