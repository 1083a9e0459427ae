"""Unsupervised test-time adaptation driven by a frozen PM autoencoder.

Port of speech_recognition_tools_tpu/infer/adapt.py (the reference's
nnet_adapt_*.py family; core loop nnet_adapt_ae.py:224-318): run the
acoustic model on unlabeled test utterances, subtract the PM training
mean from its outputs, reconstruct them with a frozen RNN autoencoder, and
fine-tune the AM so that the PM's reconstruction loss falls.

The PM is frozen as the reference freezes it: its parameters get
requires_grad_(False) and stay out of the optimizer, while the gradient
still flows through it into the AM. One `AdaptConfig` covers the
reference's script variants:

  time_shift        nnet_adapt_ae.py (predict the sequence shifted ahead)
  time_shifts       nnet_adapt_multishift_*.py (mean over the shifts)
  loss              'mse' or 'l1'
  l2_source         nnet_adapt_*_regularized.py (L2 pull to the source AM)
  contrastive       nnet_adapt_contrastive_*.py (positive / negative ratio,
                    the negatives the sequence shifted by +-t)
  supervised_weight the lightly-supervised variants (CE on given labels)
  mm_weight         nnet_adapt_feedforward_AEPC.py (:275-277): minus
                    mm_weight x the M-measure of the AM's posteriors over
                    `mm_deltas`, each delta's term the frame-mean symmetric
                    KL plus the reference's elementwise x * (log x - y)
                    (its KLDivLoss on raw probabilities), per utterance
                    under the length mask.

The optimizer is train/optim.py's make_optimizer (global-norm clip 1.0,
then the named rule), as optax chains it in the JAX package.
"""

from collections.abc import Callable
from dataclasses import dataclass

import torch

from speech_recognition_tools_tpu_torch.train.losses import masked_cross_entropy
from speech_recognition_tools_tpu_torch.train.optim import make_optimizer


@dataclass(frozen=True)
class AdaptConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    time_shift: int = 0
    time_shifts: tuple = ()  # multishift variant; () = time_shift only
    loss: str = "mse"  # 'mse' | 'l1'
    l2_source: float = 0.0  # pull-to-source regulariser
    contrastive: bool = False
    neg_weight: float = 1.0
    supervised_weight: float = 0.0  # CE weight for lightly-supervised
    mm_weight: float = 0.0  # M-measure weight (AEPC variant)
    mm_deltas: tuple = (5, 25, 45, 65)


def _framewise(kind, pred, target):
    err = (pred - target).abs() if kind == "l1" else (pred - target) ** 2
    return err.mean(dim=-1)


def _recon_loss(kind, pred, target):
    err = (pred - target).abs() if kind == "l1" else (pred - target) ** 2
    return err.mean()


def _default_apply(am, feats, lengths):
    return am(feats, lengths)


def make_adapt_loss(am, pm, pm_mean, cfg: AdaptConfig = AdaptConfig(), source_params=None,
                    am_apply: Callable = _default_apply):
    """The adaptation loss of the JAX loss_fn: batch (dict of feats,
    lengths[, labels] tensors) -> a scalar tensor, differentiable in `am`'s
    parameters. am_apply(am, feats, lengths) gives logits or (embeds,
    logits); `pm` is called (seq, lengths) and its first output taken;
    source_params: {name: tensor} for the L2 regulariser."""
    shifts = tuple(cfg.time_shifts) or ((cfg.time_shift,) if cfg.time_shift else ())

    def pm_recon(seq, lengths):
        out = pm(seq, lengths)
        return out[0] if isinstance(out, tuple) else out

    def loss_fn(batch):
        feats, lengths = batch["feats"], batch["lengths"]
        out = am_apply(am, feats, lengths)
        logits = out[1] if isinstance(out, tuple) else out
        post = logits - torch.as_tensor(pm_mean, dtype=logits.dtype, device=logits.device)

        def shifted_loss(ts):
            if ts == 0:
                return _recon_loss(cfg.loss, pm_recon(post, lengths), post)
            recon = pm_recon(post[:, :-ts, :], lengths - ts)
            return _recon_loss(cfg.loss, recon, post[:, ts:, :])

        if cfg.contrastive:
            max_ts = max(shifts) if shifts else 1
            T = post.shape[1]
            recon = pm_recon(post, lengths)[:, max_ts:-max_ts - 1]
            pos = _framewise(cfg.loss, recon, post[:, max_ts:-max_ts - 1])
            neg = torch.zeros_like(pos)
            for t in shifts or (1,):
                neg = neg + _framewise(cfg.loss, recon, post[:, max_ts + t:T - max_ts - 1 + t])
                neg = neg + _framewise(cfg.loss, recon, post[:, max_ts - t:T - max_ts - 1 - t])
            neg = neg * cfg.neg_weight / (2 * max(len(shifts), 1))
            loss = (pos / neg.clamp_min(1e-8)).mean()
        elif shifts:
            loss = sum(shifted_loss(t) for t in shifts) / len(shifts)
        else:
            loss = shifted_loss(0)

        if cfg.mm_weight:
            p = torch.softmax(logits, dim=-1).clamp_min(1e-8)
            T, C = p.shape[1], p.shape[2]
            mm = 0.0
            for d in cfg.mm_deltas:
                if d >= T:
                    continue
                x, y = p[:, d:], p[:, :-d]
                valid = ((torch.arange(T - d, device=p.device)[None, :] + d)
                         < lengths[:, None]).to(p.dtype)
                nvalid = valid.sum().clamp_min(1.0)
                lx, ly = torch.log(x), torch.log(y)
                sym = (x * (lx - ly) + y * (ly - lx)).sum(dim=-1)
                kld = (x * (lx - y)).sum(dim=-1)  # the reference's KLDivLoss quirk
                mm = mm + (sym * valid).sum() / nvalid + (kld * valid).sum() / (nvalid * C)
            loss = loss - cfg.mm_weight * mm / len(cfg.mm_deltas)
        if cfg.l2_source and source_params is not None:
            loss = loss + cfg.l2_source * sum(((p - source_params[n]) ** 2).sum()
                                              for n, p in am.named_parameters())
        if cfg.supervised_weight and "labels" in batch:
            loss = loss + cfg.supervised_weight * masked_cross_entropy(
                logits, batch["labels"], lengths)
        return loss

    return loss_fn


def make_adapt_step(am, pm, pm_mean, cfg: AdaptConfig = AdaptConfig(), source_params=None,
                    am_apply: Callable = _default_apply):
    """(step, optimizer): step(opt_state, batch) -> (opt_state, loss) takes
    one optimizer step of `am`'s parameters in place on make_adapt_loss's
    loss (the loss is the one before the step, as the JAX step returns
    it). `pm` is frozen here: requires_grad_(False), eval mode, and none of
    its parameters in the optimizer. Both run in eval mode (no dropout), as
    the JAX loss applies them deterministically."""
    am.eval()
    pm.eval()
    for p in pm.parameters():
        p.requires_grad_(False)
    loss_fn = make_adapt_loss(am, pm, pm_mean, cfg, source_params, am_apply)
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate)
    params = dict(am.named_parameters())

    def step(opt_state, batch):
        for p in params.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        opt_state, _ = opt.apply(params, {n: p.grad for n, p in params.items()}, opt_state)
        return opt_state, loss.detach()

    return step, opt


def adapt_model(am, pm, pm_mean, batches: Callable, cfg: AdaptConfig = AdaptConfig(),
                epochs: int = 1, eval_fn: Callable | None = None,
                log_fn: Callable[[str], None] = print, am_apply: Callable = _default_apply):
    """The adaptation loop (reference :224-318): `epochs` passes over
    batches() (an iterator of dicts of tensors), the AM adapted in place
    with the L2 pull (if any) toward its parameters on entry. eval_fn(am)
    -> dict of dev metrics, logged before the first epoch and after each.
    Returns `am`."""
    source = {n: p.detach().clone() for n, p in am.named_parameters()}
    step, opt = make_adapt_step(am, pm, pm_mean, cfg, source, am_apply)
    opt_state = opt.init(dict(am.named_parameters()))
    if eval_fn is not None:
        log_fn(f"epoch -1: {eval_fn(am)}")
    for epoch in range(epochs):
        losses = []
        for batch in batches():
            opt_state, loss = step(opt_state, batch)
            losses.append(float(loss))
        msg = f"epoch {epoch}: pm loss {sum(losses) / max(len(losses), 1):.5f}"
        if eval_fn is not None:
            msg += f" dev {eval_fn(am)}"
        log_fn(msg)
    return am
