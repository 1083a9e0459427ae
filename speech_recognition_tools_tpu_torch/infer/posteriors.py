"""Posterior / log-likelihood extraction and class priors.

Port of speech_recognition_tools_tpu/infer/posteriors.py::extract_posteriors,
genclassifier_outputs, compute_log_prior_from_counts and
compute_log_prior_from_alignments (reference
extract_posterior.py :39-68, dump_genclassifier_outputs.py :100-106,
compute_log_prior.py :20-40).
"""

import numpy as np
import torch


def extract_posteriors(apply_fn, feats, lengths, *, layer: int = 0,
                       add_softmax: bool = True):
    """Run an AM and return per-frame outputs.

    apply_fn(feats, lengths) returns (embeds_list, logits) or logits.
    layer 0 gives the final logits (softmaxed if add_softmax); layer k > 0
    the k-th embedding counted from the end.
    """
    out = apply_fn(feats, lengths)
    if isinstance(out, tuple):
        embeds, logits = out
    else:
        embeds, logits = [], out
    if layer == 0:
        return torch.softmax(logits, dim=-1) if add_softmax else logits
    return embeds[-layer]


def genclassifier_outputs(logits, log_prior=None, prior_weight: float = 0.8,
                          add_softmax: bool = False):
    """Hybrid-decode outputs: log p(c|x) - prior_weight * log p(c)."""
    if log_prior is not None:
        log_prior = torch.as_tensor(log_prior, dtype=logits.dtype,
                                    device=logits.device)
        return torch.log_softmax(logits, dim=-1) - prior_weight * log_prior
    if add_softmax:
        return torch.softmax(logits, dim=-1)
    return logits


def compute_log_prior_from_counts(counts):
    counts = np.asarray(counts, np.float64)
    return np.log(counts / counts.sum())


def compute_log_prior_from_alignments(ali_iter, num_classes: int,
                                      ali_type: str = "pdf"):
    """Class log-priors from (utt, int-vector) alignments. ali_type='phone'
    shifts labels by -1 like the reference (ali-to-phones is 1-based);
    labels outside [0, num_classes) are not counted."""
    p = np.zeros(num_classes, np.float64)
    for _, ali in ali_iter:
        ali = np.asarray(ali)
        if ali_type == "phone":
            ali = ali - 1
        np.add.at(p, ali[(ali >= 0) & (ali < num_classes)], 1)
    return np.log(p / p.sum())
