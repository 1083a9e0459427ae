"""Lifelong / continual-learning decoding by likelihood fusion.

Port of speech_recognition_tools_tpu/infer/lifelong.py, its own copy (the
module is numpy and scipy only; the port imports nothing of the JAX
package). Parity targets: compute_advanced_likelihood.py (powerset fusion
:44-52, :132-184), compute_incremental_likelihood.py (task-prior-weighted
sum, mm/dp/lowent priors :120-190), compute_*_perframe / _autoT variants.

Given K task classifiers p_k(c|x) and K generative (VAE) density models
p_k(x), decode-time posteriors are fused over tasks weighted by task
priors that may be data-driven: the per-utterance VAE likelihood is
sharpened through exp(beta * mean px) and normalised; the m-measure of the
classifier posteriors is an alternative confidence; 'lowent' picks
whichever distribution has lower entropy. The fusion math runs on the
host in float64 over (T, C) posterior matrices.
"""

from itertools import chain, combinations

import numpy as np


def powerset(items):
    """All subsets (reference :44-52, including the empty set)."""
    s = list(items)
    return [list(c) for c in chain.from_iterable(
        combinations(s, r) for r in range(len(s) + 1))]


def framewise_vae_score(x, ae_out, means, logvars):
    """Per-frame VAE score exp-argument (reference vae_loss with dim=1 mean,
    compute_advanced_likelihood.py:20-24): gaussian log-lhood + KL term,
    averaged over feature dims."""
    ll = np.mean(-0.5 * (x - ae_out) ** 2 - 0.5 * np.log(2 * np.pi), axis=-1)
    kl = 0.5 * np.mean(
        1 - means**2 - np.exp(logvars) ** 2 + 2 * logvars, axis=-1
    )
    return ll + kl


def mmeasure_loss(post, del_list=(5, 25, 45, 65)):
    """Symmetric-KL confidence across frame deltas (reference
    compute_advanced_likelihood.py:27-41). post: (T, C) probabilities."""
    acc = 0.0
    for d in del_list:
        x, y = post[d:], post[:-d]
        if x.shape[0] == 0:
            continue
        n = x.shape[0]
        sym = (np.sum(x * (np.log(x) - np.log(y)))
               + np.sum(y * (np.log(y) - np.log(x)))) / n
        # reference adds an (elementwise-mean) KLDivLoss(y, x) term
        kld = np.mean(x * (np.log(x) - y))
        acc += sym + kld
    return acc / len(del_list)


def task_priors(mode, px_means, posteriors=None, fixed=None, beta=300.0):
    """Task-prior vector over K tasks.

    mode: 'dp' (softmax of beta * mean VAE score — reference uses beta=300
      for the powerset fusion and 500 for incremental), 'mm' (softmax of
      m-measure), 'lowent' (pick the lower-entropy of dp/mm), or 'fixed'.
    """
    K = len(px_means)
    if mode == "fixed":
        return np.asarray(fixed, np.float64)
    if mode == "dp":
        z = np.exp(beta * np.asarray(px_means, np.float64))
        return z / z.sum()
    if mode == "mm":
        mm = np.asarray([mmeasure_loss(p) for p in posteriors])
        z = np.exp(mm)
        tp = z / z.sum()
        if np.isnan(tp[0]):
            tp = np.ones(K) / K
        return tp
    if mode == "lowent":
        from scipy.stats import entropy

        tp_mm = task_priors("mm", px_means, posteriors)
        z = np.exp(200.0 * np.asarray(px_means, np.float64))
        tp_dp = z / z.sum()
        return tp_dp if entropy(tp_dp) < entropy(tp_mm) else tp_mm
    raise ValueError(mode)


def lifelong_fusion_powerset(all_pcx, log_priors, tp, prior_weight=0.8,
                             weighted_power=False):
    """Powerset fusion (reference compute_advanced_likelihood.py:163-183).

    Args:
      all_pcx: list of K (T, C) classifier posteriors.
      log_priors: list of K (C,) class log-priors.
      tp: (K,) task priors.
      weighted_power: the postpm variant's geometric weighting
        (compute_advanced_likelihood_postpm.py:169: num_prod *=
        pcx^tp[b] instead of the plain product).
    Returns (T, C) log-likelihoods: log(num) - prior_weight*log(denom).
    """
    K = len(all_pcx)
    T, C = all_pcx[0].shape
    num = np.zeros((T, C))
    denom = np.zeros(C)
    for subset in powerset(range(K)):
        num_prod = np.ones((T, C))
        denom_prod = np.ones(C)
        perf_mon = 1.0
        for b in subset:
            if weighted_power:
                num_prod = num_prod * np.power(all_pcx[b], tp[b])
            else:
                num_prod = num_prod * all_pcx[b]
            perf_mon = perf_mon * tp[b]
            denom_prod = denom_prod * np.exp(log_priors[b])
        denom_prod = denom_prod / denom_prod.sum()
        num_prod = num_prod / num_prod.sum(axis=1, keepdims=True)
        num += num_prod * perf_mon
        denom += denom_prod
    return np.log(num) - prior_weight * np.log(denom)


def lifelong_fusion_incremental(all_pcx, log_priors, tp, prior_weight=0.8):
    """Incremental fusion (compute_incremental_likelihood.py:179-186):
    task-prior-weighted sum of per-task prior-normalised log posteriors."""
    K = len(all_pcx)
    post = np.zeros_like(all_pcx[0])
    for k, pcx in enumerate(all_pcx):
        post += (np.log(pcx) - prior_weight * log_priors[k]) * tp[k]
    return post / K


def lifelong_fusion_perframe(all_pcx, all_px_frame, log_priors,
                             prior_weight=0.8, beta=300.0):
    """Per-frame variant: the task weighting uses the frame-level VAE
    scores instead of the utterance mean (compute_*_perframe)."""
    K = len(all_pcx)
    T, C = all_pcx[0].shape
    px = np.stack(all_px_frame)  # (K, T)
    w = np.exp(beta * px)
    w = w / w.sum(axis=0, keepdims=True)  # (K, T) per-frame task priors
    num = np.zeros((T, C))
    denom = np.zeros(C)
    for k in range(K):
        num += all_pcx[k] * w[k][:, None]
        dp = np.exp(log_priors[k])
        denom += dp / dp.sum()
    return np.log(num) - prior_weight * np.log(denom / K)


def autoT_fusion(all_pcx, log_priors, px_means, prior_weight=0.8,
                 t_grid=(1, 10, 50, 100, 200, 300, 500, 1000)):
    """Temperature-searched fusion (compute_advanced_likelihood_autoT.py
    :187-230). The reference's gradient step on T is inert dead code (the
    backward pass is commented out and T just increments); here the
    documented intent — pick the temperature of the dp task-prior softmax
    that maximises the mean fused log-likelihood — is implemented as an
    explicit grid search.
    """
    best, best_llh, best_t = None, -np.inf, None
    for t in t_grid:
        z = np.exp(t * np.asarray(px_means, np.float64))
        tp = z / z.sum()
        llh = lifelong_fusion_powerset(all_pcx, log_priors, tp, prior_weight)
        m = float(np.mean(llh))
        if m > best_llh:
            best, best_llh, best_t = llh, m, t
    return best, best_t
