"""Feature transforms: deltas, PCA estimation and application.

Port of speech_recognition_tools_tpu/utils/transforms.py, the native
counterparts of the Kaldi binaries the reference pipes through: add-deltas
(window 2, edge frames clamped) and est-pca / transform-feats (the tandem
pipeline, get_Tandem_feats.sh:43-56). PCA is host numpy float64, as in the
JAX package.
"""

import numpy as np
import torch


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2) -> torch.Tensor:
    """Append delta (and delta-delta, ...) features.

    Kaldi convention: delta_t = sum_k k * (x[t+k] - x[t-k]) / (2 sum_k k^2),
    with edge frames clamped. feats: (..., T, D) -> (..., T, D * (order + 1)).
    """
    T = feats.shape[-2]
    denom = 2 * sum(k * k for k in range(1, window + 1))
    t = torch.arange(T, device=feats.device)
    outs = [feats]
    cur = feats
    for _ in range(order):
        delta = torch.zeros_like(cur)
        for k in range(1, window + 1):
            idx_p = torch.clamp(t + k, 0, T - 1)
            idx_m = torch.clamp(t - k, 0, T - 1)
            delta = delta + k * (cur.index_select(-2, idx_p) - cur.index_select(-2, idx_m))
        cur = delta / denom
        outs.append(cur)
    return torch.cat(outs, dim=-1)


def estimate_pca(feats, dim: int | None = None, normalize_variance=False):
    """Estimate a PCA transform from (N, D) frames (est-pca equivalent).

    Returns (transform (dim, D), mean (D,)) as float64 numpy; apply as
    (x - mean) @ transform.T.
    """
    x = np.asarray(feats, np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / x.shape[0]
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    d = dim or x.shape[1]
    T = evecs[:, :d].T
    if normalize_variance:
        T = T / np.sqrt(np.maximum(evals[:d], 1e-12))[:, None]
    return T, mean


def apply_pca(feats, transform, mean):
    return (np.asarray(feats) - mean) @ np.asarray(transform).T
