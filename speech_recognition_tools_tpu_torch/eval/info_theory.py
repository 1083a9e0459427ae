"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/eval/info_theory.py, kept in the port so that it
imports nothing of the JAX package.

Feature-label information-theoretic analysis.

Parity targets: src/info_theory/compute_minmax.py (:39-50),
compute_signal_label_histogram.py (joint feature-bin x label histograms
per feature dim :32-61, transition marking :105-121),
combine_histogram_dumps.py (:14-25), plus mutual information computed from
the joint histograms (the reference's downstream analysis).

Vectorised: the reference's per-frame per-dim bisect loop becomes one
np.digitize + bincount per feature dimension.
"""

import numpy as np


def feats_minmax(feat_dict):
    """Global min/max over a {utt: array} dict (compute_minmax.py:39-50)."""
    mn, mx = np.inf, -np.inf
    for v in feat_dict.values():
        mn = min(mn, float(np.min(v)))
        mx = max(mx, float(np.max(v)))
    return mn, mx


def signal_label_histogram(
    alis, feats, feat_range, num_labels, feat_dim=None, num_bins=100,
    labels_one_based=True,
):
    """Joint (feature-bin x label) histogram per feature dim.

    Replicates get_signal_label_joint_distribution (:32-61): bins are
    bisect_left positions into linspace(mn, mx, num_bins+1), clamped to
    [1, num_bins], labels shifted by -1 when one-based (ali-to-phones).

    Returns (feat_dim, num_bins, num_labels).
    """
    mn, mx = feat_range
    sig_bins = np.linspace(mn, mx, num_bins + 1)
    first = next(iter(feats.values()))
    D = feat_dim or first.shape[1]
    dist = np.zeros((D, num_bins, num_labels))
    for key, f in feats.items():
        lab = np.asarray(alis[key])
        n = min(len(lab), f.shape[0])
        lab = lab[:n] - (1 if labels_one_based else 0)
        # bisect_left == np.searchsorted(side='left'), then clamp like ref
        ii = np.searchsorted(sig_bins, f[:n, :D], side="left")
        ii = np.clip(ii, 1, num_bins) - 1
        for r in range(D):
            np.add.at(dist[r], (ii[:, r], lab), 1)
    return dist


def mark_transitions(ali):
    """Binary phone-boundary marks (get_transitions :105-121): frames at
    and adjacent to a label change are 1. Note the reference writes
    one_trans[idx+1] without bounds checking; we clamp instead of crashing."""
    ali = np.asarray(ali)
    trans = np.zeros(len(ali))
    change = np.nonzero(ali[1:] != ali[:-1])[0] + 1
    for idx in change:
        trans[idx] = 1
        trans[idx - 1] = 1
        if idx + 1 < len(trans):
            trans[idx + 1] = 1
    return trans


def combine_histograms(dists, eps=1e-13):
    """Sum histogram dumps + epsilon (combine_histogram_dumps.py:22-25)."""
    total = np.zeros_like(dists[0])
    for d in dists:
        total = total + d
    return total + eps


def mutual_information(joint):
    """MI per feature dim from (D, bins, labels) joint histograms."""
    out = np.zeros(joint.shape[0])
    for r in range(joint.shape[0]):
        p = joint[r] / joint[r].sum()
        px = p.sum(axis=1, keepdims=True)
        py = p.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            term = p * np.log(p / (px * py))
        out[r] = np.nansum(term)
    return out
