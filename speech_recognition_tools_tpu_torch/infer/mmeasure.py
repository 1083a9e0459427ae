"""M-measure: decoder-free confidence from posterior self-similarity.

The port's own copy of speech_recognition_tools_tpu/infer/mmeasure.py
(float64 numpy; reference src/pm/score_utterance_by_mmeasure.py :23-44):
the mean symmetric KL divergence between posterior vectors Delta frames
apart, averaged over Delta in delta_list.
"""

import numpy as np


def _softmax(x):
    e = np.exp(x - np.max(x, axis=1, keepdims=True))
    return e / np.sum(e, axis=1, keepdims=True)


def compute_mmeasure(feats, delta_list=(5, 15, 25, 35, 45, 55, 65, 75), add_softmax=True):
    """M-measure of one utterance's (T, C) posteriors or logits."""
    if add_softmax:
        feats = _softmax(np.asarray(feats, np.float64))
    acc = 0.0
    for d in delta_list:
        x, y = feats[d:], feats[:-d]
        if x.shape[0] <= 0:
            continue
        m = np.sum(x * np.log(x / y) + y * np.log(y / x))
        acc += m / x.shape[0]
    return acc / len(delta_list)


def mmeasure_scores(post_iter, delta_list=(5, 15, 25, 35, 45, 55, 65, 75), add_softmax=True):
    """{utt: m-measure} over an iterator of (utt, (T, C) matrix)."""
    return {key: compute_mmeasure(mat, delta_list, add_softmax) for key, mat in post_iter}
