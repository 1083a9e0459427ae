"""Word and frame error rates (port of speech_recognition_tools_tpu/eval/wer.py:
edit_distance_csid, wer_from_csid, score_hypotheses, parse_kaldi_per_utt,
per_utt_fer; sclite-style Levenshtein counts, WER = (S+I+D)*100/(C+S+D) as
Kaldi's score.sh)."""

import numpy as np


def edit_distance_csid(ref, hyp):
    """Levenshtein alignment counts (correct, substitutions, insertions,
    deletions) between token sequences."""
    R, H = len(ref), len(hyp)
    dp = np.zeros((R + 1, H + 1), np.int32)
    dp[:, 0] = np.arange(R + 1)
    dp[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # backtrace, preferring the diagonal, then deletions
    c = s = ins = dele = 0
    i, j = R, H
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] == hyp[j - 1]:
                c += 1
            else:
                s += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dele += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return c, s, ins, dele


def wer_from_csid(c, s, i, d):
    """(S+I+D)*100 / (C+S+D), 0 for an empty reference."""
    denom = c + s + d
    return (s + i + d) * 100.0 / denom if denom else 0.0


def score_hypotheses(refs: dict, hyps: dict):
    """Score {utt: tokens} against {utt: tokens}: (overall WER %,
    {utt: [wer, c, s, i, d]})."""
    per_utt = {}
    tc = ts = ti = td = 0
    for utt, ref in refs.items():
        c, s, i, d = edit_distance_csid(ref, hyps.get(utt, []))
        per_utt[utt] = [wer_from_csid(c, s, i, d), float(c), float(s), float(i), float(d)]
        tc, ts, ti, td = tc + c, ts + s, ti + i, td + d
    return wer_from_csid(tc, ts, ti, td), per_utt


def parse_kaldi_per_utt(path: str):
    """Parse scoring_kaldi/wer_details/per_utt csid lines into
    {utt: [wer, C, S, I, D]} (per_utt_wer.py:15-27)."""
    wer_dict = {}
    with open(path) as f:
        for line in f:
            if "csid" not in line:
                continue
            details = line.split()
            c, s, i, d = (float(details[k]) for k in (2, 3, 4, 5))
            wer_dict[details[0]] = [(s + i + d) * 100.0 / (c + s + d), c, s, i, d]
    return wer_dict


def per_utt_fer(post_dict: dict, ali_dict: dict):
    """Frame error rate per utterance from posteriors against alignments
    (per_utt_fer.py:40-47). As there, the errors are divided by the
    *posterior* frame count even when the alignment's length differs."""
    fer = {}
    for utt, ali in ali_dict.items():
        if utt not in post_dict:
            continue
        preds = np.argmax(post_dict[utt], axis=1)
        n = min(len(preds), len(ali))
        correct = float(np.sum(np.equal(preds[:n], np.asarray(ali)[:n])))
        fer[utt] = (float(len(preds)) - correct) * 100.0 / float(len(preds))
    return fer
