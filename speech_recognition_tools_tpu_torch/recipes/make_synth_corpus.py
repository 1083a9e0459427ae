#!/usr/bin/env python3
"""Synthesise a Kaldi-layout corpus at realistic scale for dress
rehearsals and controlled WER experiments.

The port's own copy of recipes/make_synth_corpus.py (numpy and scipy
only): the same flags, and with the same seed the same corpus, sample for
sample (wavs, text, ali.pkl, lexicon.txt).

No corpus ships with the toolkit, so this generator stands in
for the reference's data-prep stages (e2e/wsj/run_fdlp_e1.sh:126-129
local/wsj_data_prep.sh): it writes the exact layout run_corpus.py consumes
(<out>/<set>/{wav.scp,text,ali.pkl} + <out>/lexicon.txt) with

  - a LEARNABLE char-level mapping: every letter is a distinct "phone"
    whose waveform has a unique spectral signature (two log-spaced
    partials + band noise under a syllabic envelope — AR-noise carriers,
    not pure tones, so enhancement stages behave; see NOTES.md on WPE),
    so a char-token e2e model or a phone-target hybrid model can drive
    WER to a meaningful floor;
  - a realistic utterance-length distribution (log-normal, clipped to
    [min_sec, max_sec], WSJ-like ~7 s mean), word gaps and edge silences;
  - ground-truth frame alignments at 100 Hz (phone id per frame,
    silence = 0, letters = 1..26) for hybrid training and for scoring
    the native aligner's FER against truth (align/forced.py).

Usage:
  python -m speech_recognition_tools_tpu_torch.recipes.make_synth_corpus \
      --out /data/synth \
      --train_hours 4 --dev_minutes 20 --test_minutes 20
"""

import argparse
import os
import pickle
import string

import numpy as np

SIL = 0  # phone 0 = silence; letters a..z = phones 1..26


def _phone_wave(ph, n, f0_jitter, rs, srate):
    """One phone segment: two log-spaced partials tied to the phone id
    plus band-limited noise, under an attack/decay envelope."""
    t = np.arange(n) / srate
    f1 = 200.0 * (1.115 ** (ph - 1)) * f0_jitter  # 200 Hz .. ~2.8 kHz
    f2 = 1.63 * f1
    tone = np.sin(2 * np.pi * f1 * t + rs.uniform(0, 2 * np.pi)) \
        + 0.6 * np.sin(2 * np.pi * f2 * t + rs.uniform(0, 2 * np.pi))
    # AR(1) noise carrier keeps the segment from being perfectly
    # predictable (pure tones break WPE-style linear prediction stages)
    from scipy.signal import lfilter

    e = rs.randn(n).astype(np.float32)
    ar = lfilter([1.0], [1.0, -0.6], e).astype(np.float32)
    sig = tone.astype(np.float32) + 0.15 * ar
    # syllabic attack/decay envelope (10% ramps)
    ramp = max(2, int(0.1 * n))
    env = np.ones(n, np.float32)
    env[:ramp] = np.linspace(0.0, 1.0, ramp)
    env[-ramp:] = np.linspace(1.0, 0.0, ramp)
    return sig * env


def make_words(rs, n_words):
    """Fixed word inventory: 2-7 letters, zipf-ranked frequencies."""
    letters = string.ascii_lowercase
    words = set()
    while len(words) < n_words:
        L = rs.randint(2, 8)
        words.add("".join(letters[rs.randint(0, 26)] for _ in range(L)))
    words = sorted(words)
    freq = 1.0 / np.arange(1, n_words + 1) ** 1.1  # zipf
    rs.shuffle(words)
    return words, freq / freq.sum()


def synth_utterance(rs, words, p_word, target_sec, srate):
    """Returns (int16 signal, text, frame labels at 100 Hz)."""
    segs, labels, text = [], [], []
    fpsec = 100
    n_target = int(target_sec * srate)

    def add_sil(lo, hi):
        n = int(rs.uniform(lo, hi) * srate)
        n = (n // (srate // fpsec)) * (srate // fpsec)
        if n:
            segs.append(0.002 * rs.randn(n).astype(np.float32))
            labels.extend([SIL] * (n * fpsec // srate))

    add_sil(0.10, 0.35)
    total = sum(len(s) for s in segs)
    while total < n_target:
        w = words[rs.choice(len(words), p=p_word)]
        text.append(w)
        f0j = rs.uniform(0.92, 1.08)
        for ch in w:
            ph = ord(ch) - ord("a") + 1
            # durations quantised to whole frames so labels line up
            nfr = rs.randint(6, 19)  # 60-180 ms
            n = nfr * (srate // fpsec)
            segs.append(_phone_wave(ph, n, f0j, rs, srate))
            labels.extend([ph] * nfr)
        add_sil(0.06, 0.22)
        total = sum(len(s) for s in segs)
    add_sil(0.08, 0.25)
    sig = np.concatenate(segs)
    sig = sig / max(np.abs(sig).max(), 1e-6) * 0.55 * 32767
    return sig.astype(np.int16), " ".join(text), np.asarray(labels, np.int32)


def utt_lengths(rs, total_sec, min_sec, max_sec):
    """Log-normal length draws until the requested audio budget is met."""
    out = []
    acc = 0.0
    while acc < total_sec:
        d = float(np.clip(rs.lognormal(np.log(6.5), 0.45), min_sec, max_sec))
        out.append(d)
        acc += d
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--train_hours", type=float, default=4.0)
    p.add_argument("--dev_minutes", type=float, default=20.0)
    p.add_argument("--test_minutes", type=float, default=20.0)
    p.add_argument("--srate", type=int, default=16000)
    p.add_argument("--n_words", type=int, default=60)
    p.add_argument("--min_sec", type=float, default=2.0)
    p.add_argument("--max_sec", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from scipy.io.wavfile import write as wav_write

    rs = np.random.RandomState(args.seed)
    words, p_word = make_words(rs, args.n_words)
    os.makedirs(args.out, exist_ok=True)
    # lexicon: word -> phone ids (letters 1..26); silence phone is 0
    with open(os.path.join(args.out, "lexicon.txt"), "w") as f:
        for w in sorted(words):
            f.write(w + " " + " ".join(
                str(ord(c) - ord("a") + 1) for c in w) + "\n")

    budgets = [
        ("train", args.train_hours * 3600.0),
        ("dev", args.dev_minutes * 60.0),
        ("test", args.test_minutes * 60.0),
    ]
    for name, total_sec in budgets:
        d = os.path.join(args.out, name)
        wavdir = os.path.join(d, "wav")
        os.makedirs(wavdir, exist_ok=True)
        lens = utt_lengths(rs, total_sec, args.min_sec, args.max_sec)
        scp, texts, alis = [], {}, {}
        audio = 0.0
        for i, tgt in enumerate(lens):
            utt = f"{name}_{i:05d}"
            sig, text, lab = synth_utterance(
                rs, words, p_word, tgt, args.srate
            )
            path = os.path.join(wavdir, utt + ".wav")
            wav_write(path, args.srate, sig)
            scp.append(f"{utt} {path}")
            texts[utt] = text
            alis[utt] = lab
            audio += len(sig) / args.srate
        with open(os.path.join(d, "wav.scp"), "w") as f:
            f.write("\n".join(scp) + "\n")
        with open(os.path.join(d, "text"), "w") as f:
            f.write("".join(f"{k} {v}\n" for k, v in sorted(texts.items())))
        with open(os.path.join(d, "ali.pkl"), "wb") as f:
            pickle.dump(alis, f)
        print(f"{name}: {len(lens)} utts, {audio / 3600.0:.2f} h "
              f"-> {d}", flush=True)
    print("synth corpus done")


if __name__ == "__main__":
    main()
