#!/usr/bin/env python3
"""REVERB-style multichannel recipe: simulate -> WPE -> mask-net/GEV ->
enhancement metrics -> FDLP featgen -> e2e transformer ASR, with the
reference's staged-resume contract (--stage N / --stop_stage M), on the
PyTorch/CUDA port.

Port of recipes/reverb_demo/run.py. It runs on the card unless
`--device cpu` is given: the simulation, the mask net and the STFTs of
stage 2, featgen and the e2e model run on the device; WPE (stage 1), the
GEV weights and the metrics are host numpy, as in the JAX recipe. The JAX
recipe pins JAX to the CPU because its TPU backend cannot move complex
arrays to the host; torch has no such limit, so there is no pin here.

The reference runs this capability as a shell pipeline
(e2e/reverb/run_fdlp_e1.sh stage 0: generate_data + run_wpe.sh +
run_beamform.sh + compute_se_scores.sh, then FDLP featgen and transformer
train/decode; mask-GEV from recipes/chime4/local/nn-gev). Here every
stage is a native call into the toolkit on synthetic multichannel data.

Stages:
  0  simulate: tone-word clean speech -> reverberant noisy C-channel corpus
     (dsp.simulate, the Generate_mcTrainData_cut.m analogue) + text
  1  WPE dereverberation per utterance (enhance.wpe)
  2  BLSTM mask-net training on simulated parallel wet/noise STFTs,
     then GEV+BAN beamforming of the WPE output (nn-gev pipeline)
  3  enhancement metrics: PESQ / STOI / SRMR / fwSegSNR / cepsdist
     for noisy-ch0 vs enhanced (compute_se_scores.sh analogue)
  4  FDLP featgen (production cochlear front-end geometry, scaled down)
  5  e2e transformer ASR train + joint CTC/attention decode -> WER

Run:  python -m speech_recognition_tools_tpu_torch.recipes.reverb_demo \\
          --expdir /tmp/reverb_demo [--device cpu]
"""

import argparse
import json
import os

import numpy as np
import torch

WORD_F0 = {"a": 130.0, "b": 220.0, "c": 340.0, "d": 500.0, "e": 710.0}


def synth_tone_sentence(rs, words, fs, word_dur=0.25, gap=0.08):
    """Speech-like synthetic sentence: each word is a burst of band-limited
    noise in a word-specific frequency band, raised-cosine enveloped.

    Noise carriers (not tones) on purpose: WPE models speech as short-time
    *unpredictable* — a pure sinusoid is perfectly linearly predictable
    from its past, so WPE would cancel the signal itself. Band-passed
    noise keeps the word identity in the spectrum while staying
    WPE-compatible, like real speech."""
    n_word, n_gap = int(word_dur * fs), int(gap * fs)
    out = [np.zeros(n_gap)]
    for w in words:
        f0 = WORD_F0[w]
        spec = np.fft.rfft(rs.randn(n_word))
        freqs = np.fft.rfftfreq(n_word, 1.0 / fs)
        band = (freqs >= f0) & (freqs <= 1.8 * f0)
        sig = np.fft.irfft(spec * band, n_word)
        sig /= max(np.std(sig), 1e-9)
        env = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_word) / n_word))
        out.append(sig * env)
        out.append(np.zeros(n_gap))
    return np.concatenate(out).astype(np.float32)


def read_scp_paths(path):
    out = {}
    with open(path) as f:
        for line in f:
            k, v = line.strip().split(None, 1)
            out[k] = v
    return out


def load_wav(path):
    from scipy.io.wavfile import read as wav_read

    _, sig = wav_read(path)
    return np.asarray(sig, np.float64)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--expdir", default="exp/reverb_demo")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop_stage", type=int, default=99)
    p.add_argument("--num_utts", type=int, default=24)
    p.add_argument("--num_channels", type=int, default=4)
    p.add_argument("--snr_db", type=float, default=5.0)
    p.add_argument("--srate", type=int, default=16000)
    p.add_argument("--stft_size", type=int, default=512)
    p.add_argument("--stft_shift", type=int, default=128)
    p.add_argument("--masknet_epochs", type=int, default=8)
    p.add_argument("--e2e_epochs", type=int, default=30)
    p.add_argument("--words_per_utt", type=int, default=4)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    from speech_recognition_tools_tpu_torch.device import (
        configure_cuda,
        resolve_device,
    )

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        configure_cuda()
    device = str(dev)
    exp = args.expdir
    os.makedirs(exp, exist_ok=True)
    rs = np.random.RandomState(0)
    fs = args.srate
    sz, sh = args.stft_size, args.stft_shift

    def in_range(s):
        return args.stage <= s <= args.stop_stage

    if in_range(0):
        print("=== stage 0: simulate multichannel corpus")
        from speech_recognition_tools_tpu_torch.dsp.simulate import simulate_corpus

        utts, text_lines = [], []
        for i in range(args.num_utts):
            words = [
                "abcde"[rs.randint(5)] for _ in range(args.words_per_utt)
            ]
            utts.append((f"utt{i}", synth_tone_sentence(rs, words, fs)))
            text_lines.append(f"utt{i} {' '.join(words)}")
        # pink-ish corpus noise (shared recording, random offsets per utt)
        white = rs.randn(fs * 20)
        noise = np.convolve(white, np.ones(8) / 8.0, mode="same")
        simulate_corpus(
            utts, os.path.join(exp, "wav"), fs=fs,
            n_channels=args.num_channels, snr_db=args.snr_db,
            noise=np.asarray(noise, np.float32), seed=1, device=device,
        )
        with open(os.path.join(exp, "text"), "w") as f:
            f.write("\n".join(text_lines) + "\n")

    if in_range(1):
        print("=== stage 1: WPE dereverberation")
        from scipy.io.wavfile import write as wav_write

        from speech_recognition_tools_tpu_torch.enhance.wpe import wpe_dereverberate

        ch_scps = [
            read_scp_paths(os.path.join(exp, "wav", f"wav_ch{c}.scp"))
            for c in range(args.num_channels)
        ]
        os.makedirs(os.path.join(exp, "wpe"), exist_ok=True)
        lines = []
        for utt in ch_scps[0]:
            sigs = np.stack([load_wav(s[utt]) for s in ch_scps])
            derev = wpe_dereverberate(sigs, size=sz, shift=sh)
            path = os.path.join(exp, "wpe", f"{utt}.wav")
            np.save(path + ".npy", derev.astype(np.float32))
            wav_write(path, fs, derev[0].astype(np.float32))
            lines.append(f"{utt} {path}")
        with open(os.path.join(exp, "wpe.scp"), "w") as f:
            f.write("\n".join(lines) + "\n")

    if in_range(2):
        print("=== stage 2: mask-net training + GEV beamforming")
        from scipy.io.wavfile import write as wav_write

        from speech_recognition_tools_tpu_torch.enhance.beamforming import gev_beamform
        from speech_recognition_tools_tpu_torch.enhance.mask_model import (
            estimate_masks,
            train_mask_estimator,
        )
        from speech_recognition_tools_tpu_torch.enhance.stft import istft, stft

        wet = read_scp_paths(os.path.join(exp, "wav", "wet.scp"))
        noi = read_scp_paths(os.path.join(exp, "wav", "noise.scp"))
        train_utts = sorted(wet)[: max(4, len(wet) // 2)]
        examples = []
        for utt in train_utts:
            X = stft(load_wav(wet[utt]), size=sz, shift=sh, device=device)
            N = stft(load_wav(noi[utt]), size=sz, shift=sh, device=device)
            examples.append((X, N))
        bins = sz // 2 + 1
        model, _, losses = train_mask_estimator(
            examples, bins, hidden=64, epochs=args.masknet_epochs,
            log_fn=print, device=device,
        )
        del examples  # the STFT pairs and the net leave the card with stage 2
        # the JAX recipe asserts losses[-1] < losses[0], which a single
        # epoch can never meet; the check needs two epochs to compare
        if len(losses) > 1 and not losses[-1] < losses[0]:
            raise RuntimeError(f"mask-net failed to learn: bce {losses}")

        wpe_scp = read_scp_paths(os.path.join(exp, "wpe.scp"))
        os.makedirs(os.path.join(exp, "gev"), exist_ok=True)
        lines = []
        for utt, path in wpe_scp.items():
            sigs = np.load(path + ".npy")  # (C, N) WPE output
            Y = stft(sigs, size=sz, shift=sh, device=device)  # (C, T, F)
            # per-channel masks, median across channels (nn-gev beamform.py
            # takes the channel median of the estimated masks)
            sm, nm = estimate_masks(model, Y.abs())
            # binarize: soft speech leakage into the noise PSD estimate
            # wrecks the BAN gain (PESQ -0.1 soft vs +1.4 binary in the
            # JAX recipe); the training targets are binary masks anyway
            sm = (sm > 0.5).double().cpu().numpy()
            nm = (nm > 0.5).double().cpu().numpy()
            # gev_beamform wants (bins, sensors, frames) + (bins, frames)
            enh_fT = gev_beamform(
                Y.cpu().numpy().transpose(2, 0, 1), sm.T, nm.T, ban=True,
            )  # (F, T)
            enh = istft(torch.as_tensor(enh_fT.T)[None], size=sz, shift=sh,
                        device=device)[0].cpu().numpy()
            out = os.path.join(exp, "gev", f"{utt}.wav")
            wav_write(out, fs, enh[: sigs.shape[1]].astype(np.float32))
            lines.append(f"{utt} {out}")
        del model
        with open(os.path.join(exp, "enhanced.scp"), "w") as f:
            f.write("\n".join(lines) + "\n")

    if in_range(3):
        print("=== stage 3: enhancement metrics (noisy ch0 vs enhanced)")
        from speech_recognition_tools_tpu_torch.eval.enhancement_metrics import (
            cepsdist,
            fwsegsnr,
            stoi,
        )
        from speech_recognition_tools_tpu_torch.eval.srmr import srmr
        from speech_recognition_tools_tpu_torch.io.native import pesq

        clean = read_scp_paths(os.path.join(exp, "wav", "clean.scp"))
        noisy = read_scp_paths(os.path.join(exp, "wav", "wav.scp"))
        enh = read_scp_paths(os.path.join(exp, "enhanced.scp"))
        scores = {"noisy": {}, "enhanced": {}}
        for label, scp in (("noisy", noisy), ("enhanced", enh)):
            pesqs, stois, srmrs, fwsnrs, cds = [], [], [], [], []
            for utt, path in scp.items():
                ref = load_wav(clean[utt])
                deg = load_wav(path)
                n = min(len(ref), len(deg))
                ref, deg = ref[:n], deg[:n]
                try:
                    pesqs.append(pesq(ref, deg, fs))
                except ValueError as e:  # too short to score: left out
                    print(f"{label} {utt}: no PESQ ({e})")
                stois.append(stoi(ref, deg, fs))
                srmrs.append(srmr(deg, fs))
                fwsnrs.append(fwsegsnr(deg, ref, fs)[0])
                cds.append(cepsdist(deg, ref, fs)[0])
            scores[label] = {
                "pesq": float(np.mean(pesqs)) if pesqs else None,
                "stoi": float(np.mean(stois)),
                "srmr": float(np.mean(srmrs)),
                "fwsegsnr": float(np.mean(fwsnrs)),
                "cepsdist": float(np.mean(cds)),
            }
            print(f"{label}: {scores[label]}")
        with open(os.path.join(exp, "se_scores.json"), "w") as f:
            json.dump(scores, f, indent=2)

    if in_range(4):
        print("=== stage 4: FDLP featgen on enhanced audio")
        from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram

        compute_fdlp_spectrogram.main(
            [os.path.join(exp, "enhanced.scp"), os.path.join(exp, "fdlp"),
             "--nfilters", "20", "--fduration", "1.5",
             "--overlap_fraction", "0.25", "--srate", str(fs),
             "--device", device]
        )

    if in_range(5):
        print("=== stage 5: e2e transformer ASR train + decode")
        from speech_recognition_tools_tpu_torch.cli import recog_e2e, train_e2e
        from speech_recognition_tools_tpu_torch.io.egs import build_egs
        from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp

        feats = dict(read_mat_scp(os.path.join(exp, "fdlp.scp")))
        keys = sorted(feats)
        train_keys = keys[: int(0.8 * len(keys))]
        test_keys = keys[int(0.8 * len(keys)):]
        build_egs(
            ((k, feats[k]) for k in train_keys), os.path.join(exp, "egs_tr")
        )
        build_egs(
            ((k, feats[k]) for k in test_keys), os.path.join(exp, "egs_et")
        )
        train_e2e.main(
            [os.path.join(exp, "egs_tr"), os.path.join(exp, "text"),
             os.path.join(exp, "e2e"), "--adim", "32", "--aheads", "2",
             "--elayers", "1", "--eunits", "32", "--dlayers", "1",
             "--dunits", "32", "--mtlalpha", "0.3", "--dropout", "0.0",
             "--epochs", str(args.e2e_epochs), "--batch_size", "4",
             "--warmup_steps", "100", "--average_last", "3",
             "--device", device]
        )
        recog_e2e.main(
            [os.path.join(exp, "e2e"), os.path.join(exp, "egs_et"),
             os.path.join(exp, "hyp.text"), "--beam_size", "4",
             "--ref_text", os.path.join(exp, "text"), "--device", device]
        )

    print("reverb_demo recipe done")


if __name__ == "__main__":
    main()
