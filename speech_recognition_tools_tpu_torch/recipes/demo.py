#!/usr/bin/env python3
"""Demo recipe: the full hybrid pipeline on synthetic data, with the
reference's staged-resume contract (--stage N / --stop_stage M), on the
PyTorch/CUDA port.

Port of recipes/demo/run.py. It runs on the card unless `--device cpu` is
given; every CLI that takes a device gets it, and stage 4's Viterbi
decode runs on tensors on the device (decode/viterbi.py).

Stages (mirroring recipes/timit/run_rnn.sh + run_pm.sh + decode_dnn.sh):
  0  data prep: synthesise word-structured wavs (each word = a phone
     sequence, each phone a distinct band-limited signature) + true
     frame alignments + text, write wav.scp
  1  FDLP featgen (CLI) -> feats ark
  2  egs build (+ global CMVN) with the true phone alignments
  3  hybrid GRU AM training (LR-revert schedule, resumable)
  4  priors + log-likelihood dump + native Viterbi decode -> FER
  5  PM autoencoder training + PM scores + test-time adaptation
  6  n-gram LM + decoding-graph build + native WFST decode -> WER

Run:  python -m speech_recognition_tools_tpu_torch.recipes.demo \\
          --expdir /tmp/demo --stage 0 [--device cpu]
"""

import argparse
import glob
import os
import pickle

import numpy as np
import torch

# toy linguistics: words -> phone sequences; each phone is an
# identifiable band-limited signature so the AM can genuinely learn
LEXICON = {"go": [0], "stop": [1, 2], "left": [3], "right": [4, 0]}
PHONE_DUR = 0.24  # seconds per phone


def phone_signal(ph, n, rs, srate):
    t = np.arange(n) / srate
    f0 = 300.0 + 400.0 * ph
    sig = np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(
        2 * np.pi * 2.1 * f0 * t
    )
    return sig + 0.05 * rs.randn(n)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--expdir", default="exp/demo")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop_stage", type=int, default=99)
    p.add_argument("--num_utts", type=int, default=8)
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--srate", type=int, default=16000)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    from speech_recognition_tools_tpu_torch.cli import (
        adapt_am,
        compute_fdlp_spectrogram,
        compute_prior,
        dump_outputs,
        pm_score_cli,
        train_am,
    )
    from speech_recognition_tools_tpu_torch.device import (
        configure_cuda,
        resolve_device,
    )
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        configure_cuda()
    device = str(dev)
    exp = args.expdir
    os.makedirs(exp, exist_ok=True)
    rs = np.random.RandomState(0)

    def in_range(s):
        return args.stage <= s <= args.stop_stage

    if in_range(0):
        print("=== stage 0: data prep")
        from scipy.io.wavfile import write as wav_write

        words_list = sorted(LEXICON)
        lines, texts = [], {}
        alis = {}
        nper = int(PHONE_DUR * args.srate)
        for i in range(args.num_utts):
            words = [
                words_list[j]
                for j in rs.randint(0, len(words_list), 2 + i % 3)
            ]
            phones = [p for w in words for p in LEXICON[w]]
            sig = np.concatenate(
                [phone_signal(p, nper, rs, args.srate) for p in phones]
            )
            sig = (sig / np.abs(sig).max() * 12000).astype(np.int16)
            path = os.path.join(exp, f"utt{i}.wav")
            wav_write(path, args.srate, sig)
            lines.append(f"utt{i} {path}")
            texts[f"utt{i}"] = " ".join(words)
            # true 100 Hz frame alignment
            frames_per_phone = int(round(PHONE_DUR * 100))
            alis[f"utt{i}"] = np.repeat(
                np.asarray(phones, np.int32), frames_per_phone
            )
        with open(os.path.join(exp, "wav.scp"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(exp, "text"), "w") as f:
            f.write(
                "".join(f"{k} {v}\n" for k, v in sorted(texts.items()))
            )
        with open(os.path.join(exp, "ali.pkl"), "wb") as f:
            pickle.dump(alis, f)
        with open(os.path.join(exp, "lexicon.txt"), "w") as f:
            f.write(
                "".join(
                    f"{w} {' '.join(str(p) for p in ps)}\n"
                    for w, ps in LEXICON.items()
                )
            )

    if in_range(1):
        print("=== stage 1: FDLP featgen")
        compute_fdlp_spectrogram.main(
            [os.path.join(exp, "wav.scp"), os.path.join(exp, "fdlp"),
             "--nfilters", "20", "--srate", str(args.srate),
             "--device", device]
        )

    if in_range(2):
        print("=== stage 2: egs")
        feats = dict(read_mat_scp(os.path.join(exp, "fdlp.scp")))
        with open(os.path.join(exp, "ali.pkl"), "rb") as f:
            alis = pickle.load(f)
        # clip/pad the true alignment to the featgen frame count
        labels = {}
        for k, v in feats.items():
            a = alis[k][: v.shape[0]]
            if len(a) < v.shape[0]:
                a = np.concatenate(
                    [a, np.full(v.shape[0] - len(a), a[-1], np.int32)]
                )
            labels[k] = a.astype(np.int32)
        with open(os.path.join(exp, "labels.pkl"), "wb") as f:
            pickle.dump(labels, f)
        mean = np.mean(np.concatenate(list(feats.values())), axis=0)
        std = np.std(np.concatenate(list(feats.values())), axis=0)
        build_egs(
            iter(feats.items()), os.path.join(exp, "egs"), labels=labels,
            cmvn=(mean, std), num_targets=args.num_classes,
        )

    if in_range(3):
        print("=== stage 3: hybrid AM training")
        train_am.main(
            [os.path.join(exp, "egs"), os.path.join(exp, "am"),
             "--arch", "rnn", "--num_layers", "1", "--hidden_dim", "64",
             "--epochs", "40", "--batch_size", "4", "--device", device]
        )

    if in_range(4):
        print("=== stage 4: priors + loglikes + decode")
        compute_prior.main(
            [os.path.join(exp, "egs"), os.path.join(exp, "prior.pkl"),
             "--num_classes", str(args.num_classes)]
        )
        dump_outputs.main(
            [os.path.join(exp, "am"), os.path.join(exp, "egs"),
             os.path.join(exp, "loglikes"),
             "--prior", os.path.join(exp, "prior.pkl"), "--device", device]
        )
        from speech_recognition_tools_tpu_torch.decode.viterbi import (
            viterbi_decode,
        )
        from speech_recognition_tools_tpu_torch.eval.wer import per_utt_fer

        lls = dict(read_mat_scp(os.path.join(exp, "loglikes.scp")))
        with open(os.path.join(exp, "labels.pkl"), "rb") as f:
            labels = pickle.load(f)
        S = args.num_classes
        trans = np.log(np.full((S, S), 0.1 / (S - 1)) + np.eye(S) * (0.9 - 0.1 / (S - 1)))
        fers = []
        for k, ll in lls.items():
            path, _ = viterbi_decode(
                torch.tensor(ll, device=dev)[None], trans
            )
            path = path[0].cpu().numpy()
            err = np.mean(path != labels[k][: ll.shape[0]]) * 100
            fers.append(err)
        print(f"viterbi FER: {np.mean(fers):.1f}%")
        fer = per_utt_fer(lls, labels)
        print(f"argmax FER (mean): {np.mean(list(fer.values())):.1f}%")

    if in_range(5):
        print("=== stage 5: PM + adaptation")
        lls = dict(read_mat_scp(os.path.join(exp, "loglikes.scp")))
        build_egs(iter(lls.items()), os.path.join(exp, "pm_egs"))
        train_am.main(
            [os.path.join(exp, "pm_egs"), os.path.join(exp, "pm"),
             "--arch", "pm_ae", "--num_layers", "1", "--num_layers_dec", "1",
             "--hidden_dim", "16", "--bn_dim", "8", "--epochs", "1",
             "--batch_size", "4", "--loss", "mse", "--device", device]
        )
        adapt_am.main(
            [os.path.join(exp, "am"), os.path.join(exp, "pm"),
             os.path.join(exp, "egs"), os.path.join(exp, "adapted"),
             "--epochs", "1", "--batch_size", "4",
             "--dev_egs_dir", os.path.join(exp, "egs"), "--device", device]
        )
        pm_score_cli.main(
            ["pm", os.path.join(exp, "am"), os.path.join(exp, "pm"),
             os.path.join(exp, "egs"), os.path.join(exp, "pm.score"),
             "--device", device]
        )
        with open(os.path.join(exp, "pm.score"), "rb") as f:
            scores = pickle.load(f)
        print(f"PM scores for {len(scores)} utts")

    if in_range(6):
        print("=== stage 6: n-gram + graph build + native WFST decode")
        from speech_recognition_tools_tpu_torch.cli import decode_wfst, train_ngram

        train_ngram.main(
            [os.path.join(exp, "text"), os.path.join(exp, "lm"),
             "--order", "2"]
        )
        arpa = glob.glob(os.path.join(exp, "lm", "*.arpa*"))[0]
        decode_wfst.main(
            ["build-graph", arpa, os.path.join(exp, "lexicon.txt"),
             os.path.join(exp, "graph"), "--states_per_phone", "1"]
        )
        decode_wfst.main(
            ["decode", os.path.join(exp, "graph"),
             os.path.join(exp, "loglikes.ark"),
             os.path.join(exp, "hyp.txt"),
             "--acoustic_scale", "0.5", "--beam", "24",
             "--ref_text", os.path.join(exp, "text"), "--device", device]
        )

    print("demo recipe done")


if __name__ == "__main__":
    main()
