#!/usr/bin/env python3
"""Generic config-driven corpus recipe: the runnable form of
recipes/configs/*.json, on the PyTorch/CUDA port.

Port of recipes/run_corpus.py, the native equivalent of the reference's
per-corpus shell drivers (e2e/wsj/run_fdlp_e1.sh:197-543 featgen ->
dict/json -> LM -> train -> decode -> score; recipes/timit/run_rnn.sh:62-86
hybrid featgen -> egs -> train -> decode), with the reference's
--stage/--stop_stage resume contract. One driver executes both branches;
the config's `am.type` selects hybrid (`rnn`, ...) vs e2e
(`transformer_asr`). It chains the port's CLIs in one process and runs on
the card unless `--device cpu` is given: every CLI that takes a device
gets it; the host-only steps (train_ngram, build_egs, decode_wfst
build-graph, compute_prior, the scoring) take none.

What it writes is what the JAX driver writes (serving.json and cmvn.npz,
RESULTS, stage_profile.json's keys, the egs layout, ali_*.pkl, the
flax-msgpack checkpoints), so that either package can resume the other's
expdir. Two differences: there is no compile cache to enable (the JAX
driver's XLA cache has no counterpart in torch eager), and the stage
profiler reads the card's allocator (torch.cuda.memory_stats, its peak
reset at each stage) and records no device memory on the CPU.

Data layout (Kaldi-style, like the reference's data dirs):
  <data>/<set>/wav.scp          utt -> wav path (or recording, with segments)
  <data>/<set>/text             utt -> transcription
  [<data>/<set>/segments]       segment-style scp (utt rec start end)
  [<data>/<set>/ali.pkl]        hybrid only: {utt: (T,) int frame labels}
                                (the Kaldi ali-to-pdf analogue). OPTIONAL:
                                when absent, stage 2 produces alignments
                                natively — flat-start + Viterbi
                                realignment over the lexicon
                                (align/forced.py; config `align` section:
                                states_per_phone/silence_phone/iters/
                                epochs/hidden_dim) -> <expdir>/ali_*.pkl
  [<data>/lexicon.txt]          hybrid WFST decode: word phone-id [...]

Stages (reference numbering):
  0  multichannel enhancement (config `enhancement` section): WPE ->
     mask/GEV beamforming on the device (enhance/pipeline.py; the
     run_wpe.sh -> run_beamform.sh chain of run_fdlp_e1.sh:130-138),
     then SE scoring vs <set>/clean_wav.scp when present
     (compute_se_scores.sh analogue). wav.scp values may carry several
     per-channel paths; single-channel utts pass through. A 'blstm'
     mask model is loaded from <expdir>/mask_model or trained from the
     train set's parallel clean_wav.scp/noise_wav.scp (nn-gev flow);
     otherwise quantile masks are used.
  1  feature extraction for every set (frontend section)
  2  data prep: char dict (e2e) + egs dirs (+ CMVN per egs section)
  3  LM training: RNNLM (e2e `lm` section) / n-gram (hybrid)
  4  AM training (am section)
  5  decode + score every test set -> <expdir>/RESULTS
  6  PM scores (hybrid `pm` section)

Usage:
  python -m speech_recognition_tools_tpu_torch.recipes.run_corpus \\
      --config recipes/configs/wsj_fdlp_e2e.json \\
      --data /path/to/wsj_data --expdir exp/wsj [--stage 1] \\
      [--set am.epochs=2] [--test_sets test_dev93,test_eval92] \\
      [--device cpu]
      [--check_data]  # preflight the layout, print the plan, no compute

`--set key.path=value` overrides any config entry (the parse_options.sh
duality). Multichannel configs (`enhancement` section) run the WPE/GEV
chain as stage 0 and feed the enhanced wavs into featgen automatically;
segments-mode data cannot be combined with enhancement (enhance the
recordings first). `am.data_parallel` / `am.expert_parallel` are passed
through to train_am, which refuses them until the parallel layer is
ported (ROADMAP Queue 1 item 5).
"""

import argparse
import gc
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

FEATGEN_CLIS = {
    "fdlp": "compute_fdlp_spectrogram",
    "melspec": "compute_mel_spectrum",
    "mfcc": "compute_mfcc",
    "modspec": "compute_modulation_spectrum",
}


def parse_override(s):
    """'a.b.c=v' -> (['a','b','c'], typed v)."""
    path, _, raw = s.partition("=")
    if raw in ("true", "false"):
        v = raw == "true"
    elif raw in ("null", "None"):
        v = None
    else:
        try:
            v = int(raw)
        except ValueError:
            try:
                v = float(raw)
            except ValueError:
                v = raw
    return path.split("."), v


def apply_override(cfg, path, value):
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def frontend_argv(fe, scp, out, data_set_dir):
    """Map the config's frontend section to the featgen CLI argv."""
    typ = fe.get("type", "fdlp")
    argv = [scp, out]
    flag_names = {
        "fdlp": ("srate", "nfilters", "fduration", "order", "coeff_num",
                 "coeff_range", "overlap_fraction", "fbank_type", "frate",
                 "odd_mod_zero", "gamma_weight", "lifter_config",
                 "precision", "batch_size", "bucket_seconds"),
        "melspec": ("srate", "nfilters", "fduration", "frate", "nfft",
                    "spectrum_type", "fbank_type"),
        "mfcc": ("srate", "nfilters", "fduration", "frate", "nfft",
                 "context"),
        "modspec": ("srate", "nfilters", "fduration", "frate", "order",
                    "coeff_0", "coeff_n", "fbank_type", "keep_even",
                    "complex_modulation", "compensate_noise",
                    "absolute_value", "set_unity_gain", "no_window"),
    }[typ]
    for k in flag_names:
        if k in fe:
            v = fe[k]
            if isinstance(v, bool):
                if v:
                    argv.append(f"--{k}")
            else:
                argv += [f"--{k}", str(v)]
    seg = os.path.join(data_set_dir, "segments")
    if os.path.exists(seg):
        argv = [seg] + argv[1:] + [
            "--scp_type", "segment", "--wav_scp", scp,
        ]
    return typ, argv


def run_featgen(typ, argv, device="cuda"):
    """Run the port's featgen CLI of front-end `typ` on `device`."""
    import importlib

    mod = importlib.import_module(
        "speech_recognition_tools_tpu_torch.cli." + FEATGEN_CLIS[typ]
    )
    mod.main(argv + ["--device", str(device)])


def load_ali(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class StageProfiler:
    """--profile_stages: per-stage wall-clock + device-memory + artifact
    sizes -> <expdir>/stage_profile.json, in the JAX driver's layout. On
    the card each stage starts after a garbage collection with the
    allocator's peak reset, so that its peak_bytes_in_use is its own; on
    the CPU no device memory is recorded ({})."""

    def __init__(self, enabled, expdir, device=torch.device("cpu")):
        self.enabled, self.expdir = enabled, expdir
        self.device = torch.device(device)
        self.stages, self._cur, self._t = [], None, None

    def _device_mem(self):
        if self.device.type != "cuda":
            return {}
        ms = torch.cuda.memory_stats(self.device)
        return {
            "bytes_in_use": int(ms["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(ms["allocated_bytes.all.peak"]),
            "bytes_limit": int(
                torch.cuda.get_device_properties(self.device).total_memory
            ),
        }

    def _close(self):
        if self._cur is not None:
            self.stages.append({
                "stage": self._cur,
                "seconds": round(time.time() - self._t, 2),
                "device_memory": self._device_mem(),
            })
            self._cur = None

    def mark(self, label):
        if not self.enabled:
            return
        self._close()
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._cur, self._t = label, time.time()

    def finish(self):
        if not self.enabled:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._close()
        sizes = {}
        for entry in sorted(os.listdir(self.expdir)):
            p = os.path.join(self.expdir, entry)
            if os.path.isdir(p):
                total = 0
                for root, _, files in os.walk(p):
                    total += sum(
                        os.path.getsize(os.path.join(root, f))
                        for f in files
                    )
                sizes[entry + "/"] = total
            else:
                sizes[entry] = os.path.getsize(p)
        out = os.path.join(self.expdir, "stage_profile.json")
        with open(out, "w") as f:
            json.dump(
                {"stages": self.stages, "artifact_bytes": sizes}, f, indent=2
            )
        for s in self.stages:
            mem = s["device_memory"].get("peak_bytes_in_use")
            print(f"[profile] {s['stage']}: {s['seconds']:.1f}s"
                  + (f"  peak_hbm={mem / 1e9:.2f}GB" if mem else ""))
        print(f"[profile] stage profile -> {out}")


def write_serving_manifest(cfg, model_dir, train_egs_dir):
    """Record the serving handoff next to the trained checkpoints.

    Writes `<model_dir>/serving.json` (frontend geometry + CMVN mode) and,
    for global CMVN, `<model_dir>/cmvn.npz` (the exact stats baked into the
    train egs), so that `cli.serve MODEL_DIR` /
    `OnlineASRPipeline.from_model_dir` reproduce the training-time frontend
    with no manual flags. The same files as the JAX driver's.
    """
    from speech_recognition_tools_tpu_torch.io.egs import EgsConfig

    os.makedirs(model_dir, exist_ok=True)
    egs_cfg = cfg.get("egs", {})
    mode = egs_cfg.get("cmvn", "global")
    manifest = {
        "frontend": cfg.get("frontend", {}),
        "cmvn": None,
        "cmvn_mode": mode,
    }
    if mode == "global":
        with open(os.path.join(train_egs_dir, "egs.config")) as f:
            ecfg = EgsConfig.from_json(f.read())
        if ecfg.cmvn_mean is not None:
            np.savez(
                os.path.join(model_dir, "cmvn.npz"),
                mean=np.asarray(ecfg.cmvn_mean, np.float32),
                std=np.asarray(ecfg.cmvn_std, np.float32),
            )
            manifest["cmvn"] = "cmvn.npz"
    with open(os.path.join(model_dir, "serving.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def check_data(cfg, args, branch, sets, test_sets):
    """Preflight: validate the data-dir layout against the config and
    print the planned run WITHOUT any compute — so the day a corpus
    mounts, layout mistakes surface in seconds, not mid-run (the
    reference surfaces them as stage crashes deep into run_*.sh).
    Returns a (problems, notes) tuple; empty problems = ready."""
    from speech_recognition_tools_tpu_torch.io.scp import read_scp, read_segments
    from speech_recognition_tools_tpu_torch.io.text import read_text_file
    from speech_recognition_tools_tpu_torch.io.wav import read_wav_scp_entry

    problems, notes = [], []
    fe = cfg.get("frontend", {})
    srate = int(fe.get("srate", 16000))
    enh = cfg.get("enhancement")
    for name in dict.fromkeys(sets):
        d = os.path.join(args.data, name)
        if not os.path.isdir(d):
            problems.append(f"{name}: data set dir missing: {d}")
            continue
        wav = os.path.join(d, "wav.scp")
        if not os.path.exists(wav):
            problems.append(f"{name}: missing wav.scp")
            continue
        entries = read_scp(wav)
        if not entries:
            problems.append(f"{name}: wav.scp is empty")
            continue
        seg_path = os.path.join(d, "segments")
        has_seg = os.path.exists(seg_path)
        if has_seg and enh:
            problems.append(
                f"{name}: segments-mode data cannot be combined with an "
                "enhancement section (enhance the recordings first)"
            )
        text = os.path.join(d, "text")
        if not os.path.exists(text):
            problems.append(f"{name}: missing text")
        else:
            texts = read_text_file(text)
            ids = (
                {s[0] for s in read_segments(seg_path)} if has_seg
                else {k for k, _ in entries}
            )
            n_missing = len(ids - set(texts))
            if n_missing:
                problems.append(
                    f"{name}: {n_missing}/{len(ids)} utterances have no "
                    "transcription in text"
                )
        # spot-check the first wav: readable + sample rate matches the
        # frontend (a pipe entry runs its command once — still cheap)
        first = entries[0][1]
        try:
            if enh:
                from speech_recognition_tools_tpu_torch.enhance.pipeline import (
                    read_multichannel_scp,
                )

                chans = read_multichannel_scp(wav).get(entries[0][0], [])
                if not chans:
                    raise ValueError(
                        "first wav.scp entry has no channel paths"
                    )
                first = chans[0]
                if len(chans) == 1:
                    notes.append(
                        f"{name}: first utt is single-channel; stage 0 "
                        "will pass such utts through unenhanced"
                    )
            read_wav_scp_entry(first, expected_srate=srate)
        except Exception as e:  # the preflight reports, it does not crash
            problems.append(
                f"{name}: first wav entry unreadable at srate={srate}: {e}"
            )
        if name in test_sets and enh and enh.get("se_metrics"):
            if not os.path.exists(os.path.join(d, "clean_wav.scp")):
                notes.append(
                    f"{name}: no clean_wav.scp — SE scoring will be skipped"
                )
    lex = os.path.join(args.data, "lexicon.txt")
    if branch == "hybrid":
        # mirror stage 2's ACTUAL gate: the native-realignment branch
        # runs only when the TRAIN set lacks ali.pkl (and then aligns
        # both train and dev). Train-has/dev-lacks means dev egs get no
        # labels — dev loss/FER tracking (the LR schedule's signal)
        # would silently break, so flag it as a problem.
        train_ali = os.path.exists(
            os.path.join(args.data, args.train_set, "ali.pkl")
        )
        dev_ali = os.path.exists(
            os.path.join(args.data, args.dev_set, "ali.pkl")
        )
        if not train_ali and not os.path.exists(lex):
            problems.append(
                f"hybrid branch: no ali.pkl in {args.train_set} and no "
                f"{lex} for native forced alignment — provide one"
            )
        elif not train_ali:
            notes.append(
                "no external train ali.pkl: stage 2 will run native "
                "flat-start + Viterbi alignment (align/forced.py) over "
                "train and dev"
            )
        elif not dev_ali:
            problems.append(
                f"hybrid branch: {args.train_set} has ali.pkl but "
                f"{args.dev_set} does not — stage 2 only realigns when "
                "the train set lacks alignments, so dev egs would be "
                "built without labels (dev loss/FER tracking breaks); "
                "provide dev ali.pkl or remove the train one to realign "
                "both natively"
            )
        if not os.path.exists(lex):
            notes.append(
                "no lexicon.txt: stage 5 writes loglikes arks only "
                "(no native WFST decode or WER)"
            )
    return problems, notes


def get_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--config", required=True)
    p.add_argument("--data", required=True, help="corpus root (see docstring)")
    p.add_argument("--expdir", required=True)
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop_stage", type=int, default=99)
    p.add_argument("--train_set", default="train")
    p.add_argument("--dev_set", default="dev")
    p.add_argument("--test_sets", default=None,
                   help="comma list (default: config decode.sets or 'test')")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY.PATH=VALUE", help="config override")
    p.add_argument("--check_data", action="store_true",
                   help="validate the data-dir layout against the config "
                        "and print the planned stages, then exit without "
                        "running anything (rc 1 on problems)")
    p.add_argument("--profile_stages", action="store_true",
                   help="record per-stage wall-clock, device memory and "
                        "artifact sizes to <expdir>/stage_profile.json")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    with open(args.config) as f:
        cfg = json.load(f)
    for s in args.overrides:
        apply_override(cfg, *parse_override(s))

    am = cfg.get("am", {})
    branch = "e2e" if am.get("type") == "transformer_asr" else "hybrid"
    test_sets = (
        args.test_sets.split(",") if args.test_sets
        else [str(s) for s in cfg.get("decode", {}).get("sets", ["test"])]
    )
    sets = [args.train_set, args.dev_set] + test_sets

    if args.check_data:
        problems, notes = check_data(cfg, args, branch, sets, test_sets)
        enh = cfg.get("enhancement")
        planned = [s for s, on in [
            (0, bool(enh)), (1, True), (2, True),
            (3, branch == "hybrid" or bool(cfg.get("lm"))), (4, True),
            (5, True), (6, branch == "hybrid" and bool(cfg.get("pm"))),
        ] if on and args.stage <= s <= args.stop_stage]
        print(f"config: {args.config}  branch: {branch}  "
              f"frontend: {cfg.get('frontend', {}).get('type', 'fdlp')}"
              f"@{cfg.get('frontend', {}).get('srate', 16000)}Hz")
        print(f"sets: train={args.train_set} dev={args.dev_set} "
              f"test={','.join(test_sets)}  planned stages: {planned}")
        for n in notes:
            print(f"NOTE: {n}")
        for pr in problems:
            print(f"PROBLEM: {pr}")
        print("check_data: " + ("READY" if not problems
                                else f"{len(problems)} problem(s)"))
        if problems:
            sys.exit(1)
        return []

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
    prof = StageProfiler(args.profile_stages, exp, dev)

    def in_range(s):
        return args.stage <= s <= args.stop_stage

    def dset(name):
        d = os.path.join(args.data, name)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"data set dir missing: {d}")
        return d

    def feats_scp(name):
        return os.path.join(exp, f"feats_{name}.scp")

    def wav_scp(name):
        """The scp featgen should read: the stage-0 enhanced one when
        enhancement is configured. Fail loud if stage 0 never ran — the
        raw multichannel scp would feed featgen garbage (or silently
        skip enhancement for 1ch scps)."""
        enhanced = os.path.join(exp, f"enhanced_{name}", "wav.scp")
        if cfg.get("enhancement"):
            if os.path.exists(enhanced):
                return enhanced
            raise FileNotFoundError(
                f"enhancement is configured but {enhanced} does not exist "
                "— run stage 0 first (--stage 0)"
            )
        return os.path.join(dset(name), "wav.scp")

    enh = cfg.get("enhancement")
    if enh and in_range(0):
        print("=== stage 0: multichannel enhancement (WPE/GEV) + SE scores")
        prof.mark("0 enhancement")
        from speech_recognition_tools_tpu_torch.enhance.pipeline import (
            maybe_mask_model,
            run_enhancement,
            se_scores,
        )

        srate = int(cfg.get("frontend", {}).get("srate", 16000))
        for name in sets:
            if os.path.exists(os.path.join(dset(name), "segments")):
                raise ValueError(
                    f"{name}: segments-mode data cannot be combined with "
                    "an enhancement section — enhance the recordings "
                    "first, then point wav.scp at them"
                )
        mask_fn = maybe_mask_model(
            enh, exp, train_dir=dset(args.train_set), srate=srate,
            device=device,
        )
        for name in sets:
            run_enhancement(
                os.path.join(dset(name), "wav.scp"),
                os.path.join(exp, f"enhanced_{name}"),
                enh, srate, mask_fn=mask_fn, device=device,
            )
        del mask_fn  # the mask net stays on the card no longer than stage 0
        metrics = enh.get("se_metrics") or []
        if isinstance(metrics, str):  # --set enhancement.se_metrics=a,b
            metrics = metrics.split(",")
        for name in test_sets:
            clean = os.path.join(dset(name), "clean_wav.scp")
            if not (metrics and os.path.exists(clean)):
                continue
            scores = se_scores(
                os.path.join(exp, f"enhanced_{name}", "wav.scp"),
                clean, metrics, srate,
            )
            out = os.path.join(exp, f"se_scores_{name}.json")
            with open(out, "w") as f:
                json.dump(scores, f, indent=2)
            print(f"SE scores [{name}]: {scores} -> {out}")

    if in_range(1):
        print(f"=== stage 1: {cfg['frontend'].get('type', 'fdlp')} featgen")
        prof.mark("1 featgen")
        for name in sets:
            d = dset(name)
            typ, argv = frontend_argv(
                cfg["frontend"], wav_scp(name),
                os.path.join(exp, f"feats_{name}"), d,
            )
            run_featgen(typ, argv, device)

    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
    from speech_recognition_tools_tpu_torch.io.text import (
        build_char_vocab,
        read_text_file,
        save_vocab,
    )

    egs_cfg = cfg.get("egs", {})
    vocab_path = os.path.join(exp, "vocab.json")

    if in_range(2):
        print("=== stage 2: data prep (egs + dict)")
        prof.mark("2 data prep")
        if branch == "e2e":
            texts = read_text_file(os.path.join(dset(args.train_set), "text"))
            save_vocab(build_char_vocab(texts.values()), vocab_path)
        if branch == "hybrid" and not os.path.exists(
            os.path.join(dset(args.train_set), "ali.pkl")
        ):
            # no external alignments: native flat-start + Viterbi
            # realignment over the lexicon (align/forced.py) replaces the
            # reference's external Kaldi GMM pipeline
            # (run_get_hq_ali.sh -> ali-to-pdf)
            lex_path = os.path.join(args.data, "lexicon.txt")
            if not os.path.exists(lex_path):
                raise FileNotFoundError(
                    "hybrid branch without ali.pkl needs <data>/"
                    "lexicon.txt for native forced alignment"
                )
            from speech_recognition_tools_tpu_torch.align import (
                read_lexicon,
                realign_corpus,
            )

            acfg = cfg.get("align", {})
            spp = acfg.get(
                "states_per_phone",
                cfg.get("decode", {}).get("states_per_phone", 1),
            )
            lexicon = read_lexicon(lex_path)
            ali_sets = [
                n for n in (args.train_set, args.dev_set)
                if not os.path.exists(os.path.join(exp, f"ali_{n}.pkl"))
            ]
            if ali_sets:
                feats_all, texts_all, owner = {}, {}, {}
                for name in ali_sets:
                    fs = dict(read_mat_scp(feats_scp(name)))
                    ts = read_text_file(os.path.join(dset(name), "text"))
                    for k, v in fs.items():
                        feats_all[k] = v
                        owner[k] = name
                    texts_all.update(
                        {k: v for k, v in ts.items() if k in fs}
                    )
                print(f"native forced alignment over {len(feats_all)} "
                      f"utts (states_per_phone={spp})")
                ali_history = []
                labels, n_pdfs = realign_corpus(
                    feats_all, texts_all, lexicon,
                    states_per_phone=spp,
                    silence_phone=acfg.get("silence_phone"),
                    silence_states=acfg.get("silence_states"),
                    wpd_silence=acfg.get("wpd_silence", False),
                    num_iters=acfg.get("iters", 2),
                    am_epochs=acfg.get("epochs", 10),
                    hidden_dim=acfg.get("hidden_dim", 96),
                    history=ali_history,
                    device=device,
                )
                with open(os.path.join(exp, "align_history.json"),
                          "w") as f:
                    json.dump(ali_history, f, indent=2)
                per_set = {n: {} for n in ali_sets}
                for k, v in labels.items():
                    per_set[owner[k]][k] = v
                for name in ali_sets:
                    with open(
                        os.path.join(exp, f"ali_{name}.pkl"), "wb"
                    ) as f:
                        pickle.dump(per_set[name], f)
                if am.get("num_classes") is None:
                    am["num_classes"] = n_pdfs
        cmvn = None
        if egs_cfg.get("cmvn", "global") == "global":
            tr = dict(read_mat_scp(feats_scp(args.train_set)))
            allf = np.concatenate(list(tr.values()), axis=0)
            std = np.std(allf, axis=0)
            # constant dims (degenerate/tiny corpora) must not divide by 0
            cmvn = (np.mean(allf, axis=0), np.where(std == 0, 1.0, std))
        left = egs_cfg.get("left_context")
        right = egs_cfg.get("right_context")
        if left is not None and right is not None and left != right:
            raise ValueError(
                f"asymmetric splice context (left {left} / right {right}) "
                "is not supported by build_egs; use equal values"
            )
        context = left if left is not None else egs_cfg.get("context")
        if branch == "hybrid" and am.get("num_classes") is None:
            # fix ONE target count across sets up front: on a --stage
            # resume the freshly-aligned n_pdfs is gone, and inferring
            # 1+max(labels) per set diverges when a small dev set lacks
            # the highest pdf id
            maxes = []
            for name in sets:
                ali = os.path.join(dset(name), "ali.pkl")
                if not os.path.exists(ali):
                    ali = os.path.join(exp, f"ali_{name}.pkl")
                if os.path.exists(ali):
                    maxes.append(max(
                        int(np.max(np.asarray(v)))
                        for v in load_ali(ali).values()
                    ))
            if maxes:
                am["num_classes"] = 1 + max(maxes)
        for name in sets:
            feats = dict(read_mat_scp(feats_scp(name)))
            # fail loud on non-finite features: one inf frame would
            # poison global CMVN and every training step downstream
            bad = [k for k, v in feats.items()
                   if not np.isfinite(v).all()]
            if bad:
                raise ValueError(
                    f"{name}: {len(bad)}/{len(feats)} utterances have "
                    f"non-finite feature values (first: {bad[:3]}) — "
                    "featgen bug or corrupted ark; re-run stage 1"
                )
            if egs_cfg.get("cmvn") == "per_utt":
                feats = {
                    k: (v - v.mean(0)) / np.where(v.std(0) == 0, 1.0, v.std(0))
                    for k, v in feats.items()
                }
            labels = None
            num_targets = am.get("num_classes")
            ali = os.path.join(dset(name), "ali.pkl")
            if not os.path.exists(ali):
                ali = os.path.join(exp, f"ali_{name}.pkl")
            if branch == "hybrid" and os.path.exists(ali):
                labels = {
                    k: np.asarray(v, np.int32)
                    for k, v in load_ali(ali).items()
                }
                if num_targets is None:
                    num_targets = 1 + max(
                        int(np.max(v)) for v in labels.values()
                    )
            build_egs(
                iter(feats.items()), os.path.join(exp, f"egs_{name}"),
                labels=labels, cmvn=cmvn, context=context,
                max_seq_len=egs_cfg.get("max_seq_len"),
                num_targets=num_targets,
            )

    if in_range(3):
        print("=== stage 3: LM")
        prof.mark("3 LM")
        train_text = os.path.join(dset(args.train_set), "text")
        if branch == "e2e" and cfg.get("lm"):
            from speech_recognition_tools_tpu_torch.cli import train_lm

            lm = cfg["lm"]
            train_lm.main([
                train_text, os.path.join(exp, "lm"),
                "--vocab", vocab_path,
                "--layers", str(lm.get("layers", 1)),
                "--hidden", str(lm.get("units", 1000)),
                "--epochs", str(lm.get("epochs", 20)),
                "--batch_size", str(lm.get("batch_size", 64)),
                "--device", device,
            ])
        elif branch == "hybrid":
            from speech_recognition_tools_tpu_torch.cli import train_ngram

            train_ngram.main([
                train_text, os.path.join(exp, "ngram"),
                "--order", str(cfg.get("lm", {}).get("order", 3)),
            ])

    if in_range(4):
        print(f"=== stage 4: {branch} AM training")
        prof.mark("4 AM training")
        if branch == "e2e":
            from speech_recognition_tools_tpu_torch.cli import train_e2e

            argv = [
                os.path.join(exp, f"egs_{args.train_set}"),
                os.path.join(dset(args.train_set), "text"),
                os.path.join(exp, "am"),
                "--dev_egs_dir", os.path.join(exp, f"egs_{args.dev_set}"),
                "--vocab", vocab_path,
            ]
            for k in ("adim", "aheads", "elayers", "eunits", "dlayers",
                      "dunits", "mtlalpha", "lsm_weight", "dropout",
                      "warmup_steps", "transformer_lr", "grad_clip",
                      "epochs", "batch_size", "average_last",
                      "encoder_type", "conv_kernel", "compute_dtype",
                      "bucket_frames", "attn_chunk", "attn_left_chunks"):
                if k in am:
                    argv += [f"--{k}", str(am[k])]
            if am.get("specaug"):
                argv.append("--specaug")
            train_e2e.main(argv + ["--device", device])
            write_serving_manifest(
                cfg, os.path.join(exp, "am"),
                os.path.join(exp, f"egs_{args.train_set}"),
            )
        else:
            from speech_recognition_tools_tpu_torch.cli import train_am

            argv = [
                os.path.join(exp, f"egs_{args.train_set}"),
                os.path.join(exp, "am"),
                "--arch", am.get("type", "rnn"),
                "--dev_egs_dir", os.path.join(exp, f"egs_{args.dev_set}"),
            ]
            flags = {
                "num_layers": "num_layers", "hidden_dim": "hidden_dim",
                "num_classes": "num_classes", "optimizer": "optimizer",
                "learning_rate": "learning_rate", "lrr": "lrr",
                "lr_tol": "lr_tol", "clip_thresh": "clip_thresh",
                "epochs": "epochs", "batch_size": "batch_size",
                "dropout": "dropout", "comp_num": "comp_num",
                "bn_dim": "bn_dim", "num_layers_dec": "num_layers_dec",
                "expert_parallel": "expert_parallel",
            }
            for ck, fk in flags.items():
                if ck in am:
                    argv += [f"--{fk}", str(am[ck])]
            if am.get("data_parallel"):
                argv.append("--data_parallel")
            train_am.main(argv + ["--device", device])

    results = []
    if in_range(5):
        print("=== stage 5: decode + score")
        prof.mark("5 decode")
        from speech_recognition_tools_tpu_torch.eval.wer import score_hypotheses

        dec = cfg.get("decode", {})
        if branch == "e2e":
            from speech_recognition_tools_tpu_torch.cli import recog_e2e

            for name in test_sets:
                hyp = os.path.join(exp, f"hyp_{name}.txt")
                argv = [
                    os.path.join(exp, "am"),
                    os.path.join(exp, f"egs_{name}"), hyp,
                    "--beam_size", str(dec.get("beam_size", 10)),
                    "--ctc_weight", str(dec.get("ctc_weight", 0.3)),
                    "--penalty", str(dec.get("penalty", 0.0)),
                    "--max_len", str(dec.get("max_len", 200)),
                ]
                # the batched beam search by default, as the JAX driver's
                # jitted one (decode.jit: false restores the one-utterance
                # host search)
                if dec.get("jit", True):
                    argv += [
                        "--jit_decode",
                        "--batch_size", str(dec.get("batch_size", 8)),
                        "--bucket_frames",
                        str(dec.get("bucket_frames", 32)),
                    ]
                if cfg.get("lm") and os.path.isdir(os.path.join(exp, "lm")):
                    argv += ["--lm_dir", os.path.join(exp, "lm"),
                             "--lm_weight", str(dec.get("lm_weight", 1.0))]
                recog_e2e.main(argv + ["--device", device])
                refs = read_text_file(os.path.join(dset(name), "text"))
                hyps = read_text_file(hyp)
                wer, _ = score_hypotheses(
                    {k: v.split() for k, v in refs.items()},
                    {k: hyps.get(k, "").split() for k in refs},
                )
                results.append((name, wer))
        else:
            import glob

            from speech_recognition_tools_tpu_torch.cli import (
                compute_prior,
                decode_wfst,
                dump_outputs,
            )

            num_classes = am.get("num_classes")
            if num_classes is None:
                from speech_recognition_tools_tpu_torch.io.egs import EgsConfig

                with open(os.path.join(
                    exp, f"egs_{args.train_set}", "egs.config"
                )) as f:
                    num_classes = EgsConfig.from_json(f.read()).num_targets
            compute_prior.main([
                os.path.join(exp, f"egs_{args.train_set}"),
                os.path.join(exp, "prior.pkl"),
                "--num_classes", str(num_classes),
            ])
            lex = os.path.join(args.data, "lexicon.txt")
            graph = os.path.join(exp, "graph")
            if os.path.exists(lex):
                arpa = glob.glob(os.path.join(exp, "ngram", "*.arpa*"))[0]
                argv = [
                    "build-graph", arpa, lex, graph,
                    "--states_per_phone",
                    str(dec.get("states_per_phone", 1)),
                ]
                # graph topology must match the aligner's pdf numbering
                # when labels came from native realignment (HmmTopology
                # is shared between align/forced.py and decode/graph.py)
                acfg5 = cfg.get("align", {})
                if acfg5.get("silence_phone") is not None:
                    argv += ["--silence_phone",
                             str(acfg5["silence_phone"])]
                if acfg5.get("silence_states"):
                    argv += ["--silence_states",
                             str(acfg5["silence_states"])]
                if acfg5.get("wpd_silence"):
                    argv.append("--wpd_silence")
                decode_wfst.main(argv)
            for name in test_sets:
                ll = os.path.join(exp, f"loglikes_{name}")
                dump_outputs.main([
                    os.path.join(exp, "am"),
                    os.path.join(exp, f"egs_{name}"), ll,
                    "--prior", os.path.join(exp, "prior.pkl"),
                    "--prior_weight", str(dec.get("prior_weight", 0.8)),
                    "--device", device,
                ])
                if not os.path.exists(lex):
                    print(f"no {lex}: skipping WFST decode of {name} "
                          "(loglikes ark written for the external-FST "
                          "bridge, decode/export.py)")
                    continue
                hyp = os.path.join(exp, f"hyp_{name}.txt")
                argv = [
                    "decode", graph, ll + ".ark", hyp,
                    "--acoustic_scale", str(dec.get("acoustic_scale", 0.1)),
                    "--beam", str(dec.get("beam", 16.0)),
                ]
                if dec.get("lattice_beam"):
                    argv += [
                        "--lattice_dir", os.path.join(exp, f"lats_{name}"),
                        "--lattice_beam", str(dec["lattice_beam"]),
                    ]
                decode_wfst.main(argv + ["--device", device])
                refs = read_text_file(os.path.join(dset(name), "text"))
                hyps = read_text_file(hyp)
                wer, _ = score_hypotheses(
                    {k: v.split() for k, v in refs.items()},
                    {k: hyps.get(k, "").split() for k in refs},
                )
                results.append((name, wer))
        if results:
            with open(os.path.join(exp, "RESULTS"), "a") as f:
                for name, wer in results:
                    line = f"%WER {wer:.2f} [{name}] config={args.config}"
                    print(line)
                    f.write(line + "\n")

    if in_range(6) and branch == "hybrid" and cfg.get("pm"):
        print("=== stage 6: PM model + scores")
        prof.mark("6 PM")
        from speech_recognition_tools_tpu_torch.cli import pm_score_cli, train_am

        pm = cfg["pm"]
        name = test_sets[0]
        ll_scp = os.path.join(exp, f"loglikes_{name}.scp")
        lls = dict(read_mat_scp(ll_scp))
        build_egs(iter(lls.items()), os.path.join(exp, "pm_egs"))
        train_am.main([
            os.path.join(exp, "pm_egs"), os.path.join(exp, "pm"),
            "--arch", pm.get("type", "pm_ae"),
            "--num_layers", str(pm.get("num_layers_enc", 2)),
            "--num_layers_dec", str(pm.get("num_layers_dec", 2)),
            "--hidden_dim", str(pm.get("hidden_dim", 512)),
            "--bn_dim", str(pm.get("bn_dim", 64)),
            "--epochs", str(pm.get("epochs", 5)),
            "--loss", "mse",
            "--device", device,
        ])
        pm_score_cli.main([
            "pm", os.path.join(exp, "am"), os.path.join(exp, "pm"),
            os.path.join(exp, f"egs_{name}"),
            os.path.join(exp, "pm.score"),
            "--device", device,
        ])
        print(f"PM scores -> {os.path.join(exp, 'pm.score')}")

    prof.finish()
    print("run_corpus done")
    return results


if __name__ == "__main__":
    main()
