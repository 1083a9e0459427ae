"""Import a reference PyTorch checkpoint into a native checkpoint.

Port of speech_recognition_tools_tpu/cli/import_torch_ckpt.py with every
flag, on the port's io/torch_import.py: the same checkpoint bytes and
config.json as the JAX CLI writes. Host code only; no card is needed.

    python -m speech_recognition_tools_tpu_torch.cli.import_torch_ckpt \\
        ref_model.model exp/imported_am [--tag final]

Migration path for users of the reference toolkit: its trainers save
self-describing torch dicts (train_rnn_nnet_classifier.py:273-288); this
CLI converts one into a native checkpoint directory that every inference /
adaptation / PM CLI here can consume (the model family is detected from the
state_dict structure — see io/torch_import.py for the supported families
and the exact weight mappings).
"""

import argparse


def get_parser():
    p = argparse.ArgumentParser("Import a reference torch .model checkpoint")
    p.add_argument("src", help="reference .model file (torch.save dict), "
                               "or an egs directory with --egs")
    p.add_argument("dest", help="native checkpoint / egs directory to create")
    p.add_argument("--tag", default=None,
                   help="checkpoint tag (subdirectory name; default "
                        "'final', or 'final_avg' for ESPnet e2e models "
                        "so recog_e2e finds them without --ckpt)")
    p.add_argument("--egs", action="store_true",
                   help="src is a reference egs directory (per-utt .pt + "
                        "lengths.pkl [+ labels.pkl]); convert the DATA "
                        "instead of a model")
    p.add_argument("--num_targets", type=int, default=None,
                   help="(--egs) class count override (default: max label "
                        "+ 1)")
    p.add_argument("--input_hw",
                   help="(pooled nnetVAECNN only) FEATURE_DIM,NUM_FRAMES "
                        "the model was trained with — its Linear heads "
                        "bake this geometry in but the .model dict does "
                        "not record it (train_CNN_VAE.py:115-140)")
    p.add_argument("--espnet_units",
                   help="(ESPnet e2e checkpoints) the char dict the model "
                        "was trained with ('token id' lines, data2json's "
                        "dict file); converts model.acc.best / snapshots "
                        "from the reference's e2e branch "
                        "(e2e/wsj/run.sh via espnet) into a native e2e "
                        "model dir for recog_e2e (add --attn_chunk to "
                        "also serve it online)")
    p.add_argument("--aheads", type=int, default=4,
                   help="(--espnet_units) attention head count — not "
                        "recoverable from the state_dict; read it from "
                        "the training conf (train.yaml aheads; the "
                        "reference's e2e configs use 4)")
    p.add_argument("--mtlalpha", type=float, default=0.3,
                   help="(--espnet_units) CTC weight recorded in the "
                        "imported config (train.yaml mtlalpha)")
    p.add_argument("--attn_chunk", type=int, default=0,
                   help="(ESPnet e2e) record a decode-time chunked-"
                        "attention geometry so srt-serve / recog_e2e "
                        "--streaming can run the imported model. ESPnet "
                        "models are trained full-context, so this is an "
                        "APPROXIMATION (offline recog then applies the "
                        "same chunk mask); omit for exact offline-only "
                        "decoding")
    p.add_argument("--attn_left_chunks", type=int, default=4,
                   help="(--attn_chunk) left-context chunks")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.egs:
        from speech_recognition_tools_tpu_torch.io.torch_import import (
            import_egs_dir,
        )

        out = import_egs_dir(args.src, args.dest,
                             num_targets=args.num_targets)
        print(f"imported egs {args.src} -> {out}")
        return
    from speech_recognition_tools_tpu_torch.io.torch_import import (
        detect_family,
        import_espnet_lm,
        import_espnet_model,
        import_state_dict,
        load_torch_checkpoint,
    )

    # one load + one detection; load_torch_checkpoint unwraps ESPnet
    # snapshot wrappers ({'model': sd}) and DataParallel prefixes, so
    # snapshots detect the same as model.acc.best files
    sd, hyper = load_torch_checkpoint(args.src)
    family = detect_family(sd)
    if family == "espnet_e2e":
        if not args.espnet_units:
            get_parser().error(
                "this is an ESPnet e2e transformer checkpoint (the "
                "reference's e2e branch); rerun with --espnet_units DICT "
                "[--aheads N]"
            )
        path = import_espnet_model(
            args.src, args.dest, args.espnet_units, args.aheads,
            mtlalpha=args.mtlalpha, tag=args.tag or "final_avg",
            attn_chunk=args.attn_chunk,
            attn_left_chunks=args.attn_left_chunks, sd=sd,
        )
        print("detected family: espnet_e2e")
        print(f"imported {args.src} -> {path}")
        return
    if family == "espnet_lm":
        path = import_espnet_lm(args.src, args.dest,
                                tag=args.tag or "final",
                                units=args.espnet_units, sd=sd)
        print("detected family: espnet_lm")
        print(f"imported {args.src} -> {path} "
              "(char LM: srt-recog-e2e --lm_dir; WORD LM "
              "(use_wordlm=true, large vocab): --word_lm_dir "
              "--word_lm_dict wordlist.txt)")
        return
    if args.input_hw:
        try:
            hw = tuple(int(v) for v in args.input_hw.split(","))
        except ValueError:
            hw = ()
        if len(hw) != 2:
            get_parser().error(
                f"--input_hw expects exactly FEATURE_DIM,NUM_FRAMES "
                f"(two comma-separated integers), got {args.input_hw!r}"
            )
        hyper["input_hw"] = hw
    path = import_state_dict(sd, hyper, args.dest,
                             tag=args.tag or "final", src=args.src)
    print(f"detected family: {family}")
    print(f"imported {args.src} -> {path}")


if __name__ == "__main__":
    main()
