"""Posterior / log-likelihood dumping CLI, `--arch rnn`.

Port of speech_recognition_tools_tpu/cli/dump_outputs.py with its flags
(replacing the reference's extract_posterior.py,
dump_genclassifier_outputs.py and compute_log_prior.py): load a
self-describing checkpoint (train_am's, from either package), run an egs
directory's features through the model on the card, and write posteriors
or prior-normalised log-likelihoods, log p(c|x) - prior_weight * log p(c),
to a Kaldi ark/scp pair (the hybrid-decode edge, decode_dnn.sh stage 0).
It runs on the card unless `--device cpu` is given.

    python -m speech_recognition_tools_tpu_torch.cli.dump_outputs exp/am egs/ out/ll \\
        --prior exp/am/prior.pkl --prior_weight 0.8 [--device cpu]

Only checkpoints of `--arch rnn` (the masked GRU RNNClassifier) are
ported; other archs, `--multi_egs_dirs` and the frozen-encoder archs
(vae_encoded, curl_encoded) raise NotImplementedError. The rnn arch has no
embedding taps, so `--layer > 0` raises IndexError, as in the JAX CLI.
"""

import argparse
import pickle

_UNPORTED = "(ROADMAP Queue 1 item 3: the rest of the model zoo and its training CLIs)"


def get_parser():
    p = argparse.ArgumentParser("Dump model outputs for decoding")
    p.add_argument("model_dir", help="checkpoint directory (train_am output)")
    p.add_argument("egs_dir", help="egs dir with the features to decode")
    p.add_argument("save_file", help="output ark base name")
    p.add_argument("--prior", help="pickled log-prior file")
    p.add_argument("--prior_weight", type=float, default=0.8)
    p.add_argument("--add_softmax", action="store_true")
    p.add_argument("--layer", type=int, default=0,
                   help="0=logits, k>0 = k-th embedding layer from the end")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--multi_egs_dirs", help="(multimod models) not yet ported")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def load_model_from_checkpoint(model_dir, device="cuda"):
    """Rebuild a train_am model from its checkpoint alone (the reference
    extract_posterior.py:30-36 contract): the newest checkpoint under
    `model_dir`, or `model_dir` itself, with its parameters loaded, in eval
    mode on `device`. Returns (model, checkpoint path, config)."""
    import argparse as _ap

    from speech_recognition_tools_tpu_torch.cli.train_am import PORTED_ARCHS, build_model
    from speech_recognition_tools_tpu_torch.io.jax_params import rnn_classifier_from_jax
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    path = latest_checkpoint(model_dir) or model_dir
    payload, cfg = load_checkpoint(path)
    if cfg.get("arch") not in PORTED_ARCHS:
        raise NotImplementedError(f"dump_outputs for --arch {cfg.get('arch')} is not yet "
                                  f"ported {_UNPORTED}")
    args = _ap.Namespace(**{k: cfg.get(k) for k in cfg})
    model = build_model(args, cfg["feature_dim"], cfg.get("num_classes"), device=device)
    model.load_state_dict(rnn_classifier_from_jax(payload["params"]))
    return model.eval(), path, cfg


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.multi_egs_dirs:
        raise NotImplementedError(f"--multi_egs_dirs is not yet ported {_UNPORTED}")

    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.infer.posteriors import genclassifier_outputs
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp

    dev = resolve_device(args.device)
    model, _, _ = load_model_from_checkpoint(args.model_dir, device=dev)
    log_prior = None
    if args.prior:
        with open(args.prior, "rb") as f:
            log_prior = pickle.load(f)

    if args.layer > 0:
        raise IndexError(f"--layer {args.layer}: the rnn arch has no embedding layers")
    out = {}
    with torch.no_grad():
        for batch in iter_egs_batches(args.egs_dir, args.batch_size):
            feats = torch.as_tensor(batch["feats"], device=dev)
            lengths = torch.as_tensor(batch["lengths"], device=dev)
            sel = genclassifier_outputs(model(feats, lengths), log_prior, args.prior_weight,
                                        add_softmax=args.add_softmax).cpu().numpy()
            for i, key in enumerate(batch["keys"]):
                out[key] = sel[i, : int(batch["lengths"][i])]
    write_ark_scp(out, args.save_file)
    print(f"wrote {len(out)} utterances -> {args.save_file}.ark")
    return out


if __name__ == "__main__":
    main()
