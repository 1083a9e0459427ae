"""PM confidence-score CLI (replaces the reference's pm_score_*.py and
score_utterance_by_mmeasure.py): reconstruction or contrastive PM scores
from a frozen autoencoder over AM outputs, or the decoder-free m-measure
from posterior arks. Scores go to a pickle {utt: float}, as in the
reference.

Port of speech_recognition_tools_tpu/cli/pm_score_cli.py with its flags;
`pm` runs the AM and the PM on the card unless `--device cpu` is given:

    python -m speech_recognition_tools_tpu_torch.cli.pm_score_cli pm \\
        exp/am exp/pm egs/ pm.score [--contrastive] [--loss l1|mse] \\
        [--cmvn_mean mean.pkl] [--time_shifts 3,5,7] [--device cpu]
    python -m speech_recognition_tools_tpu_torch.cli.pm_score_cli mmeasure \\
        post.scp mm.score [--delta_list 5,15,...]

The PM is called without noise, as the JAX CLI applies it without a
"sample" rng: a PM that samples (a VAE trained without --only_ae) raises
MissingNoiseError where the JAX package raises flax's InvalidRngError.
"""

import argparse
import pickle


def get_parser():
    p = argparse.ArgumentParser("Per-utterance confidence scores")
    sub = p.add_subparsers(dest="mode", required=True)

    pm = sub.add_parser("pm", help="PM autoencoder scores over AM outputs")
    pm.add_argument("model_dir")
    pm.add_argument("pm_dir")
    pm.add_argument("egs_dir")
    pm.add_argument("out_file")
    pm.add_argument("--cmvn_mean")
    pm.add_argument("--time_shifts", default="3,5,7")
    pm.add_argument("--loss", default="l1", choices=["l1", "mse"])
    pm.add_argument("--contrastive", action="store_true")
    pm.add_argument("--batch_size", type=int, default=16)
    pm.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")

    mm = sub.add_parser("mmeasure", help="m-measure from posterior scp")
    mm.add_argument("post_scp")
    mm.add_argument("out_file")
    mm.add_argument("--delta_list", default="5,15,25,35,45,55,65,75")
    return p


def _restore(model_dir, device):
    """The AM (the JAX lifelong_decode._restore): its model, config."""
    from speech_recognition_tools_tpu_torch.cli.dump_outputs import load_model_from_checkpoint

    model, _, cfg = load_model_from_checkpoint(model_dir, device)
    return model, cfg


def _restore_pm(pm_dir, device):
    """The PM (the JAX adapt_am._restore_pm), whose input width is its
    config's feature_dim, the AM's output width."""
    from speech_recognition_tools_tpu_torch.cli.dump_outputs import load_model_from_checkpoint

    return load_model_from_checkpoint(pm_dir, device)[0]


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode == "mmeasure":
        from speech_recognition_tools_tpu_torch.infer.mmeasure import mmeasure_scores
        from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp

        deltas = tuple(int(x) for x in args.delta_list.split(","))
        scores = mmeasure_scores(read_mat_scp(args.post_scp), deltas)
        with open(args.out_file, "wb") as f:
            pickle.dump(scores, f)
        print(f"wrote {len(scores)} m-measure scores -> {args.out_file}")
        return scores

    import numpy as np
    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.infer.pm_score import (
        pm_score_contrastive,
        pm_score_reconstruction,
    )
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches

    dev = resolve_device(args.device)
    am, am_cfg = _restore(args.model_dir, dev)
    pm = _restore_pm(args.pm_dir, dev)
    pm_mean = np.zeros(am_cfg.get("num_classes"), np.float32)
    if args.cmvn_mean:
        with open(args.cmvn_mean, "rb") as f:
            pm_mean = np.asarray(pickle.load(f))
    mean = torch.as_tensor(pm_mean, device=dev)

    shifts = tuple(int(x) for x in args.time_shifts.split(","))
    scores = {}
    with torch.no_grad():
        for b in iter_egs_batches(args.egs_dir, args.batch_size, drop_labels=True):
            feats = torch.as_tensor(b["feats"], device=dev)
            lengths = torch.as_tensor(b["lengths"], device=dev)
            if am_cfg.get("arch") == "feedforward":
                _, logits = am(feats)
            else:
                logits = am(feats, lengths)
            seq = logits - mean.to(logits.dtype)
            if args.contrastive:
                s = pm_score_contrastive(pm, seq, lengths, shifts, args.loss)
            else:
                s = pm_score_reconstruction(pm, seq, lengths, args.loss)
            for i, key in enumerate(b["keys"]):
                scores[key] = float(s[i])
    with open(args.out_file, "wb") as f:
        pickle.dump(scores, f)
    print(f"wrote {len(scores)} PM scores -> {args.out_file}")
    return scores


if __name__ == "__main__":
    main()
