"""Test-time adaptation CLI (replaces the reference's nnet_adapt_*.py
family).

Port of speech_recognition_tools_tpu/cli/adapt_am.py with its flags: load
an AM checkpoint and a frozen PM autoencoder checkpoint (both train_am's,
from either package), adapt the AM on unlabeled test egs so that the PM's
reconstruction loss falls (infer/adapt.py), track the frame error rate on
labeled dev egs, and save the adapted AM as `<store_path>/adapted` in the
JAX package's checkpoint layout. It runs on the card unless `--device cpu`
is given.

    python -m speech_recognition_tools_tpu_torch.cli.adapt_am exp/am exp/pm \\
        test_egs/ exp/am_adapted --dev_egs_dir dev_egs/ [--cmvn_mean mean.pkl] \\
        [--time_shift 3 | --time_shifts 3,5,7 [--contrastive]] [--mm_weight 0.1] \\
        [--device cpu]

A feedforward AM runs on the features alone and gives (embeddings,
logits); every other AM runs on (features, lengths), and where its output
is a tuple the adaptation (like the JAX CLI) takes the second element.
The AM and the PM run without noise, as the JAX CLI applies them without
rngs: a model that samples raises MissingNoiseError. `--seed` seeds
torch's global generator.
"""

import argparse


def get_parser():
    p = argparse.ArgumentParser("Unsupervised test-time adaptation")
    p.add_argument("model_dir", help="AM checkpoint dir")
    p.add_argument("pm_dir", help="PM autoencoder checkpoint dir")
    p.add_argument("egs_dir", help="unlabeled test egs")
    p.add_argument("store_path", help="output dir for the adapted model")
    p.add_argument("--dev_egs_dir", help="labeled dev egs for FER tracking")
    p.add_argument("--cmvn_mean", help="pickled PM-input mean vector")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--time_shift", type=int, default=0)
    p.add_argument("--time_shifts", default="",
                   help="comma list for multishift/contrastive variants")
    p.add_argument("--loss", default="mse", choices=["mse", "l1"])
    p.add_argument("--l2_source", type=float, default=0.0)
    p.add_argument("--contrastive", action="store_true")
    p.add_argument("--supervised_weight", type=float, default=0.0)
    p.add_argument("--mm_weight", type=float, default=0.0,
                   help="M-measure weight (AEPC variant: loss = recon - mm_weight * M-measure)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns {"log": the per-epoch lines printed, "dev": the dev metrics
    before adaptation and after each epoch}."""
    args = get_parser().parse_args(argv)
    import pickle

    import numpy as np
    import torch

    from speech_recognition_tools_tpu_torch.cli.dump_outputs import load_model_from_checkpoint
    from speech_recognition_tools_tpu_torch.cli.pm_score_cli import _restore_pm
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.infer.adapt import AdaptConfig, adapt_model
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.jax_params import model_to_jax
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint
    from speech_recognition_tools_tpu_torch.train.losses import masked_frame_error

    torch.manual_seed(args.seed)
    dev = resolve_device(args.device)
    am, _, am_cfg = load_model_from_checkpoint(args.model_dir, dev)
    pm = _restore_pm(args.pm_dir, dev)
    if args.cmvn_mean:
        with open(args.cmvn_mean, "rb") as f:
            pm_mean = np.asarray(pickle.load(f))
    else:
        pm_mean = np.zeros(am_cfg.get("num_classes"), np.float32)

    def am_apply(model, feats, lengths):
        if am_cfg.get("arch") == "feedforward":
            return model(feats)
        return model(feats, lengths)

    def tensors(b, keys):
        return {k: torch.as_tensor(b[k], device=dev) for k in keys}

    def batches():
        for b in iter_egs_batches(args.egs_dir, args.batch_size, drop_labels=True):
            yield tensors(b, ("feats", "lengths"))

    lines, dev_metrics = [], []
    eval_fn = None
    if args.dev_egs_dir:
        @torch.no_grad()
        def eval_fn(model):
            fers = []
            for b in iter_egs_batches(args.dev_egs_dir, args.batch_size):
                t = tensors(b, ("feats", "lengths", "labels"))
                out = am_apply(model, t["feats"], t["lengths"])
                logits = out[1] if isinstance(out, tuple) else out
                fers.append(float(masked_frame_error(logits, t["labels"], t["lengths"])))
            dev_metrics.append({"fer": sum(fers) / max(len(fers), 1)})
            return dev_metrics[-1]

    def log_fn(msg):
        print(msg)
        lines.append(msg)

    shifts = tuple(int(x) for x in args.time_shifts.split(",") if x)
    cfg = AdaptConfig(
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        time_shift=args.time_shift, time_shifts=shifts, loss=args.loss,
        l2_source=args.l2_source, contrastive=args.contrastive,
        supervised_weight=args.supervised_weight, mm_weight=args.mm_weight,
    )
    adapt_model(am, pm, pm_mean, batches, cfg, epochs=args.epochs, eval_fn=eval_fn,
                log_fn=log_fn, am_apply=am_apply)
    save_checkpoint(args.store_path, "adapted", model_to_jax(am, am.state_dict()), dict(am_cfg))
    print(f"saved adapted model -> {args.store_path}/adapted")
    return {"log": lines, "dev": dev_metrics}


if __name__ == "__main__":
    main()
