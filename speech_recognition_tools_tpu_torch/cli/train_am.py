"""Acoustic-model training CLI, `--arch rnn`.

Port of speech_recognition_tools_tpu/cli/train_am.py with its flags: an egs
directory in (io/egs.py), self-describing checkpoints out
(train/checkpoint.py, the JAX package's layout and file format), the
LR-halve-and-revert schedule (train/trainer.py) and newest-checkpoint
resume. It runs on the card unless `--device cpu` is given.

    python -m speech_recognition_tools_tpu_torch.cli.train_am egs/ exp/am \
        --arch rnn --num_layers 3 --hidden_dim 512 [--device cpu]

Only the masked GRU `RNNClassifier` (`--arch rnn`) is ported. Every other
arch, `--data_parallel`, `--expert_parallel`, and the flags that serve only
other archs (`--expand_from`, `--base_model`, `--multi_egs_dirs`,
`--frame_egs`) raise NotImplementedError. As in the JAX CLI, the rnn loss
applies the classifier deterministically, so `--dropout` draws nothing.
"""

import argparse
import os

ARCHS = {
    "rnn": "RNNClassifier",
    "linear": "LinearConvStack",
    "feedforward": "FeedforwardClassifier",
    "multitask_ae": "AEClassifierMultitask",
    "vae": "VAE",
    "vae_classifier": "VAEClassifier",
    "arvae": "ARVAE",
    "curl": "CurlMultistreamClassifier",
    "curl_unsup": "CurlSupervised",
    "pm_ae": "AutoencoderRNN",
    "apc": "APC",
    "cnn": "CNNFrameClassifier",
    "cldnn": "CLDNN",
    "multimod": "MultistreamRNN",
    "multitask_aear": "AEClassifierMultitaskAEAR",
    "vae_cnn": "VAECNNNopool",
    "vae_cnn_pool": "VAECNN",
    "rs_vae": "VaeRsModulation",
    "modnet": "ModulationNet",
    "modnet_sigmoid": "ModulationSigmoidNet",
    "vae_encoded": "VAEEncodedClassifier",
    "curl_encoded": "CurlEncodedClassifier",
}
PORTED_ARCHS = ("rnn",)
_UNPORTED_FLAGS = {"data_parallel": "--data_parallel", "expand_from": "--expand_from",
                   "base_model": "--base_model", "multi_egs_dirs": "--multi_egs_dirs",
                   "frame_egs": "--frame_egs"}


def get_parser():
    p = argparse.ArgumentParser("Train an acoustic / generative model")
    p.add_argument("egs_dir", help="egs directory (io.egs.build_egs output)")
    p.add_argument("store_path", help="checkpoint directory")
    p.add_argument("--dev_egs_dir", help="dev egs dir (defaults to a tail of egs_dir)")
    p.add_argument("--arch", default="rnn", choices=sorted(ARCHS),
                   help="only 'rnn' is ported")
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--num_layers_dec", type=int, default=1)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--bn_dim", type=int, default=64)
    p.add_argument("--comp_num", type=int, default=2)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--optimizer", default="adam", help="only 'adam' is ported")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--lrr", type=float, default=0.5, help="LR reduction rate")
    p.add_argument("--lr_tol", type=float, default=0.0)
    p.add_argument("--clip_thresh", type=float, default=1.0)
    p.add_argument("--loss", default="ce", choices=["ce", "mse", "vae_gauss", "vae_laplace"])
    p.add_argument("--only_ae", action="store_true")
    p.add_argument("--use_transformer", action="store_true")
    p.add_argument("--time_shift", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true", help="not yet ported")
    p.add_argument("--expert_parallel", type=int, default=1, help="not yet ported")
    p.add_argument("--expand_from", help="(arch=curl) not yet ported")
    p.add_argument("--base_model", help="(vae_encoded/curl_encoded) not yet ported")
    p.add_argument("--multi_egs_dirs", help="(arch=multimod) not yet ported")
    p.add_argument("--frame_egs", action="store_true", help="(arch=feedforward) not yet ported")
    p.add_argument("--patch_width", type=int, default=21)
    p.add_argument("--freq_num", type=int, default=10)
    p.add_argument("--head_num", type=int, default=4)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def build_model(args, feat_dim, num_classes, device="cuda"):
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier

    if args.arch not in PORTED_ARCHS:
        raise NotImplementedError(f"--arch {args.arch} is not yet ported (rnn only)")
    return RNNClassifier(feat_dim, args.num_layers, args.hidden_dim, num_classes,
                         args.dropout, device=device)


def make_loss(args):
    """The loss of `--arch rnn`: (model, batch, train) -> (masked CE,
    {"fer": frame error rate})."""
    from speech_recognition_tools_tpu_torch.train.losses import (
        masked_cross_entropy,
        masked_frame_error,
    )

    if args.arch not in PORTED_ARCHS:
        raise NotImplementedError(f"--arch {args.arch} is not yet ported (rnn only)")

    def loss_fn(model, batch, train):
        # the JAX loss applies the model deterministically, train or not
        model.eval()
        feats, lengths = batch["feats"], batch["lengths"]
        logits = model(feats, lengths)
        return masked_cross_entropy(logits, batch["labels"], lengths), {
            "fer": masked_frame_error(logits, batch["labels"], lengths)
        }

    return loss_fn


def main(argv=None):
    args = get_parser().parse_args(argv)
    for attr, flag in _UNPORTED_FLAGS.items():
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not yet ported")
    if args.expert_parallel > 1:
        raise NotImplementedError("--expert_parallel is not yet ported")

    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches, load_egs
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        adam_state_from_jax,
        adam_state_to_jax,
        rnn_classifier_from_jax,
        rnn_classifier_to_jax,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    cfg_egs, utts = load_egs(args.egs_dir)
    if args.dev_egs_dir:
        dev_utts = load_egs(args.dev_egs_dir)[1]
    else:
        dev_utts = utts[-max(1, len(utts) // 10):]
    num_classes = args.num_classes or cfg_egs.num_targets
    model = build_model(args, cfg_egs.feat_dim, num_classes, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))

    def on_device(it):
        for b in it:
            yield {"feats": torch.as_tensor(b["feats"], device=dev),
                   "lengths": torch.as_tensor(b["lengths"], device=dev),
                   "labels": torch.as_tensor(b["labels"], device=dev)}

    def train_iter():
        return on_device(iter_egs_batches(utts, args.batch_size, shuffle_seed=args.seed))

    def dev_iter():
        return on_device(iter_egs_batches(dev_utts, args.batch_size))

    trainer = Trainer(
        model, make_loss(args),
        TrainConfig(
            optimizer=args.optimizer, learning_rate=args.learning_rate,
            epochs=args.epochs, lrr=args.lrr, lr_tol=args.lr_tol,
            clip_threshold=args.clip_thresh, seed=args.seed,
        ),
    )
    state = trainer.init_state()
    clip = bool(args.clip_thresh)

    def params_tree(st):
        return rnn_classifier_to_jax(st.params)

    def opt_tree(st):
        return adam_state_to_jax(st.opt_state, rnn_classifier_to_jax, clip=clip)

    # babysitter-style resume: newest checkpoint wins
    newest = latest_checkpoint(args.store_path)
    if newest:
        payload, meta = load_checkpoint(
            newest, template={"params": params_tree(state), "opt_state": opt_tree(state)})
        model.load_state_dict(rnn_classifier_from_jax(payload["params"]))
        opt = adam_state_from_jax(payload["opt_state"], rnn_classifier_from_jax, clip=clip)
        for m in ("mu", "nu"):
            opt[m] = {k: v.to(dev) for k, v in opt[m].items()}
        state.opt_state = opt
        state.best_params = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state.epoch = int(meta.get("extra", {}).get("epoch", 0))
        state.lr = float(meta.get("extra", {}).get("lr", args.learning_rate))
        print(f"resumed from {newest} at epoch {state.epoch}")

    hyper = dict(vars(args))
    hyper.update({"feature_dim": cfg_egs.feat_dim, "model_class": ARCHS[args.arch],
                  "num_classes": num_classes})

    def checkpoint_fn(st):
        save_checkpoint(
            args.store_path, f"epoch_{st.epoch}", params_tree(st), hyper,
            opt_state=opt_tree(st),
            extra={"epoch": st.epoch, "lr": st.lr, "history": st.history},
        )

    trainer.fit(state, train_iter, dev_iter, checkpoint_fn=checkpoint_fn)
    save_checkpoint(args.store_path, "final", rnn_classifier_to_jax(state.best_params), hyper,
                    extra={"history": state.history})
    print(f"saved final model to {os.path.join(args.store_path, 'final')}")
    return state


if __name__ == "__main__":
    main()
