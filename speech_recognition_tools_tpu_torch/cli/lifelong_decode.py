"""Lifelong / continual-learning decoding CLI (replaces the reference's
compute_*likelihood*.py family).

Port of speech_recognition_tools_tpu/cli/lifelong_decode.py with its
flags: load K classifier checkpoints p(c|x) and K VAE density checkpoints
p(x) (train_am's, from either package), fuse the classifiers' posteriors
over tasks (powerset, postpm, incremental, perframe or autoT;
infer/lifelong.py) weighted by data-driven (dp, mm, lowent) or fixed task
priors, divide by the class priors and write the fused log-likelihood ark
for decoding. The models run on the card unless `--device cpu` is given;
the fusion runs on the host in numpy.

    python -m speech_recognition_tools_tpu_torch.cli.lifelong_decode \\
        exp/am_a,exp/am_b exp/vae_a,exp/vae_b egs/ prior_a.pkl,prior_b.pkl dp out/ll \\
        [--fusion powerset|postpm|incremental|perframe|autoT] [--pm_on posteriors] \\
        [--device cpu]

The classifiers run through dump_outputs.arch_forward. A p(x) model that
samples draws its latent from a CPU torch.Generator seeded with `--seed`
for every batch (where the JAX CLI passes jax.random.key(0)), so that the
card and the CPU draw the same. As in the JAX CLI, a p(x) model's second
output is read as (means, logvars): a pm_ae's bottleneck (B, T, bn) is
indexed as such, its first utterance's rows taken as the means and its
second's (the first's again in a batch of one: jax clamps the index) as
the log-stds, for every utterance of the batch (ROADMAP Queue 3).
"""

import argparse
import pickle


def get_parser():
    p = argparse.ArgumentParser("Compute lifelong-decoding likelihoods")
    p.add_argument("models_pcx", help="comma-separated classifier ckpt dirs")
    p.add_argument("models_px", help="comma-separated VAE ckpt dirs")
    p.add_argument("egs_dir", help="features to decode")
    p.add_argument("priors", help="comma-separated pickled log-prior files")
    p.add_argument("task_prior", help="'dp' | 'mm' | 'lowent' | comma-separated floats")
    p.add_argument("save_file", help="output ark base")
    p.add_argument("--prior_weight", type=float, default=0.8)
    p.add_argument("--fusion", default="powerset",
                   choices=["powerset", "incremental", "perframe", "autoT", "postpm"])
    p.add_argument("--pm_on", default="feats", choices=["feats", "posteriors"],
                   help="input to the p(x) models: the features, or the classifier outputs "
                        "(the reference's postpm variants)")
    p.add_argument("--beta", type=float, default=None,
                   help="dp task-prior sharpening; defaults to the reference's per-mode "
                        "constant (300 powerset / 500 postpm and incremental)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="seed of the p(x) models' latent draws")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _latent_pair(latent):
    """(means, logvars) as the JAX CLI reads `latent[0]`, `latent[1]`: a
    tensor's leading index clamped to its size, as jax clamps it."""
    if isinstance(latent, (tuple, list)):
        return latent[0], latent[1]
    return latent[0], latent[min(1, latent.shape[0] - 1)]


def main(argv=None):
    args = get_parser().parse_args(argv)
    import numpy as np
    import torch

    from speech_recognition_tools_tpu_torch.cli.dump_outputs import (
        arch_forward,
        load_model_from_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.cli.train_am import SAMPLING_ARCHS
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.infer.lifelong import (
        autoT_fusion,
        framewise_vae_score,
        lifelong_fusion_incremental,
        lifelong_fusion_perframe,
        lifelong_fusion_powerset,
        task_priors,
    )
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp

    dev = resolve_device(args.device)
    pcx_dirs, px_dirs = args.models_pcx.split(","), args.models_px.split(",")
    assert len(pcx_dirs) == len(px_dirs), "need one p(x) model per p(c|x)"
    classifiers = [load_model_from_checkpoint(d, dev) for d in pcx_dirs]
    vaes = [load_model_from_checkpoint(d, dev) for d in px_dirs]
    log_priors = []
    for path in args.priors.split(","):
        with open(path, "rb") as f:
            log_priors.append(np.asarray(pickle.load(f)))
    fixed_tp = None
    if args.task_prior not in ("dp", "mm", "lowent"):
        fixed_tp = [float(x) for x in args.task_prior.split(",")]
    if args.beta is None:
        # the reference's exp(300 px) for powerset, exp(500 px) for
        # postpm and incremental (compute_advanced_likelihood.py:161,
        # _postpm.py:161)
        args.beta = 500.0 if args.fusion in ("postpm", "incremental") else 300.0

    out = {}
    with torch.no_grad():
        for batch in iter_egs_batches(args.egs_dir, args.batch_size, drop_labels=True):
            feats = torch.as_tensor(batch["feats"], device=dev)
            lengths = torch.as_tensor(batch["lengths"], device=dev)
            pcx_all, pxf_all = [], []
            for (cm, _, ccfg), (vm, _, vcfg) in zip(classifiers, vaes):
                logits, _ = arch_forward(cm, ccfg, feats, lengths)
                pcx_all.append(torch.softmax(logits, -1).cpu().numpy())
                pm_in = feats if args.pm_on == "feats" else logits
                if vcfg.get("arch") in SAMPLING_ARCHS:
                    res = vm(pm_in, lengths,
                             generator=torch.Generator().manual_seed(args.seed))
                else:
                    res = vm(pm_in, lengths)
                recon, latent = res
                means, logvars = _latent_pair(latent)
                pxf_all.append(framewise_vae_score(*(t.cpu().numpy() for t in (
                    pm_in, recon, means, logvars))))
            for i, key in enumerate(batch["keys"]):
                n = int(batch["lengths"][i])
                pcx = [p[i, :n] for p in pcx_all]
                pxf = [np.exp(f[i, :n]) for f in pxf_all]
                px_means = [float(np.mean(f)) for f in pxf]
                mode = args.task_prior if fixed_tp is None else "fixed"
                tp = task_priors(mode, px_means, posteriors=pcx, fixed=fixed_tp, beta=args.beta)
                if args.fusion in ("powerset", "postpm"):
                    out[key] = lifelong_fusion_powerset(pcx, log_priors, tp, args.prior_weight,
                                                        weighted_power=args.fusion == "postpm")
                elif args.fusion == "incremental":
                    out[key] = lifelong_fusion_incremental(pcx, log_priors, tp,
                                                           args.prior_weight)
                elif args.fusion == "perframe":
                    out[key] = lifelong_fusion_perframe(pcx, pxf, log_priors, args.prior_weight,
                                                        args.beta)
                else:
                    out[key], _ = autoT_fusion(pcx, log_priors, px_means, args.prior_weight)
    write_ark_scp(out, args.save_file)
    print(f"wrote {len(out)} fused utterances -> {args.save_file}.ark")
    return out


if __name__ == "__main__":
    main()
