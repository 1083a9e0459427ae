"""Posterior / log-likelihood dumping CLI for the recurrent half of the zoo.

Port of speech_recognition_tools_tpu/cli/dump_outputs.py with its flags
(replacing the reference's extract_posterior.py,
dump_genclassifier_outputs.py, dump_multimod_outputs.py and
compute_log_prior.py): load a self-describing checkpoint (train_am's or
import_torch_ckpt's, from either package), run an egs directory's features
through the model on the card, and write posteriors, prior-normalised
log-likelihoods log p(c|x) - prior_weight * log p(c), or with `--layer k`
the k-th embedding tap from the end, to a Kaldi ark/scp pair (the
hybrid-decode edge, decode_dnn.sh stage 0). It runs on the card unless
`--device cpu` is given.

    python -m speech_recognition_tools_tpu_torch.cli.dump_outputs exp/am egs/ out/ll \\
        --prior exp/am/prior.pkl --prior_weight 0.8 [--device cpu]

Every arch of cli/train_am.py loads, and every family the importer
writes. CURL's output is the categorical-posterior-weighted mixture of its
stream classifiers' softmaxes, as log-probabilities floored at 1e-12; a
sampling arch draws its latent (modnet its gumbel uniforms) from a CPU
torch.Generator seeded 2 for every batch where the JAX CLI passes
jax.random.key(2) (arch_forward's own default: seeded 0, for key(0)), so
that the card and the CPU draw the same.

The conv half runs on each utterance's (1, D, T) image (cnn, cldnn: the
logits; vae_cnn, rs_vae: the per-frame latent means) or, for
vae_cnn_pool, modnet and modnet_sigmoid, on the centre-aligned patches of
the trained width around every frame with full context, one row per
patch (the pooled VAE's bottleneck means, the modnets' logits), the first
and last rows repeated out to the utterance's T frames. The JAX
dump_outputs runs only vae_cnn_pool of these; for the other six its
generic branch passes (feats, lengths) to models that take one image, and
raises (ROADMAP Queue 3). The
port's constructors take their input widths, so a model is shaped from
its config (and, for multimod, its streams' widths from the checkpoint)
instead of from a first batch, and the JAX arch_init (a shape-init
template) has no counterpart.
"""

import argparse
import pickle


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
    p.add_argument("--multi_egs_dirs",
                   help="(multimod models) comma-separated extra egs dirs, one per additional "
                        "stream")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _stream_sizes(params, comp_num):
    """multimod's per-stream input widths, read off its checkpoint."""
    if "params" in params:
        params = params["params"]
    return [int(params[f"subnet_{i}"]["GRUStack_0"]["gru_0"]["cell"]["ir"]["kernel"].shape[0])
            for i in range(comp_num)]


def load_model_from_checkpoint(model_dir, device="cuda"):
    """Rebuild a train_am model from its checkpoint alone (the reference
    extract_posterior.py:30-36 contract): the newest checkpoint under
    `model_dir`, or `model_dir` itself, with its parameters loaded, in eval
    mode on `device`. Returns (model, checkpoint path, config)."""
    import argparse as _ap

    from speech_recognition_tools_tpu_torch.cli.train_am import build_model
    from speech_recognition_tools_tpu_torch.io.jax_params import model_from_jax
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    path = latest_checkpoint(model_dir) or model_dir
    payload, cfg = load_checkpoint(path)
    args = _ap.Namespace(**{k: cfg.get(k) for k in cfg})
    kw = {}
    if cfg.get("arch") == "multimod":
        kw["stream_sizes"] = _stream_sizes(payload["params"], cfg.get("comp_num", 2))
    elif cfg.get("arch") in ("vae_encoded", "curl_encoded"):
        kw["latent_dim"] = load_checkpoint(latest_checkpoint(cfg["base_model"])
                                           or cfg["base_model"])[1]["bn_dim"]
    model = build_model(args, cfg["feature_dim"], cfg.get("num_classes"), device, **kw)
    model.load_state_dict(model_from_jax(model, payload["params"]))
    return model.eval(), path, cfg


def load_frozen_encoder(base_model_dir, target_arch, device="cuda"):
    """(encode_fn, latent width) over a frozen VAE/CURL checkpoint. The
    reference freezes the generative model by leaving it out of the
    optimizer; encode_fn runs without gradients, so the same closure serves
    training and dumping. vae_encoded takes the encoder means; curl_encoded
    the posterior-weighted mixture latent (compute_latent_features). The
    latent does not depend on the sample the full model would draw."""
    import torch

    from speech_recognition_tools_tpu_torch.models.curl import compute_latent_features

    base, _, base_cfg = load_model_from_checkpoint(base_model_dir, device)
    for p in base.parameters():
        p.requires_grad_(False)

    @torch.no_grad()
    def encode_fn(feats, lengths):
        if hasattr(base, "curl_encoder"):  # (cat, means, logvars)
            return compute_latent_features(base.curl_encoder(feats, lengths))
        enc = base.vae_encoder if hasattr(base, "vae_encoder") else base.encoder
        return enc(feats, lengths)[0]  # the VAE's means

    return encode_fn, base_cfg["bn_dim"]


def arch_forward(model, cfg, feats, lengths, generator=None, encode_fn=None):
    """(logits or posteriors, embedding taps) of any ported arch, as the
    JAX arch_forward dispatches (dump_genclassifier_outputs.py:100-106,
    dump_multimod_outputs.py, compute_CURL_classifier_likelihood.py)."""
    import torch

    from speech_recognition_tools_tpu_torch.cli.train_am import (
        IMAGE_ARCHS,
        PATCH_ARCHS,
        SAMPLING_ARCHS,
        image,
        patch_frames,
        split_streams,
    )

    arch = cfg.get("arch")
    if arch in SAMPLING_ARCHS and generator is None:
        generator = torch.Generator().manual_seed(0)
    if arch in IMAGE_ARCHS:
        x = image(feats)
        if arch == "cnn":
            return model(x), []
        if arch == "cldnn":
            return model(x, lengths), []
        return model(x, generator=generator)[1][0], []  # the latent means
    if arch in PATCH_ARCHS:
        return _patch_forward(model, arch, feats, patch_frames(argparse.Namespace(**cfg)),
                              generator), []
    if arch == "feedforward":
        embeds, logits = model(feats)
        return logits, embeds
    if arch in ("vae_encoded", "curl_encoded"):
        return model(encode_fn(feats, lengths), lengths), []
    if arch == "multimod":
        return model(split_streams(feats, cfg.get("comp_num", 2)), lengths), []
    if arch == "curl":
        class_out, _, latent = model(feats, lengths, generator=generator)
        post = torch.einsum("kbtc,btk->btc", torch.softmax(class_out, -1), latent[0])
        return torch.log(post.clamp_min(1e-12)), []
    out = (model(feats, lengths, generator=generator) if arch in SAMPLING_ARCHS
           else model(feats, lengths))
    return (out[0] if isinstance(out, tuple) else out), []


def _patch_forward(model, arch, feats, W, generator):
    """One row per frame from the patch archs (the JAX dump_outputs'
    vae_cnn_pool windowing): the centre-aligned W-frame patches of every
    start 0..T-W, encoded (the pooled VAE's means) or classified (the
    modnets' logits), then the first and last rows repeated out to T."""
    import torch.nn.functional as F

    from speech_recognition_tools_tpu_torch.cli.train_am import extract_patches

    B, T, _ = feats.shape
    if T < W:
        raise ValueError(f"utterance batch has {T} frames but the model was trained on "
                         f"{W}-frame patches")
    patches, _, _ = extract_patches(feats, None, feats.new_full((B,), T, dtype=int), W)
    if arch == "vae_cnn_pool":
        rows = model(patches, generator=generator)[1][0]
    elif arch == "modnet":
        rows = model(patches, generator=generator)[0]
    else:
        rows = model(patches)[0]
    P = T - W + 1
    rows = rows.reshape(B, P, -1).transpose(1, 2)  # (B, C, P): pad along frames
    half = W // 2
    return F.pad(rows, (half, T - P - half), mode="replicate").transpose(1, 2)


def main(argv=None):
    args = get_parser().parse_args(argv)

    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.infer.posteriors import genclassifier_outputs
    from speech_recognition_tools_tpu_torch.io.egs import (
        iter_egs_batches,
        iter_egs_batches_multi,
    )
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp

    dev = resolve_device(args.device)
    model, _, cfg = load_model_from_checkpoint(args.model_dir, device=dev)
    encode_fn = None
    if cfg.get("arch") in ("vae_encoded", "curl_encoded"):
        encode_fn, _ = load_frozen_encoder(cfg["base_model"], cfg["arch"], dev)
    if args.multi_egs_dirs:
        batches = iter_egs_batches_multi([args.egs_dir] + args.multi_egs_dirs.split(","),
                                         args.batch_size)
    else:
        batches = iter_egs_batches(args.egs_dir, args.batch_size)
    log_prior = None
    if args.prior:
        with open(args.prior, "rb") as f:
            log_prior = pickle.load(f)

    out = {}
    with torch.no_grad():
        for batch in batches:
            feats = batch["feats"]
            feats = ([torch.as_tensor(s, device=dev) for s in feats] if isinstance(feats, list)
                     else torch.as_tensor(feats, device=dev))
            lengths = torch.as_tensor(batch["lengths"], device=dev)
            logits, taps = arch_forward(
                model, cfg, feats, lengths,
                generator=torch.Generator().manual_seed(2), encode_fn=encode_fn)
            if args.layer > 0:
                sel = taps[-args.layer]
            else:
                sel = genclassifier_outputs(logits, log_prior, args.prior_weight,
                                            add_softmax=args.add_softmax)
            sel = sel.cpu().numpy()
            for i, key in enumerate(batch["keys"]):
                out[key] = sel[i, : int(batch["lengths"][i])]
    write_ark_scp(out, args.save_file)
    print(f"wrote {len(out)} utterances -> {args.save_file}.ark")
    return out


if __name__ == "__main__":
    main()
