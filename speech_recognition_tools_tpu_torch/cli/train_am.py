"""Acoustic-model training CLI: the recurrent half of the model zoo.

Port of speech_recognition_tools_tpu/cli/train_am.py with its flags: an egs
directory in (io/egs.py), self-describing checkpoints out
(train/checkpoint.py, the JAX package's layout and file format, params and
optimizer state in flax's tree), the LR-halve-and-revert schedule
(train/trainer.py) and newest-checkpoint resume. It runs on the card unless
`--device cpu` is given.

    python -m speech_recognition_tools_tpu_torch.cli.train_am egs/ exp/am \
        --arch pm_ae --num_layers 2 --num_layers_dec 2 --loss mse [--device cpu]

Every arch of the JAX CLI runs: rnn, linear, feedforward (`--frame_egs`
for frame-level egs), multitask_ae, multitask_aear (`--time_shift`),
multimod (`--multi_egs_dirs`), vae (`--only_ae`, `--use_transformer`,
`--loss vae_gauss|vae_laplace`), vae_classifier, arvae, vae_encoded and
curl_encoded (on a frozen `--base_model`), pm_ae, apc, curl
(`--expand_from`), curl_unsup, and the conv half: cnn and cldnn (over the
(1, D, T) image of each utterance), vae_cnn and rs_vae (the same image,
per-frame latents), vae_cnn_pool, modnet and modnet_sigmoid (on
`--patch_width`-frame patches around every frame with full context:
`extract_patches`). An importer's checkpoint gives its conv geometry in
the `cnn_in_channels`, `cnn_out_channels` and `cnn_kernel` keys. The
optimizers are adam, adadelta, sgd, adagrad and rmsprop (train/optim.py).

The parallel flags run in a torch.distributed world (parallel/launcher.py;
torchrun on cards, gloo with `--device cpu`), every rank running the same
command. `--data_parallel` shards each batch's rows over the 'data' axis
(a batch the axis does not divide stays whole on every rank), sums the
gradients over it and makes every loss's means global; `--expert_parallel
N` (arch curl) trains CurlMultistreamClassifierEP, whose comp_num experts
are split over a 'model' axis of N ranks, from the loop-layout model's
initial draws. Checkpoints hold the whole model (the EP layout under
model_class CurlMultistreamClassifierEP, as the JAX CLI writes it) and are
written by rank 0.

As in the JAX CLI every loss applies its model deterministically (no
dropout draws). The latent samples of vae, vae_classifier, arvae, curl,
curl_unsup, vae_cnn, vae_cnn_pool and rs_vae, and modnet's gumbel
uniforms, come from one CPU torch.Generator seeded with `--seed`, moved
to the training device, so that the card and the CPU draw the same (the
JAX trainer splits a key per step: its draws differ); curl_unsup's prior
means from a CPU generator seeded `--seed` + 99.
"""

import argparse
import os

import torch

from speech_recognition_tools_tpu_torch.parallel import collectives
from speech_recognition_tools_tpu_torch.parallel.launcher import is_main

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
SAMPLING_ARCHS = ("vae", "vae_classifier", "arvae", "curl", "curl_unsup", "vae_cnn",
                  "vae_cnn_pool", "rs_vae", "modnet")
# the conv archs that see each utterance as one (B, 1, D, T) image, and
# those that see --patch_width-frame patches
IMAGE_ARCHS = ("cnn", "cldnn", "vae_cnn", "rs_vae")
PATCH_ARCHS = ("vae_cnn_pool", "modnet", "modnet_sigmoid")


def get_parser():
    p = argparse.ArgumentParser("Train an acoustic / generative model")
    p.add_argument("egs_dir", help="egs directory (io.egs.build_egs output)")
    p.add_argument("store_path", help="checkpoint directory")
    p.add_argument("--dev_egs_dir", help="dev egs dir (defaults to a tail of egs_dir)")
    p.add_argument("--arch", default="rnn", choices=sorted(ARCHS))
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--num_layers_dec", type=int, default=1)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--bn_dim", type=int, default=64)
    p.add_argument("--comp_num", type=int, default=2)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--optimizer", default="adam",
                   help="adam, adadelta, sgd, adagrad or rmsprop")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--lrr", type=float, default=0.5, help="LR reduction rate")
    p.add_argument("--lr_tol", type=float, default=0.0)
    p.add_argument("--clip_thresh", type=float, default=1.0)
    p.add_argument("--loss", default="ce", choices=["ce", "mse", "vae_gauss", "vae_laplace"])
    p.add_argument("--only_ae", action="store_true")
    p.add_argument("--use_transformer", action="store_true")
    p.add_argument("--time_shift", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the batch axis over the world's 'data' axis")
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="(arch=curl) size of the 'model' axis the CURL experts split over "
                        "(CurlMultistreamClassifierEP)")
    p.add_argument("--expand_from",
                   help="(arch=curl) checkpoint dir of a trained CURL model to grow by one "
                        "component before training")
    p.add_argument("--base_model",
                   help="(vae_encoded/curl_encoded) checkpoint dir of the frozen generative "
                        "model whose latents feed the classifier")
    p.add_argument("--multi_egs_dirs",
                   help="(arch=multimod) comma-separated extra egs dirs, one per additional "
                        "feature stream; without it the feature dim is split into comp_num "
                        "contiguous streams")
    p.add_argument("--frame_egs", action="store_true",
                   help="(arch=feedforward) egs_dir holds frame-level shuffled egs "
                        "(io.egs.build_frame_egs)")
    p.add_argument("--patch_width", type=int, default=21,
                   help="(vae_cnn_pool, modnet archs) frames per input patch")
    p.add_argument("--freq_num", type=int, default=10,
                   help="(modnet archs) candidate modulation frequencies")
    p.add_argument("--head_num", type=int, default=4, help="(modnet) gumbel frequency-pick heads")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def build_model(args, feat_dim, num_classes, device="cuda", *, stream_sizes=None,
                latent_dim=None, mesh=None):
    """The port's model of `args.arch` on `device`, with flax's default
    draws from the global generator; on CUDA it switches TF32 off
    (device.configure_cuda). `stream_sizes`: multimod's per-stream
    input widths (default: feat_dim split into comp_num equal streams);
    `latent_dim`: the frozen base model's latent width (vae_encoded,
    curl_encoded); `mesh`: the mesh whose 'model' axis an expert-parallel
    CURL model's experts split over (None: every expert here)."""
    from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
    from speech_recognition_tools_tpu_torch.models import apc, curl, recurrent, vae

    dev = resolve_device(device)
    if dev.type == "cuda":
        configure_cuda()
    a, kw = args, dict(device=dev)
    if a.arch == "rnn":
        return recurrent.RNNClassifier(feat_dim, a.num_layers, a.hidden_dim, num_classes,
                                       a.dropout, device=dev)
    if a.arch == "linear":
        return recurrent.LinearConvStack(feat_dim, a.num_layers, a.hidden_dim, num_classes, **kw)
    if a.arch == "feedforward":
        return recurrent.FeedforwardClassifier(feat_dim, a.num_layers, a.hidden_dim,
                                               num_classes, **kw)
    if a.arch == "multitask_ae":
        return recurrent.AEClassifierMultitask(
            feat_dim, num_classes, a.num_layers, a.num_layers_dec, a.num_layers_dec,
            a.hidden_dim, a.bn_dim, a.dropout, **kw)
    if a.arch == "multitask_aear":
        return recurrent.AEClassifierMultitaskAEAR(
            feat_dim, num_classes, a.num_layers, a.num_layers_dec, a.num_layers_dec,
            a.hidden_dim, a.bn_dim, max(1, a.time_shift), **kw)
    if a.arch == "multimod":
        sizes = stream_sizes or [feat_dim // a.comp_num] * a.comp_num
        return recurrent.MultistreamRNN(sizes, a.num_layers, a.hidden_dim // a.comp_num,
                                        a.num_layers_dec, num_classes, **kw)
    if a.arch == "vae":
        return vae.VAE(feat_dim, a.num_layers, a.num_layers_dec, a.hidden_dim, a.bn_dim,
                       a.dropout, only_ae=bool(a.only_ae),
                       use_transformer=bool(a.use_transformer), **kw)
    if a.arch == "vae_classifier":
        return vae.VAEClassifier(feat_dim, num_classes, a.num_layers, a.num_layers_dec,
                                 a.num_layers_dec, a.hidden_dim, a.bn_dim, a.dropout, **kw)
    if a.arch == "arvae":
        return vae.ARVAE(feat_dim, a.num_layers, a.num_layers_dec, a.hidden_dim, a.bn_dim,
                         max(1, a.time_shift) if a.time_shift else 2, a.dropout, **kw)
    if a.arch == "pm_ae":
        return recurrent.AutoencoderRNN(feat_dim, a.num_layers, a.num_layers_dec,
                                        a.hidden_dim, a.bn_dim, dropout=a.dropout, **kw)
    if a.arch == "apc":
        return apc.APC(feat_dim, a.num_layers, a.hidden_dim, **kw)
    if a.arch == "curl" and (getattr(a, "expert_parallel", 1) or 1) > 1:
        return curl.CurlMultistreamClassifierEP(
            feat_dim, num_classes, a.num_layers, a.num_layers_dec, a.num_layers_dec,
            a.hidden_dim, a.hidden_dim, a.bn_dim, a.comp_num, mesh=mesh, **kw)
    if a.arch == "curl":
        return curl.CurlMultistreamClassifier(
            feat_dim, num_classes, a.num_layers, a.num_layers_dec, a.num_layers_dec,
            a.hidden_dim, a.hidden_dim, a.bn_dim, a.comp_num, **kw)
    if a.arch == "curl_unsup":
        return curl.CurlSupervised(feat_dim, a.num_layers, a.num_layers_dec, a.hidden_dim,
                                   a.bn_dim, a.comp_num, **kw)
    if a.arch in ("vae_encoded", "curl_encoded"):
        cls = (vae.VAEEncodedClassifier if a.arch == "vae_encoded"
               else curl.CurlEncodedClassifier)
        return cls(latent_dim, a.num_layers, a.hidden_dim, num_classes, **kw)
    return _build_conv(a, feat_dim, num_classes, kw)


def _build_conv(a, feat_dim, num_classes, kw):
    """The conv half, shaped as the JAX build_model shapes it: channels and
    kernel from hidden_dim, or from an importer's cnn_* keys."""
    from speech_recognition_tools_tpu_torch.models import cnn, modnet

    def geom(attr, default):
        v = getattr(a, attr, None)
        return tuple(v) if v else default

    kernel = geom("cnn_kernel", (3, 3))
    if a.arch == "cnn":
        return cnn.CNNFrameClassifier(
            feat_dim, geom("cnn_out_channels", (a.hidden_dim // 8,) * a.num_layers_dec),
            kernel, num_classes, **kw)
    if a.arch == "cldnn":
        return cnn.CLDNN(feat_dim, geom("cnn_out_channels", (a.hidden_dim // 8,)), kernel,
                         a.hidden_dim, a.num_layers, a.num_layers_dec, num_classes, **kw)
    if a.arch in ("vae_cnn", "vae_cnn_pool", "rs_vae"):
        ch = max(2, a.hidden_dim // 16)
        ins = geom("cnn_in_channels", (1, ch))
        outs = geom("cnn_out_channels", (ch, 2 * ch))
        if a.arch == "vae_cnn_pool":
            return cnn.VAECNN((feat_dim, patch_frames(a)), ins, outs, kernel, a.bn_dim, **kw)
        cls = cnn.VAECNNNopool if a.arch == "vae_cnn" else cnn.VaeRsModulation
        return cls(feat_dim, ins, outs, kernel, a.bn_dim, **kw)
    k = geom("cnn_kernel", (3,))[0]
    outs = geom("cnn_out_channels", (4,))
    W = a.patch_width
    if a.arch == "modnet":
        return modnet.ModulationNet(feat_dim, W, (1,), outs, k, a.freq_num, W / 100.0,
                                    a.head_num, a.num_layers_dec, a.hidden_dim, num_classes,
                                    **kw)
    if a.arch == "modnet_sigmoid":
        return modnet.ModulationSigmoidNet(
            feat_dim, W, (1,), outs, k, getattr(a, "input_filter_kernel", None) or 5,
            a.freq_num, W / 100.0, a.num_layers_dec, a.hidden_dim, num_classes, **kw)
    raise ValueError(a.arch)


def patch_frames(args) -> int:
    """The pooled conv VAE's patch width: an importer's num_frames, else
    train_am's --patch_width (21 by default)."""
    return int(getattr(args, "num_frames", None) or getattr(args, "patch_width", None) or 21)


def image(feats):
    """(B, T, D) -> the (B, 1, D, T) image of the conv archs."""
    return feats.transpose(1, 2)[:, None]


def extract_patches(feats, labels, lengths, width):
    """Centre-frame patches (the JAX _extract_patches): every frame start
    0..T-width gives a (1, D, width) patch labelled by its centre frame,
    valid where the centre lies before the utterance's length - width // 2.
    (B, T, D) -> patches (B * P, 1, D, width), labels (B * P,) or None,
    valid (B * P,)."""
    import torch

    B, T, D = feats.shape
    half = width // 2
    starts = torch.arange(max(T - width + 1, 0), device=feats.device)
    idx = starts[:, None] + torch.arange(width, device=feats.device)[None, :]
    patches = feats[:, idx].transpose(2, 3)[:, :, None]  # (B, P, 1, D, W)
    centers = starts + half
    valid = centers[None, :] < (lengths[:, None] - half).clamp_min(0)
    P = patches.shape[1]
    lab = labels[:, centers].reshape(B * P) if labels is not None else None
    return patches.reshape(B * P, 1, D, width), lab, valid.reshape(B * P)


def split_streams(feats, comp_num):
    """multimod's input: the parallel streams as given, or the feature dim
    split into comp_num contiguous streams."""
    if isinstance(feats, (list, tuple)):
        return list(feats)
    D = feats.shape[-1] // comp_num
    return [feats[..., k * D:(k + 1) * D] for k in range(comp_num)]


def make_loss(args, encode_fn=None, generator=None):
    """The loss of `args.arch`: (model, batch, train) -> (loss, aux dict),
    the JAX make_loss's branch for branch. `encode_fn` maps (feats,
    lengths) to the frozen base model's latents (vae_encoded, curl_encoded);
    `generator` draws the latent samples of the sampling archs (default: a
    CPU generator seeded with args.seed)."""
    import torch
    import torch.nn.functional as F

    from speech_recognition_tools_tpu_torch.models import apc, curl, vae
    from speech_recognition_tools_tpu_torch.parallel.collectives import global_mean, global_ratio
    from speech_recognition_tools_tpu_torch.train.losses import (
        masked_cross_entropy,
        masked_frame_error,
        masked_mse,
    )

    arch = args.arch
    if arch in SAMPLING_ARCHS and generator is None:
        generator = torch.Generator().manual_seed(args.seed)
    mean_p = None
    if arch == "curl_unsup":
        mean_p = curl.random_mixture_means(args.comp_num, args.bn_dim,
                                           torch.Generator().manual_seed(args.seed + 99))

    def classify(logits, batch, lengths):
        return masked_cross_entropy(logits, batch["labels"], lengths), {
            "fer": masked_frame_error(logits, batch["labels"], lengths)}

    def loss_fn(model, batch, train):
        # the JAX losses apply their models deterministically, train or not
        model.eval()
        if arch == "feedforward" and args.frame_egs:
            _, logits = model(batch["feats"])
            labels = batch["labels"].long()
            fer = 100.0 * global_mean((logits.argmax(-1) != labels).to(logits.dtype))
            return global_mean(F.cross_entropy(logits, labels, reduction="none")), {"fer": fer}
        feats, lengths = batch["feats"], batch["lengths"]
        if arch in ("vae_encoded", "curl_encoded"):
            return classify(model(encode_fn(feats, lengths), lengths), batch, lengths)
        t_axis = feats[0].shape[1] if isinstance(feats, (list, tuple)) else feats.shape[1]
        mask = torch.arange(t_axis, device=lengths.device)[None, :] < lengths[:, None]
        draw = dict(generator=generator)
        if arch in ("rnn", "linear"):
            return classify(model(feats, lengths), batch, lengths)
        if arch == "feedforward":
            return classify(model(feats)[1], batch, lengths)
        if arch == "multimod":
            return classify(model(split_streams(feats, args.comp_num), lengths), batch, lengths)
        if arch == "multitask_ae":
            logits, recon = model(feats, lengths)
            ce = masked_cross_entropy(logits, batch["labels"], lengths)
            mse = masked_mse(recon, feats, lengths)
            return ce + mse, {"ce": ce, "mse": mse}
        if arch == "multitask_aear":
            ts = max(1, args.time_shift)
            logits, recon, recon_ar = model(feats, lengths)
            ce = masked_cross_entropy(logits, batch["labels"], lengths)
            loss = (ce + masked_mse(recon, feats, lengths)
                    + masked_mse(recon_ar, feats[:, ts:], lengths - ts))
            return loss, {"ce": ce}
        if arch == "vae":
            recon, latent = model(feats, lengths, **draw)
            dist = "laplace" if args.loss == "vae_laplace" else "gauss"
            ll, kl = vae.vae_loss(feats, recon, latent, dist, mask)
            return -(ll + kl), {"ll": ll, "kl": kl}
        if arch == "vae_classifier":
            logits, recon, latent = model(feats, lengths, **draw)
            ll, kl = vae.vae_loss(feats, recon, latent, "gauss", mask)
            ce = masked_cross_entropy(logits, batch["labels"], lengths)
            return ce - (ll + kl), {"ce": ce}
        if arch == "arvae":
            outs, latent = model(feats, lengths, **draw)
            total = 0.0
            for k in range(outs.shape[0]):
                tgt = feats if k == 0 else torch.cat(
                    [feats[:, k:], torch.zeros_like(feats[:, :k])], dim=1)
                ll, kl = vae.vae_loss(tgt, outs[k], latent, "gauss", mask)
                total = total + ll + kl
            return -total / outs.shape[0], {}
        if arch == "curl":
            class_out, recon, latent = model(feats, lengths, **draw)
            ces = torch.stack([masked_cross_entropy(class_out[k], batch["labels"], lengths)
                               for k in range(class_out.shape[0])])
            w = global_mean(torch.where(mask[..., None], latent[0], 0.0), dim=(0, 1))
            ce = (ces * w / w.sum().clamp_min(1e-8)).sum()
            mse = torch.stack([masked_mse(recon[k], feats, lengths)
                               for k in range(recon.shape[0])]).mean()
            return ce + mse, {"ce": ce, "mse": mse}
        if arch == "curl_unsup":
            recon, latent = model(feats, lengths, **draw)
            mp = mean_p.to(device=feats.device, dtype=feats.dtype)
            return -curl.curl_loss_unsupervised(feats, recon, latent, mp, mask), {}
        if arch == "pm_ae":
            ts = args.time_shift
            if ts:
                recon, _ = model(feats[:, :-ts], lengths - ts)
                return masked_mse(recon, feats[:, ts:], lengths - ts), {}
            recon, _ = model(feats, lengths)
            return masked_mse(recon, feats, lengths), {}
        if arch == "apc":
            pred, _ = model(feats, lengths)
            return apc.apc_loss(pred, feats, lengths, args.time_shift or 3), {}
        if arch in ("cnn", "cldnn"):
            x = image(feats)
            return classify(model(x) if arch == "cnn" else model(x, lengths), batch, lengths)
        if arch in ("modnet", "modnet_sigmoid"):
            patches, lab, valid = extract_patches(feats, batch["labels"], lengths,
                                                  args.patch_width)
            logits = model(patches, **draw)[0] if arch == "modnet" else model(patches)[0]
            lab = lab.long()
            w = valid.to(logits.dtype)
            ce = F.cross_entropy(logits, lab, reduction="none")
            wrong = (logits.argmax(-1) != lab) & valid
            return (global_ratio((ce * w).sum(), w.sum().clamp_min(1.0)),
                    {"fer": 100.0 * global_ratio(wrong.sum(), valid.sum().clamp_min(1))})
        if arch == "vae_cnn_pool":
            # the plain per-element mean of the reference's vae_loss over
            # the valid patches
            patches, _, valid = extract_patches(feats, None, lengths, args.patch_width)
            recon, (means, logvars) = model(patches, **draw)
            w4 = valid.to(recon.dtype)[:, None, None, None]
            ll = global_ratio(((-0.5 * (patches - recon) ** 2 - 0.5 * vae.LOG_2PI) * w4).sum(),
                              (w4.sum() * patches[0].numel()).clamp_min(1.0))
            w2 = valid.to(means.dtype)[:, None]
            kl = 0.5 * global_ratio(
                ((1 - means**2 - torch.exp(logvars) ** 2 + 2 * logvars) * w2).sum(),
                (w2.sum() * means.shape[1]).clamp_min(1.0))
            return -(ll + kl), {}
        # vae_cnn, rs_vae
        x = image(feats)
        recon, (means, logvars) = model(x, **draw)
        m4 = mask[:, None, None, :].to(x.dtype)
        ll = global_ratio(((-0.5 * (x - recon) ** 2 - 0.5 * vae.LOG_2PI) * m4).sum(),
                          (m4.sum() * x.shape[2]).clamp_min(1.0))
        kl = 0.5 * global_mean(1 - means**2 - torch.exp(logvars) ** 2 + 2 * logvars)
        return -(ll + kl), {}

    return loss_fn


def batch_on_device(batch, dev):
    """A loader batch as tensors on `dev` (keys dropped; multi-stream
    feats stay a list). Its span `train.to_device` counts the bytes."""
    import torch

    from speech_recognition_tools_tpu_torch.utils.profiling import span

    out = {}
    with span("train.to_device") as sp:
        for k, v in batch.items():
            if k == "keys":
                continue
            out[k] = ([torch.as_tensor(s, device=dev) for s in v] if isinstance(v, list)
                      else torch.as_tensor(v, device=dev))
        if sp:
            sp.n = sum(t.nbytes for v in out.values()
                       for t in (v if isinstance(v, list) else [v]))
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    import torch

    from speech_recognition_tools_tpu_torch.cli.dump_outputs import (
        load_frozen_encoder,
        load_model_from_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.egs import (
        iter_egs_batches,
        iter_egs_batches_multi,
        iter_frame_batches,
        load_egs,
        load_egs_multi,
    )
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        model_from_jax,
        model_to_jax,
        optim_state_from_jax,
        optim_state_to_jax,
    )
    from speech_recognition_tools_tpu_torch.models.curl import expand_component
    from speech_recognition_tools_tpu_torch.models.recurrent import flax_reset_
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    par = _Parallel(args, dev)
    multi_dirs = stream_sizes = None
    if args.multi_egs_dirs:
        multi_dirs = [args.egs_dir] + args.multi_egs_dirs.split(",")
        cfgs, utts = load_egs_multi(multi_dirs)
        cfg_egs = cfgs[0]
        stream_sizes = [c.feat_dim for c in cfgs]
        args.comp_num = len(multi_dirs)
    else:
        # a frame-level egs dir holds no utterance shards: utts is empty
        cfg_egs, utts = load_egs(args.egs_dir)
    if args.dev_egs_dir and not multi_dirs:
        dev_utts = load_egs(args.dev_egs_dir)[1]
    else:
        if args.dev_egs_dir:
            print("WARNING: --dev_egs_dir is ignored with --multi_egs_dirs (dev would need "
                  "parallel stream dirs); using a held-out tail of the training utterances "
                  "for dev loss instead")
        dev_utts = utts[-max(1, len(utts) // 10):]
    num_classes = args.num_classes or cfg_egs.num_targets

    encode_fn = latent_dim = None
    if args.arch in ("vae_encoded", "curl_encoded"):
        assert args.base_model, f"--arch {args.arch} requires --base_model"
        encode_fn, latent_dim = load_frozen_encoder(args.base_model, args.arch, dev)
    if args.expand_from:
        assert args.arch == "curl", "--expand_from requires --arch curl"
        old, _, _ = load_model_from_checkpoint(args.expand_from, device=dev)
        model = expand_component(old, torch.Generator().manual_seed(args.seed + 7))
        args.comp_num = model.comp_num
        print(f"expanded CURL model to {model.comp_num} components")
    else:
        model = build_model(args, cfg_egs.feat_dim, num_classes, dev,
                            stream_sizes=stream_sizes, latent_dim=latent_dim, mesh=par.mesh)
        par.init_weights(model, args, torch.Generator().manual_seed(args.seed))

    if args.frame_egs:
        def train_iter():
            for b in iter_frame_batches(args.egs_dir, args.batch_size, shuffle_seed=args.seed):
                yield batch_on_device(par.shard(b), dev)

        def dev_iter():
            for b in iter_frame_batches(args.dev_egs_dir or args.egs_dir, args.batch_size):
                yield batch_on_device(par.shard(b), dev)
    else:
        batches = iter_egs_batches_multi if multi_dirs else iter_egs_batches

        def train_iter():
            for b in batches(utts, args.batch_size, shuffle_seed=args.seed):
                yield batch_on_device(par.shard(b), dev)

        def dev_iter():
            for b in batches(dev_utts, args.batch_size):
                yield batch_on_device(par.shard(b), dev)

    gen = None
    if args.arch in SAMPLING_ARCHS:  # one noise stream per data shard
        gen = torch.Generator().manual_seed(args.seed + 1000003 * par.data_index)
    trainer = Trainer(
        model, make_loss(args, encode_fn, gen),
        TrainConfig(
            optimizer=args.optimizer, learning_rate=args.learning_rate,
            epochs=args.epochs, lrr=args.lrr, lr_tol=args.lr_tol,
            clip_threshold=args.clip_thresh, seed=args.seed + 1000003 * par.data_index,
        ),
        reduce_group=par.reduce_group,
    )
    trainer.opt.norm_sq = par.norm_sq(dict(model.named_parameters()))
    state = trainer.init_state()
    clip = bool(args.clip_thresh)
    opt_name = args.optimizer.lower()

    def to_jax(sd):
        return model_to_jax(model, par.gather(sd))

    def from_jax(tree):
        return par.local(model_from_jax(model, tree))

    def opt_tree(st):
        return optim_state_to_jax(st.opt_state, to_jax, name=opt_name, clip=clip)

    # babysitter-style resume: newest checkpoint wins
    newest = latest_checkpoint(args.store_path)
    if newest:
        payload, meta = load_checkpoint(
            newest, template={"params": to_jax(state.params), "opt_state": opt_tree(state)})
        model.load_state_dict(from_jax(payload["params"]))
        opt = optim_state_from_jax(payload["opt_state"], from_jax, name=opt_name, clip=clip)
        state.opt_state = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                               else v) for k, v in opt.items()}
        state.best_params = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state.epoch = int(meta.get("extra", {}).get("epoch", 0))
        state.lr = float(meta.get("extra", {}).get("lr", args.learning_rate))
        print(f"resumed from {newest} at epoch {state.epoch}")

    hyper = dict(vars(args))
    hyper.update({"feature_dim": cfg_egs.feat_dim, "model_class": type(model).__name__,
                  "num_classes": num_classes})

    def checkpoint_fn(st):
        params, opt_state = to_jax(st.params), opt_tree(st)
        if is_main():
            save_checkpoint(
                args.store_path, f"epoch_{st.epoch}", params, hyper, opt_state=opt_state,
                extra={"epoch": st.epoch, "lr": st.lr, "history": st.history},
            )
        collectives.barrier()

    trainer.fit(state, train_iter, dev_iter, checkpoint_fn=checkpoint_fn,
                log_fn=print if is_main() else (lambda msg: None))
    final = to_jax({k: v.to(dev) for k, v in state.best_params.items()})
    if is_main():
        save_checkpoint(args.store_path, "final", final, hyper,
                        extra={"history": state.history})
        print(f"saved final model to {os.path.join(args.store_path, 'final')}")
    collectives.barrier()
    return state


class _Parallel:
    """train_am's layout: one process, or a (data, model) mesh over the
    torch.distributed world (--data_parallel shards the batches over
    'data'; --expert_parallel splits the CURL experts over 'model')."""

    def __init__(self, args, dev):
        self.mesh = None
        self.shard_data = args.data_parallel
        self.experts = args.expert_parallel > 1
        if not (args.data_parallel or self.experts):
            return
        if self.experts:
            assert args.arch == "curl", "--expert_parallel requires --arch curl"
            assert not args.expand_from, (
                "--expert_parallel with --expand_from is unsupported; grow the loop-layout "
                "model first, then convert with curl_params_to_ep")
        from speech_recognition_tools_tpu_torch.parallel.launcher import initialize_runtime
        from speech_recognition_tools_tpu_torch.parallel.mesh import make_mesh

        initialize_runtime(dev)
        self.mesh = make_mesh(model=args.expert_parallel)

    @property
    def data_index(self):
        return self.mesh.index("data") if self.mesh is not None and self.shard_data else 0

    @property
    def reduce_group(self):
        return self.mesh.group("data") if self.mesh is not None and self.shard_data else None

    def shard(self, batch):
        if self.reduce_group is None:
            return batch
        from speech_recognition_tools_tpu_torch.parallel.mesh import shard_batch

        return shard_batch(batch, self.mesh)

    def init_weights(self, model, args, generator):
        """flax's draws; an expert-parallel CURL model takes its experts of
        the loop-layout model's draws (the same initial model as one
        process's)."""
        from speech_recognition_tools_tpu_torch.models import curl
        from speech_recognition_tools_tpu_torch.models.recurrent import flax_reset_

        if not isinstance(model, curl.CurlMultistreamClassifierEP):
            flax_reset_(model, generator)
            return
        dev = next(model.parameters()).device
        loop = curl.CurlMultistreamClassifier(**model.config, device=dev)
        flax_reset_(loop, generator)
        model.load_state_dict(curl.curl_params_to_ep(loop.state_dict(), model.comp_num,
                                                     model.classifiers.owned))

    def _expert(self, k):
        return self.experts and k.startswith(("classifiers.", "decoders."))

    def gather(self, sd):
        """This rank's parameters (or a dict keyed like them) -> the whole
        model's (every expert)."""
        if not self.experts:
            return sd
        g = self.mesh.group("model")
        return {k: torch.cat(collectives.all_gather_list(v, g)) if self._expert(k) else v
                for k, v in sd.items()}

    def local(self, sd):
        """The whole model's dict -> this rank's experts."""
        if not self.experts:
            return sd
        from speech_recognition_tools_tpu_torch.parallel.ep import expert_param_sharding

        place = expert_param_sharding(self.mesh, "model")
        return {k: place(v) if self._expert(k) else v for k, v in sd.items()}

    def norm_sq(self, params):
        """The clipping norm over every expert: the experts' squares summed
        over the 'model' axis, the replicated encoder's once."""
        if not self.experts:
            return None
        keys = list(params)
        idx = torch.tensor([self._expert(k) for k in keys])
        group = self.mesh.group("model")

        def reduce(sq):
            mask = idx.to(sq.device)
            return sq[~mask].sum() + collectives.psum(sq[mask].sum(), group)

        return reduce


if __name__ == "__main__":
    main()
