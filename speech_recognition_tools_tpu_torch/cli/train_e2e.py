"""End-to-end transformer ASR training CLI, single device.

Port of speech_recognition_tools_tpu/cli/train_e2e.py with its flags: egs
features + a Kaldi text file in, a joint CTC/attention transformer out,
with the Noam schedule, gradient clipping and Adam (b2 0.98) as optax
computes them (train/optim.py), per-epoch checkpoints with the optimizer
state (resume from the newest `epoch_N`), `--init_from` warm starts, and a
`final_avg` checkpoint averaged over the last `--average_last` epochs
(`main` returns each epoch's mean loss). The
checkpoints are the JAX package's layout and bytes, so the JAX recog_e2e
decodes a model trained here. It runs on the card unless `--device cpu`
is given.

    python -m speech_recognition_tools_tpu_torch.cli.train_e2e egs/ text exp/am \
        [--adim 256 ... --specaug] [--device cpu]

`--encoder_type conformer --conv_kernel K` trains the conformer encoder
(recipes/configs/wsj_fdlp_conformer_e2e.json); `config.json` records both.
`--data_parallel`, `--tensor_parallel`, `--pipeline_parallel` and
`--compute_dtype bfloat16` raise NotImplementedError naming their ROADMAP
item.
"""

import argparse
import json
import os
import time


def get_parser():
    p = argparse.ArgumentParser("Train e2e transformer ASR")
    p.add_argument("egs_dir")
    p.add_argument("text", help="Kaldi text file: 'utt transcription'")
    p.add_argument("store_path")
    p.add_argument("--dev_egs_dir")
    p.add_argument("--adim", type=int, default=256)
    p.add_argument("--aheads", type=int, default=4)
    p.add_argument("--elayers", type=int, default=12)
    p.add_argument("--eunits", type=int, default=2048)
    p.add_argument("--dlayers", type=int, default=6)
    p.add_argument("--dunits", type=int, default=2048)
    p.add_argument("--mtlalpha", type=float, default=0.3)
    p.add_argument("--lsm_weight", type=float, default=0.1)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--encoder_type", default="transformer",
                   choices=["transformer", "conformer"])
    p.add_argument("--attn_chunk", type=int, default=0,
                   help="chunked encoder attention: chunk size in "
                        "post-subsampling frames (0 = full attention)")
    p.add_argument("--attn_left_chunks", type=int, default=-1,
                   help="left-context chunks each chunk may attend (-1 = unbounded)")
    p.add_argument("--conv_kernel", type=int, default=15,
                   help="conformer depthwise conv width")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"], help="only 'float32' is ported")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--warmup_steps", type=int, default=25000)
    p.add_argument("--transformer_lr", type=float, default=10.0)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--average_last", type=int, default=10)
    p.add_argument("--specaug", action="store_true",
                   help="apply SpecAugment (conf/specaug.yaml defaults)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min_io_ratio", type=float, default=1.0,
                   help="CTC-feasibility pruning: drop samples with "
                        "subsampled-enc-len - tokens*ratio < delta")
    p.add_argument("--min_io_delta", type=int, default=0)
    p.add_argument("--bucket_frames", type=int, default=32,
                   help="round padded batch frames up to this multiple")
    p.add_argument("--frame_rate", type=float, default=100.0,
                   help="feature frame rate in Hz, to convert frames to audio "
                        "seconds in the per-epoch throughput log")
    p.add_argument("--vocab", help="existing vocab.json; default: build from text")
    p.add_argument("--init_from",
                   help="warm-start from a model dir or checkpoint: params and "
                        "architecture geometry (and vocab.json) come from the "
                        "source, training knobs from this command line; the "
                        "optimizer starts fresh. Ignored once store_path holds "
                        "epoch checkpoints (resume wins)")
    p.add_argument("--data_parallel", action="store_true", help="not yet ported")
    p.add_argument("--tensor_parallel", type=int, default=1, help="not yet ported")
    p.add_argument("--pipeline_parallel", type=int, default=1, help="not yet ported")
    p.add_argument("--pp_microbatches", type=int, default=2, help="not yet ported")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def ctc_feasible(num_frames, num_tokens, min_io_ratio=1.0, min_io_delta=0):
    """CTC-feasibility filter (reference local/filtering_samples.py): prune
    samples whose subsampled encoder length cannot cover the label
    sequence. The encoder's VALID conv2d 4x subsampling gives
    out_len = ((l - 1) // 2 - 1) // 2. Repeated labels, which need a blank
    between them, are not counted."""
    enc_len = ((num_frames - 1) // 2 - 1) // 2
    return enc_len - num_tokens * min_io_ratio >= min_io_delta


def token_batches(egs_dir, texts, vocab, batch_size, min_io_ratio=1.0,
                  min_io_delta=0, bucket_frames=32):
    """Numpy batches dict(feats, lengths, tokens, token_lengths) of the
    utterances that have a text and pass ctc_feasible; the token axis is
    rounded up to a multiple of 16 (padding masked by token_lengths)."""
    import numpy as np

    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.text import encode_text

    for b in iter_egs_batches(egs_dir, batch_size, drop_labels=True,
                              bucket_multiple=bucket_frames):
        keys, idx = [], []
        for i, k in enumerate(b["keys"]):
            if k not in texts:
                continue
            if not ctc_feasible(
                int(b["lengths"][i]), len(encode_text(texts[k], vocab)) + 1,
                min_io_ratio, min_io_delta,
            ):
                continue
            keys.append(k)
            idx.append(i)
        if not keys:
            continue
        toks = [encode_text(texts[k], vocab) for k in keys]
        U = max(max(len(t) for t in toks) + 1, 4)
        U = -(-U // 16) * 16
        tokens = np.zeros((len(keys), U), np.int32)
        tlen = np.zeros(len(keys), np.int32)
        for i, t in enumerate(toks):
            tokens[i, : len(t)] = t
            tlen[i] = len(t)
        yield dict(
            feats=b["feats"][idx],
            lengths=b["lengths"][idx],
            tokens=tokens,
            token_lengths=tlen,
        )


def make_train_step(model, cfg, opt, use_specaug=False, generator=None):
    """The CTC/attention train step: step(opt_state, batch) runs the joint
    loss with dropout, its backward and one optimizer update of the
    model's parameters in place, and returns (opt_state, loss, aux). With
    `use_specaug`, SpecAugment draws from `generator` first."""
    from speech_recognition_tools_tpu_torch.dsp.specaug import spec_augment
    from speech_recognition_tools_tpu_torch.models.transformer_asr import asr_loss

    params = dict(model.named_parameters())

    def step(opt_state, batch):
        if use_specaug:
            batch = dict(batch, feats=spec_augment(batch["feats"], batch["lengths"],
                                                   generator))
        for p in params.values():
            p.grad = None
        loss, aux = asr_loss(model, batch, cfg, train=True)
        loss.backward()
        opt_state, _ = opt.apply(params, {k: p.grad for k, p in params.items()}, opt_state)
        return opt_state, loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def resolve_init_checkpoint(path):
    """`--init_from` accepts a checkpoint dir (holds state.msgpack) or a
    model dir (picks final_avg / final / newest epoch checkpoint).
    Returns (checkpoint_path, model_dir)."""
    from speech_recognition_tools_tpu_torch.train.checkpoint import latest_checkpoint

    if os.path.exists(os.path.join(path, "state.msgpack")):
        return path, os.path.dirname(path.rstrip("/"))
    for tag in ("final_avg", "final"):
        p = os.path.join(path, tag)
        if os.path.exists(os.path.join(p, "state.msgpack")):
            return p, path
    newest = latest_checkpoint(path)
    if newest:
        return newest, path
    raise FileNotFoundError(f"--init_from {path}: no checkpoint found")


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError("--data_parallel is not yet ported (ROADMAP Queue 1 item 7: "
                                  "the parallel paths)")
    if args.tensor_parallel > 1:
        raise NotImplementedError("--tensor_parallel is not yet ported (ROADMAP Queue 1 item 7: "
                                  "the parallel paths)")
    if args.pipeline_parallel > 1:
        raise NotImplementedError("--pipeline_parallel is not yet ported (ROADMAP Queue 1 item 7: "
                                  "the parallel paths)")

    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        adam_state_from_jax,
        adam_state_to_jax,
        transformer_asr_from_jax,
        transformer_asr_to_jax,
    )
    from speech_recognition_tools_tpu_torch.io.text import (
        build_char_vocab,
        load_vocab,
        read_text_file,
        save_vocab,
    )
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
        average_checkpoints,
        noam_schedule,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam
    from speech_recognition_tools_tpu_torch.train.trainer import host_copy
    from speech_recognition_tools_tpu_torch.utils.profiling import ThroughputMeter

    dev = resolve_device(args.device)
    texts = read_text_file(args.text)
    init_ckpt = None
    icfg = {}
    if args.init_from:
        init_ckpt, init_dir = resolve_init_checkpoint(args.init_from)
        with open(os.path.join(init_ckpt, "config.json")) as f:
            icfg = json.load(f)
        # token ids must match the source embedding: inherit its vocab
        # unless the caller explicitly points at one
        if not args.vocab:
            src_vocab = os.path.join(init_dir, "vocab.json")
            if not os.path.exists(src_vocab):
                raise SystemExit(
                    f"--init_from: {init_dir} has no vocab.json; pass --vocab with "
                    "the id assignment the source embedding was trained on")
            args.vocab = src_vocab
    vocab = load_vocab(args.vocab) if args.vocab else build_char_vocab(texts.values())
    os.makedirs(args.store_path, exist_ok=True)
    save_vocab(vocab, os.path.join(args.store_path, "vocab.json"))
    if init_ckpt and len(vocab) != icfg["vocab_size"]:
        raise SystemExit(f"--init_from vocab_size {icfg['vocab_size']} != "
                         f"vocab size {len(vocab)}")

    cfg = TransformerASRConfig(
        vocab_size=len(vocab),
        adim=icfg.get("adim", args.adim),
        aheads=icfg.get("aheads", args.aheads),
        elayers=icfg.get("elayers", args.elayers),
        eunits=icfg.get("eunits", args.eunits),
        dlayers=icfg.get("dlayers", args.dlayers),
        dunits=icfg.get("dunits", args.dunits),
        dropout=args.dropout, mtlalpha=args.mtlalpha, lsm_weight=args.lsm_weight,
        encoder_type=icfg.get("encoder_type", args.encoder_type),
        conv_kernel=icfg.get("conv_kernel", args.conv_kernel),
        attn_chunk=args.attn_chunk, attn_left_chunks=args.attn_left_chunks,
        compute_dtype=args.compute_dtype,
    )

    def batches():
        return token_batches(args.egs_dir, texts, vocab, args.batch_size,
                             args.min_io_ratio, args.min_io_delta, args.bucket_frames)

    first = next(batches())
    feat_dim = int(first["feats"].shape[-1])
    model = TransformerASR(cfg, feat_dim, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    params = dict(model.named_parameters())
    opt = ClipAdam(noam_schedule(cfg.adim, args.warmup_steps, args.transformer_lr),
                   args.grad_clip, b2=0.98)
    opt_state = opt.init(params)

    def to_tree(sd):
        return transformer_asr_to_jax(sd, cfg.aheads)

    def opt_tree(state):
        return adam_state_to_jax(state, to_tree, clip=True)

    def load_params(tree):
        model.load_state_dict(transformer_asr_from_jax(tree))

    # babysitter-style resume: newest epoch checkpoint wins (params,
    # optimizer state with the Noam step count, epoch counter, and the
    # recent-params window for final averaging)
    start_epoch = 0
    recent = []
    if os.path.exists(os.path.join(args.store_path, "final_avg")):
        print("final_avg already exists — training complete, nothing to do")
        return []
    newest = latest_checkpoint(args.store_path)
    if newest and os.path.basename(newest).startswith("epoch_"):
        try:
            payload, meta = load_checkpoint(
                newest, template={"params": to_tree(params), "opt_state": opt_tree(opt_state)})
            opt_state = adam_state_from_jax(payload["opt_state"], transformer_asr_from_jax,
                                            clip=True)
            for m in ("mu", "nu"):
                opt_state[m] = {k: v.to(dev) for k, v in opt_state[m].items()}
        except KeyError:  # a checkpoint without optimizer state
            payload, meta = load_checkpoint(newest, template={"params": to_tree(params)})
        load_params(payload["params"])
        start_epoch = int(meta.get("extra", {}).get("epoch", 0))
        for e in range(max(1, start_epoch - args.average_last + 1), start_epoch + 1):
            p = os.path.join(args.store_path, f"epoch_{e}")
            if os.path.exists(os.path.join(p, "state.msgpack")):
                pay, _ = load_checkpoint(p, template={"params": to_tree(params)})
                recent.append(transformer_asr_from_jax(pay["params"]))
        print(f"resumed from {newest} at epoch {start_epoch}")
    elif init_ckpt:
        payload, _ = load_checkpoint(init_ckpt, template={"params": to_tree(params)})
        load_params(payload["params"])
        print(f"initialized from {init_ckpt} (architecture geometry from "
              "the checkpoint; optimizer state fresh)")

    hyper = dict(vars(args))
    # the EFFECTIVE architecture (under --init_from the geometry comes from
    # the source checkpoint, not the CLI flags)
    hyper.update(model_class="TransformerASR", vocab_size=len(vocab), feature_dim=feat_dim,
                 adim=cfg.adim, aheads=cfg.aheads, elayers=cfg.elayers,
                 eunits=cfg.eunits, dlayers=cfg.dlayers, dunits=cfg.dunits,
                 encoder_type=cfg.encoder_type, conv_kernel=cfg.conv_kernel)

    torch.manual_seed(args.seed + 2 + start_epoch)  # dropout draws
    gen = torch.Generator().manual_seed(args.seed + 3 + start_epoch)  # SpecAugment's
    step = make_train_step(model, cfg, opt, use_specaug=args.specaug, generator=gen)
    epoch_losses = []
    for epoch in range(start_epoch, args.epochs):
        losses = []
        meter = ThroughputMeter()
        for b in batches():
            batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            t0 = time.time()
            opt_state, loss, _ = step(opt_state, batch)
            losses.append(float(loss))
            dt = time.time() - t0
            if len(losses) % 50 == 0:
                print(f"  step {len(losses)}: loss {losses[-1]:.4f} "
                      f"({dt * 1000:.0f} ms/step)", flush=True)
            # float(loss) above synchronised the device
            meter.update(items=int(b["feats"].shape[0]),
                         audio_seconds=float(b["lengths"].sum()) / args.frame_rate)
        epoch_losses.append(sum(losses) / max(len(losses), 1))
        print(f"epoch {epoch + 1}: loss {epoch_losses[-1]:.4f} ({meter.summary()})")
        save_checkpoint(args.store_path, f"epoch_{epoch + 1}", to_tree(params), hyper,
                        opt_state=opt_tree(opt_state), extra={"epoch": epoch + 1})
        recent.append(host_copy(params))
        if len(recent) > args.average_last:
            recent.pop(0)
    avg = average_checkpoints(recent)
    save_checkpoint(args.store_path, "final_avg", to_tree(avg), hyper,
                    extra={"averaged": len(recent)})
    print(f"saved averaged model ({len(recent)} ckpts) -> "
          f"{os.path.join(args.store_path, 'final_avg')}")
    return epoch_losses


if __name__ == "__main__":
    main()
