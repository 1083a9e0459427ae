"""End-to-end recognition CLI (asr_recog.py equivalent).

Port of speech_recognition_tools_tpu/cli/recog_e2e.py with its flags:
joint CTC/attention beam search (decode/beam_jit.py) with optional RNNLM
shallow fusion over an egs directory, a Kaldi-style `utt text` file out,
and the WER when a reference text is given. `--streaming` feeds the
features chunk by chunk through the incremental encoder
(infer/streaming_asr.py) and ends with the joint beam over the streamed
encoder output (`--streaming_final beam`, the offline chunked result) or
the greedy-CTC hypothesis. It runs on the card unless `--device cpu` is
given.

    python -m speech_recognition_tools_tpu_torch.cli.recog_e2e model_dir egs/ hyp.txt \\
        [--lm_dir lm/ --jit_decode --batch_size 8 | --streaming] [--device cpu]

The host search and `--jit_decode` are one search here (the batched loop
at batch 1 or `--batch_size`). Checkpoints are the JAX package's layout,
read with train/checkpoint.py; the model's config.json gives its encoder
(transformer, or conformer with its conv_kernel), and the LM's its cell
(gru or lstm). `--compute_dtype bfloat16` decodes in mixed precision
(float32 weights and logit heads, bfloat16 everywhere else; offline,
`--streaming` and the KV-cached search alike). `--api cl`, `--word_lm_dir`
and `--ring_attention > 1` raise NotImplementedError.
"""

import argparse
import os


def get_parser():
    p = argparse.ArgumentParser("e2e ASR recognition")
    p.add_argument("model_dir", help="train_e2e output")
    p.add_argument("egs_dir")
    p.add_argument("out_text")
    p.add_argument("--api", default="v1", choices=["v1", "cl"], help="only 'v1' is ported")
    p.add_argument("--pm_scores", help="(cl) not yet ported")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--penalty", type=float, default=0.0)
    p.add_argument("--max_len", type=int, default=200)
    p.add_argument("--ref_text", help="reference text for WER")
    p.add_argument("--ckpt", default="final_avg")
    p.add_argument("--jit_decode", action="store_true",
                   help="decode --batch_size utterances per batched search")
    p.add_argument("--batch_size", type=int, default=1,
                   help="(--jit_decode) utterances per batched search")
    p.add_argument("--bucket_frames", type=int, default=32,
                   help="round padded batch frames up to this multiple")
    p.add_argument("--lm_dir", help="train_lm checkpoint dir for RNNLM shallow fusion")
    p.add_argument("--lm_weight", type=float, default=1.0)
    p.add_argument("--word_lm_dir", help="not yet ported")
    p.add_argument("--word_lm_dict", help="(--word_lm_dir) not yet ported")
    p.add_argument("--oov_penalty", type=float, default=1e-4,
                   help="(--word_lm_dir) not yet ported")
    p.add_argument("--attn_chunk", type=int, default=None,
                   help="override the checkpoint's encoder attention chunking "
                        "at decode time; default: from the checkpoint")
    p.add_argument("--attn_left_chunks", type=int, default=None,
                   help="override left-context chunks with --attn_chunk")
    p.add_argument("--streaming", action="store_true",
                   help="online decode: feed features chunk by chunk through "
                        "the incremental encoder (needs --attn_chunk > 0 and "
                        "--attn_left_chunks >= 0 in the model)")
    p.add_argument("--streaming_feed", type=int, default=40,
                   help="raw feature frames per simulated arrival push")
    p.add_argument("--streaming_final", default="beam", choices=["beam", "greedy"],
                   help="final pass: joint CTC/attention beam over the streamed "
                        "encoder output, or the incremental greedy-CTC hypothesis")
    p.add_argument("--streaming_rescore_every", type=int, default=0,
                   help="N > 0: every N pushes, print an attention-rescored "
                        "partial (beam over the memory streamed so far)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="inference compute dtype: bfloat16 keeps the float32 weights "
                        "and the float32 logit heads and computes the rest in bf16")
    p.add_argument("--ring_attention", type=int, default=0, metavar="S",
                   help="not yet ported")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _load_lm(lm_dir, ckpt="final", device="cuda"):
    """The RNNLM of a train_lm checkpoint directory, on `device`."""
    from speech_recognition_tools_tpu_torch.io.jax_params import rnnlm_from_jax
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint

    payload, cfg_d = load_checkpoint(os.path.join(lm_dir, ckpt))
    lm = RNNLM(cfg_d["vocab_size"], cfg_d["embed_dim"], cfg_d["hidden"], cfg_d["layers"],
               cfg_d.get("cell", "gru"), device=device)
    lm.load_state_dict(rnnlm_from_jax(payload["params"]))
    return lm.eval()


def _load(model_dir, ckpt, compute_dtype="float32", attn_chunk=None,
          attn_left_chunks=None, device="cuda"):
    """(model in eval mode on `device`, its config, vocab) of a train_e2e
    model directory (`<model_dir>/<ckpt>/` and `vocab.json`), written by
    either package."""
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
    from speech_recognition_tools_tpu_torch.io.text import load_vocab
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint

    payload, cfg_d = load_checkpoint(os.path.join(model_dir, ckpt))
    vocab = load_vocab(os.path.join(model_dir, "vocab.json"))
    cfg = TransformerASRConfig(
        vocab_size=cfg_d["vocab_size"], adim=cfg_d["adim"], aheads=cfg_d["aheads"],
        elayers=cfg_d["elayers"], eunits=cfg_d["eunits"], dlayers=cfg_d["dlayers"],
        dunits=cfg_d["dunits"], dropout=0.0, mtlalpha=cfg_d["mtlalpha"],
        lsm_weight=cfg_d["lsm_weight"],
        encoder_type=cfg_d.get("encoder_type", "transformer"),
        conv_kernel=cfg_d.get("conv_kernel", 15),
        attn_chunk=cfg_d.get("attn_chunk", 0) if attn_chunk is None else attn_chunk,
        attn_left_chunks=(cfg_d.get("attn_left_chunks", -1) if attn_left_chunks is None
                          else attn_left_chunks),
        compute_dtype=compute_dtype,
    )
    sd = transformer_asr_from_jax(payload["params"])
    # flax infers the feature dim from the input; only the subsampled
    # width d2 = ((idim - 1) // 2 - 1) // 2 shapes a weight, so without a
    # recorded feature_dim the smallest idim of that width serves
    d2 = sd["encoder.embed.out.weight"].shape[1] // cfg.adim
    idim = cfg_d.get("feature_dim") or 4 * d2 + 3
    model = TransformerASR(cfg, idim, device=device)
    model.load_state_dict(sd)
    return model.eval(), cfg, vocab


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.api == "cl":
        raise NotImplementedError("--api cl (continual-learning decode) is not yet ported")
    if args.word_lm_dir:
        raise NotImplementedError("--word_lm_dir (look-ahead word LM) is not yet ported")
    if args.ring_attention > 1:
        raise NotImplementedError("--ring_attention is not yet ported")

    import torch

    from speech_recognition_tools_tpu_torch.decode.beam_jit import (
        beam_search_batched,
        beam_search_encoded,
        tokens_to_list,
    )
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.text import decode_tokens, read_text_file

    dev = resolve_device(args.device)
    model, cfg, vocab = _load(args.model_dir, args.ckpt, args.compute_dtype,
                              args.attn_chunk, args.attn_left_chunks, device=dev)
    lm = _load_lm(args.lm_dir, device=dev) if args.lm_dir else None
    beam = dict(beam_size=args.beam_size, max_len=args.max_len, ctc_weight=args.ctc_weight,
                penalty=args.penalty)

    recognizer = None
    if args.streaming:
        if args.jit_decode:
            raise ValueError("--streaming is a host decode path (no --jit_decode)")
        from speech_recognition_tools_tpu_torch.infer.streaming_asr import StreamingRecognizer

        recognizer = StreamingRecognizer(model, vocab=vocab)

    hyps = {}
    batch = args.batch_size if args.jit_decode else 1
    for b in iter_egs_batches(args.egs_dir, batch, drop_labels=True,
                              bucket_multiple=args.bucket_frames):
        if recognizer is not None:
            # online decode: emulate frame arrival; the streamed encoder
            # output is the offline chunked encode, so the final beam is
            # the offline joint decode
            recognizer.reset()
            n = int(b["lengths"][0])
            x = b["feats"][0, :n]
            for pi, s in enumerate(range(0, n, args.streaming_feed)):
                recognizer.push(x[s : s + args.streaming_feed])
                if args.streaming_rescore_every and (pi + 1) % args.streaming_rescore_every == 0:
                    part = recognizer.rescored_partial(model, **beam)
                    print(f"  [rescored partial @push {pi + 1}] {decode_tokens(part, vocab)}")
            greedy = recognizer.finish()
            if args.streaming_final == "greedy":
                seqs = [greedy]
            else:
                mem = torch.as_tensor(recognizer.memory[None]).to(dev)
                ctc = torch.as_tensor(recognizer.ctc_logits[None]).to(dev)
                toks, scores = beam_search_encoded(
                    model, mem, torch.tensor([recognizer.enc_len], device=dev), ctc,
                    lm=lm, lm_weight=args.lm_weight, **beam)
                seqs = [tokens_to_list(toks[0], scores[0], cfg.eos_id)]
        else:
            toks, scores = beam_search_batched(
                model, b["feats"], b["lengths"], lm=lm, lm_weight=args.lm_weight,
                device=dev, **beam)
            seqs = [tokens_to_list(toks[i], scores[i], cfg.eos_id) for i in range(len(b["keys"]))]
        for key, seq in zip(b["keys"], seqs):
            hyps[key] = decode_tokens(seq, vocab)
            print(f"{key}: {hyps[key]}")

    with open(args.out_text, "w") as f:
        for k, v in hyps.items():
            f.write(f"{k} {v}\n")

    if args.ref_text:
        from speech_recognition_tools_tpu_torch.eval.wer import score_hypotheses

        refs = {k: v.split() for k, v in read_text_file(args.ref_text).items() if k in hyps}
        wer, _ = score_hypotheses(refs, {k: v.split() for k, v in hyps.items()})
        print(f"WER: {wer:.2f}%")
    return hyps


if __name__ == "__main__":
    main()
