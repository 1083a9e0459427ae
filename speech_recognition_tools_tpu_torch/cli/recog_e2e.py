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
`--streaming` and the KV-cached search alike).

`model_dir` may name several directories, comma-separated: all are
loaded, and `--api v1` decodes with the first. `--api cl` with two or
more decodes one utterance at a time with the continual-learning fusion
(models/transformer_asr.py::cl_decode) weighted by `--pm_scores` (one per
model), ahead of `--jit_decode`, as the JAX CLI does. Like the JAX CLI it
parses a missing `--pm_scores` as [""] and raises ValueError there, and a
list shorter than the models drops the models past its end (ROADMAP
Queue 3).

`--word_lm_dir` fuses a word RNNLM (train_lm --unit word, or an imported
one) through the look-ahead prefix tree (decode/wordlm.py), with the word
list of `--word_lm_dict` ('word id' lines) or the LM dir's vocab.json, in
the offline search and in `--streaming`'s beam final, as the JAX CLI does;
it excludes `--lm_dir`, `--api cl` and `--jit_decode` (ValueError here,
where the JAX CLI asserts).

A speech-LLM model directory (models/speech_llm.py's `save`; config.json's
"model" is "speech_llm") decodes through the same batched search, its LLM
KV-cached (the audio prefix prefilled once an utterance), with the LLM's
scores alone: it has no CTC head and is its own LM, so `--ctc_weight`
above 0, `--lm_dir`, `--word_lm_dir`, `--streaming`, `--api cl` and
`--ring_attention` are refused for it (ValueError). `--ctc_weight`
defaults to 0.3 for the CTC/attention models and to 0 for it.

`--ring_attention S` encodes through ring
attention (models/transformer_asr.py::encode_ring) over the first S ranks
of a torch.distributed world (torchrun; the JAX CLI's first S devices),
with the host beam decode only (not --jit_decode or --api cl); every rank
searches, rank 0 writes the hypotheses:

    torchrun --nproc_per_node 2 -m speech_recognition_tools_tpu_torch.cli.recog_e2e \
        exp/am egs/ hyp.txt --ring_attention 2
"""

import argparse
import os

from speech_recognition_tools_tpu_torch.parallel.launcher import is_main


def get_parser():
    p = argparse.ArgumentParser("e2e ASR recognition")
    p.add_argument("model_dir", help="train_e2e output; comma-separated for --api cl")
    p.add_argument("egs_dir")
    p.add_argument("out_text")
    p.add_argument("--api", default="v1", choices=["v1", "cl"],
                   help="'cl': the continual-learning fusion of the comma-separated models")
    p.add_argument("--pm_scores", help="(cl) comma-separated PM scores, one per model")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=None,
                   help="CTC prefix score weight; default 0.3, or 0 for a speech-LLM "
                        "model (which has no CTC head)")
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
    p.add_argument("--word_lm_dir",
                   help="word RNNLM dir fused through the look-ahead prefix tree "
                        "(decode/wordlm.py); host beam paths only, exclusive with "
                        "--lm_dir")
    p.add_argument("--word_lm_dict",
                   help="(--word_lm_dir) ESPnet-style word list ('word id' lines); "
                        "default: vocab.json inside --word_lm_dir")
    p.add_argument("--oov_penalty", type=float, default=1e-4,
                   help="(--word_lm_dir) per-char penalty factor for out-of-lexicon words")
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
                   help="encode via ring attention over the first S ranks of the "
                        "world (torchrun): per-rank attention memory O(T*T/S); host "
                        "beam decode only (not --jit_decode / --api cl)")
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
    either package, or of a speech-LLM model directory (the model's own
    dtype; compute_dtype and the attention overrides do not apply)."""
    import json

    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
    from speech_recognition_tools_tpu_torch.io.text import load_vocab
    from speech_recognition_tools_tpu_torch.models import speech_llm
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint

    vocab = load_vocab(os.path.join(model_dir, "vocab.json"))
    with open(os.path.join(model_dir, ckpt, "config.json")) as f:
        if speech_llm.is_speech_llm(json.load(f)):
            model = speech_llm.load(os.path.join(model_dir, ckpt), device)
            return model, model.cfg, vocab
    payload, cfg_d = load_checkpoint(os.path.join(model_dir, ckpt))
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


def _word_lm(args, char_vocab, device):
    """The LookaheadWordLM of --word_lm_dir, with the JAX CLI's checks."""
    from speech_recognition_tools_tpu_torch.decode.wordlm import (
        LookaheadWordLM,
        word_vocab_from_dict,
    )
    from speech_recognition_tools_tpu_torch.io.text import load_vocab

    if args.lm_dir:
        raise ValueError("--word_lm_dir and --lm_dir are exclusive (the look-ahead "
                         "word LM already yields per-char fusion scores)")
    if args.api == "cl" or args.jit_decode:
        raise ValueError("--word_lm_dir fusion is a host decode path (no cl/jit)")
    wlm = _load_lm(args.word_lm_dir, device=device)
    n_vocab = wlm.embed.num_embeddings
    if args.word_lm_dict:
        wvocab = word_vocab_from_dict(args.word_lm_dict, n_vocab=n_vocab)
    else:
        wvocab = load_vocab(os.path.join(args.word_lm_dir, "vocab.json"))
        if max(wvocab.values()) >= n_vocab:
            raise ValueError(f"word vocab ids exceed the word LM's {n_vocab} embedding rows")
    return LookaheadWordLM(wlm, wvocab, char_vocab, oov_penalty=args.oov_penalty)


def _ring_encoder(args, model, dev):
    """encode(feats, lengths) through ring attention over the first
    --ring_attention ranks of the world (the other ranks encode plainly)."""
    from speech_recognition_tools_tpu_torch.models.transformer_asr import encode_ring
    from speech_recognition_tools_tpu_torch.parallel.launcher import initialize_runtime
    from speech_recognition_tools_tpu_torch.parallel.mesh import Mesh

    if args.api == "cl" or args.jit_decode:
        raise ValueError("--ring_attention works with the host beam decode path only")
    S = args.ring_attention
    _, world, _ = initialize_runtime(dev)
    assert world >= S, f"{S} ring devices requested, {world} available"
    mesh = Mesh({"time": S}, ranks=range(S))
    if not mesh.member:
        return model.encode
    return lambda feats, lengths: encode_ring(model, feats, lengths, mesh)


def _check_speech_llm(args, model) -> bool:
    """Whether `model` is a speech LLM; raises ValueError for the options
    it does not take."""
    from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLM

    if not isinstance(model, SpeechLLM):
        return False
    refused = [("--ctc_weight above 0 (the model has no CTC head)",
                args.ctc_weight is not None and args.ctc_weight > 0),
               ("--lm_dir (the LLM is its own LM)", bool(args.lm_dir)),
               ("--word_lm_dir (the LLM is its own LM)", bool(args.word_lm_dir)),
               ("--streaming", args.streaming), ("--api cl", args.api == "cl"),
               ("--ring_attention", args.ring_attention > 1)]
    bad = [name for name, given in refused if given]
    if bad:
        raise ValueError(f"{args.model_dir} is a speech-LLM model: it decodes with the "
                         f"LLM's scores alone and takes no {', '.join(bad)}")
    return True


def main(argv=None):
    args = get_parser().parse_args(argv)

    import torch

    from speech_recognition_tools_tpu_torch.decode.beam_jit import (
        beam_search_batched,
        beam_search_encoded,
        tokens_to_list,
    )
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.text import decode_tokens, read_text_file
    from speech_recognition_tools_tpu_torch.models.transformer_asr import cl_decode

    dev = resolve_device(args.device)
    loaded = [_load(d, args.ckpt, args.compute_dtype, args.attn_chunk, args.attn_left_chunks,
                    device=dev) for d in args.model_dir.split(",")]
    model, cfg, vocab = loaded[0]
    llm = _check_speech_llm(args, model)
    if args.ctc_weight is None:
        args.ctc_weight = 0.0 if llm else 0.3
    lm = _load_lm(args.lm_dir, device=dev) if args.lm_dir else None
    word_lm = _word_lm(args, vocab, dev) if args.word_lm_dir else None
    beam = dict(beam_size=args.beam_size, max_len=args.max_len, ctc_weight=args.ctc_weight,
                penalty=args.penalty)

    recognizer = None
    if args.streaming:
        if args.jit_decode or args.api == "cl":
            raise ValueError("--streaming is a host decode path (no --jit_decode, no --api cl)")
        from speech_recognition_tools_tpu_torch.infer.streaming_asr import StreamingRecognizer

        recognizer = StreamingRecognizer(model, vocab=vocab)

    encode_fn = None
    if args.ring_attention > 1:
        encode_fn = _ring_encoder(args, model, dev)

    cl = args.api == "cl" and len(loaded) > 1
    hyps = {}
    batch = args.batch_size if args.jit_decode else 1
    if cl and batch > 1:
        print("WARNING: --api cl decodes utterance-by-utterance; forcing batch_size 1")
        batch = 1
    for b in iter_egs_batches(args.egs_dir, batch, drop_labels=True,
                              bucket_multiple=args.bucket_frames):
        if cl:
            # the JAX CLI's parse: no --pm_scores gives float("") (ValueError)
            pm = [float(x) for x in (args.pm_scores or "").split(",")] or [1.0] * len(loaded)
            seqs = [cl_decode([m for m, _, _ in loaded], pm,
                              torch.as_tensor(b["feats"], device=dev),
                              torch.as_tensor(b["lengths"], device=dev), cfg,
                              beam_size=args.beam_size, max_len=args.max_len)]
        elif recognizer is not None:
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
                    lm=lm, lm_weight=args.lm_weight, prefix_scorer=word_lm, **beam)
                seqs = [tokens_to_list(toks[0], scores[0], cfg.eos_id)]
        elif encode_fn is not None:
            mem, enc_len, ctc = encode_fn(torch.as_tensor(b["feats"], device=dev),
                                          torch.as_tensor(b["lengths"], device=dev))
            toks, scores = beam_search_encoded(model, mem, enc_len, ctc, lm=lm,
                                               lm_weight=args.lm_weight,
                                               prefix_scorer=word_lm, **beam)
            seqs = [tokens_to_list(toks[i], scores[i], cfg.eos_id) for i in range(len(b["keys"]))]
        else:
            toks, scores = beam_search_batched(
                model, b["feats"], b["lengths"], lm=lm, lm_weight=args.lm_weight,
                device=dev, prefix_scorer=word_lm, incremental=llm, **beam)
            seqs = [tokens_to_list(toks[i], scores[i], cfg.eos_id) for i in range(len(b["keys"]))]
        for key, seq in zip(b["keys"], seqs):
            hyps[key] = decode_tokens(seq, vocab)
            if is_main():
                print(f"{key}: {hyps[key]}")

    if not is_main():
        return hyps
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
