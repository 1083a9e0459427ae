"""RNNLM training CLI, character units with the GRU or LSTM cell.

Port of speech_recognition_tools_tpu/cli/train_lm.py with its flags and
outputs: a Kaldi text file in, `vocab.json`, one `epoch_N` checkpoint per
epoch (parameters, the Adam state and `extra.epoch`) and a `final`
checkpoint whose config is the flags plus `model_class` "RNNLM" and
`vocab_size`, all in the JAX package's layout, so that the JAX
`recog_e2e --lm_dir` fuses the LM and either CLI resumes from the other's
newest `epoch_N`. It runs on the card unless `--device cpu` is given.

    python -m speech_recognition_tools_tpu_torch.cli.train_lm text exp/lm \\
        [--vocab exp/e2e/vocab.json] [--device cpu]

The optimizer is plain optax.adam(lr) written out by train/optim.py
(`ClipAdam(lr, None, inject=False)`: no clipping, the rate as given), and
its state is written in that layout (io/jax_params.py, `inject=False`). The initial weights come
from a torch.Generator seeded with `--seed` (flax's distributions, not
jax.random's bits); the batches are shuffled by numpy as in the JAX CLI.
`--cell lstm` trains the JAX package's LSTM RNNLM (flax OptimizedLSTMCell
layers, ESPnet's default LM cell). `--unit word` raises
NotImplementedError.
"""

import argparse
import os

_WORD = ("--unit word is not yet ported (ROADMAP Queue 1 item 3: word-level LMs and the "
         "look-ahead word LM)")


def get_parser():
    p = argparse.ArgumentParser("Train a character RNNLM for shallow fusion")
    p.add_argument("text", help="Kaldi text file: 'utt transcription'")
    p.add_argument("store_path")
    p.add_argument("--vocab", help="vocab.json from train_e2e (default: "
                                   "build from the text, which matches "
                                   "train_e2e on the same text)")
    p.add_argument("--unit", default="char", choices=["char", "word"],
                   help="token unit; only 'char' is ported")
    p.add_argument("--word_vocab_size", type=int, default=65000,
                   help="(--unit word) not yet ported")
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--hidden", type=int, default=1000)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--cell", default="gru", choices=["gru", "lstm"],
                   help="recurrent cell (lstm matches ESPnet's default LM cell)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--bptt_len", type=int, default=128,
                   help="max tokens per sequence (longer texts are split)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def lm_batches(texts, vocab, batch_size, bptt_len, seed=None):
    """Yield (tokens (B, U) int32 -1-padded, lengths (B,) int32) batches of
    sos + tokens + eos, where <sos/eos> (the last id) bounds each sequence,
    as in train_e2e's token space (character units only). With `seed`, the
    sequences are shuffled by numpy's RandomState(seed), as the JAX CLI
    shuffles them."""
    import numpy as np

    from speech_recognition_tools_tpu_torch.io.text import encode_text

    sos = len(vocab) - 1
    seqs = []
    for t in texts.values():
        ids = encode_text(t, vocab)
        for off in range(0, len(ids), bptt_len - 2):
            chunk = ids[off : off + bptt_len - 2]
            seqs.append([sos] + chunk + [sos])  # sos/eos share the id
    order = np.arange(len(seqs))
    if seed is not None:
        np.random.RandomState(seed).shuffle(order)
    seqs = [seqs[i] for i in order]
    for off in range(0, len(seqs), batch_size):
        group = seqs[off : off + batch_size]
        U = max(len(s) for s in group)
        toks = np.full((len(group), U), -1, np.int32)
        lens = np.zeros(len(group), np.int32)
        for i, s in enumerate(group):
            toks[i, : len(s)] = s
            lens[i] = len(s)
        yield toks, lens


def make_train_step(model, opt):
    """step(opt_state, tokens, lengths) -> (opt_state, loss): lm_loss, its
    backward and one Adam update of the model's parameters in place."""
    from speech_recognition_tools_tpu_torch.models.rnnlm import lm_loss

    params = dict(model.named_parameters())

    def step(opt_state, tokens, lengths):
        for p in params.values():
            p.grad = None
        loss = lm_loss(model, tokens, lengths)
        loss.backward()
        opt_state, _ = opt.apply(params, {k: p.grad for k, p in params.items()}, opt_state)
        return opt_state, loss.detach()

    return step


def main(argv=None):
    """Train; returns each epoch's mean loss (the nll the JAX CLI prints)."""
    args = get_parser().parse_args(argv)
    if args.unit != "char":
        raise NotImplementedError(_WORD)

    import numpy as np
    import torch

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        adam_state_from_jax,
        adam_state_to_jax,
        rnnlm_from_jax,
        rnnlm_to_jax,
    )
    from speech_recognition_tools_tpu_torch.io.text import (
        build_char_vocab,
        load_vocab,
        read_text_file,
        save_vocab,
    )
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    dev = resolve_device(args.device)
    texts = read_text_file(args.text)
    vocab = load_vocab(args.vocab) if args.vocab else build_char_vocab(texts.values())
    os.makedirs(args.store_path, exist_ok=True)
    save_vocab(vocab, os.path.join(args.store_path, "vocab.json"))

    model = RNNLM(len(vocab), args.embed_dim, args.hidden, args.layers, args.cell, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    params = dict(model.named_parameters())
    opt = ClipAdam(args.learning_rate, None, inject=False)
    opt_state = opt.init(params)

    def opt_tree(state):
        return adam_state_to_jax(state, rnnlm_to_jax, clip=False, inject=False)

    hyper = dict(vars(args))
    hyper.update(model_class="RNNLM", vocab_size=len(vocab))
    # babysitter-style resume: the newest per-epoch checkpoint wins
    start_ep = 0
    newest = latest_checkpoint(args.store_path)
    if newest and os.path.basename(newest).startswith("epoch_"):
        try:
            payload, meta = load_checkpoint(
                newest, template={"params": rnnlm_to_jax(params), "opt_state": opt_tree(opt_state)})
            opt_state = adam_state_from_jax(payload["opt_state"], rnnlm_from_jax, clip=False)
            for m in ("mu", "nu"):
                opt_state[m] = {k: v.to(dev) for k, v in opt_state[m].items()}
            # the optax tree holds no rate: plain adam scales by the flag's
            opt_state["learning_rate"] = float(args.learning_rate)
        except KeyError:  # a checkpoint without optimizer state
            payload, meta = load_checkpoint(newest, template={"params": rnnlm_to_jax(params)})
        model.load_state_dict(rnnlm_from_jax(payload["params"]))
        start_ep = int(meta.get("extra", {}).get("epoch", 0))
        print(f"resumed from {newest} at epoch {start_ep}")

    step = make_train_step(model, opt)
    epoch_nll = []
    for ep in range(start_ep, args.epochs):
        losses = []
        for toks, lens in lm_batches(texts, vocab, args.batch_size, args.bptt_len,
                                     seed=args.seed + ep):
            opt_state, loss = step(opt_state, torch.as_tensor(toks, device=dev).long(),
                                   torch.as_tensor(lens, device=dev).long())
            losses.append(float(loss))
        epoch_nll.append(float(np.mean(losses)))
        print(f"epoch {ep + 1}: nll {epoch_nll[-1]:.4f} ppl {np.exp(epoch_nll[-1]):.2f}")
        save_checkpoint(args.store_path, f"epoch_{ep + 1}", rnnlm_to_jax(params), hyper,
                        opt_state=opt_tree(opt_state), extra={"epoch": ep + 1})

    save_checkpoint(args.store_path, "final", rnnlm_to_jax(params), hyper)
    print(f"saved LM to {os.path.join(args.store_path, 'final')}")
    return epoch_nll


if __name__ == "__main__":
    main()
