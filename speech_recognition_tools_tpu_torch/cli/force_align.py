"""Standalone native forced alignment CLI, the Kaldi align pipeline's
analogue (reference: recipes/timit/run_get_hq_ali.sh producing the ali
that src/nnet/data_prep_for_seq.py:66-88 reads through ali-to-pdf).

Port of speech_recognition_tools_tpu/cli/force_align.py with its flags:
flat start + iterative Viterbi realignment over a lexicon
(align/forced.py), writing the ali.pkl the hybrid recipes consume ({utt:
(T,) int32 pdf labels}). It runs on the card unless `--device cpu` is
given.

    python -m speech_recognition_tools_tpu_torch.cli.force_align feats.scp text \\
        lexicon.txt ali.pkl [--states_per_phone 1] [--silence_phone N] [--iters 2] \\
        [--epochs 10] [--hidden_dim 96] [--device cpu]

The AM's initial weights are flax's distributions drawn from a
torch.Generator seeded with `--seed` + the iteration, where the JAX CLI
draws them from jax.random (align/forced.py).
"""

import argparse
import pickle


def get_parser():
    p = argparse.ArgumentParser("Native forced alignment (flat-start + "
                                "Viterbi realignment)")
    p.add_argument("feats_scp", help="feature scp (featgen CLI output)")
    p.add_argument("text", help="Kaldi text file: 'utt transcription'")
    p.add_argument("lexicon", help="word phone-id [phone-id ...] per line")
    p.add_argument("out", help="output ali.pkl")
    p.add_argument("--states_per_phone", type=int, default=1,
                   help="must match the decode graph's value")
    p.add_argument("--silence_phone", type=int, default=None,
                   help="optional-silence phone id (L_disambig topology)")
    p.add_argument("--silence_states", type=int, default=None,
                   help="silence phone's own chain length (Kaldi's "
                        "5-state silence / 3-state phones tier)")
    p.add_argument("--wpd_silence", action="store_true",
                   help="word-position-dependent silence: distinct pdf "
                        "block for utterance-boundary silence")
    p.add_argument("--self_loop_prob", type=float, default=0.5)
    p.add_argument("--iters", type=int, default=2,
                   help="train->realign iterations after flat-start")
    p.add_argument("--epochs", type=int, default=10,
                   help="AM epochs per iteration")
    p.add_argument("--hidden_dim", type=int, default=96)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None, **realign_kwargs):
    """Align and write ali.pkl; returns ({utt: labels}, num_pdfs).
    `realign_kwargs` go to realign_corpus (history, init_weights, timings)."""
    args = get_parser().parse_args(argv)

    from speech_recognition_tools_tpu_torch.align import read_lexicon, realign_corpus
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
    from speech_recognition_tools_tpu_torch.io.text import read_text_file

    feats = dict(read_mat_scp(args.feats_scp))
    texts = read_text_file(args.text)
    lexicon = read_lexicon(args.lexicon)

    labels, num_pdfs = realign_corpus(
        feats, texts, lexicon,
        states_per_phone=args.states_per_phone,
        silence_phone=args.silence_phone,
        silence_states=args.silence_states,
        wpd_silence=args.wpd_silence,
        self_loop_prob=args.self_loop_prob,
        num_iters=args.iters, am_epochs=args.epochs,
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        batch_size=args.batch_size, seed=args.seed, device=args.device,
        **realign_kwargs,
    )
    with open(args.out, "wb") as f:
        pickle.dump(labels, f)
    print(f"aligned {len(labels)} utts ({num_pdfs} pdfs) -> {args.out}")
    return labels, num_pdfs


if __name__ == "__main__":
    main()
