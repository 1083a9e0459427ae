"""n-gram LM build CLI.

Reference behaviour (recipes/timit/local_pyspeech/train_universal_lm.sh):
map transcript OOVs to <unk> against a lexicon, count words (+1 per
lexicon entry), train a 3-gram with kaldi_lm (train_lm.sh --arpa
--lmtype 3gram-mincount) and report held-out perplexity. Here the same
pipeline runs natively: models.ngram_lm interpolated modified-KN
estimation, ARPA (.gz) output, word counts artefact, perplexity report.

Copy of speech_recognition_tools_tpu/cli/train_ngram.py (host code).
"""

import argparse
import os


def get_parser():
    p = argparse.ArgumentParser("Build an ARPA n-gram LM from Kaldi text")
    p.add_argument("text", help="Kaldi text file: 'utt transcription'")
    p.add_argument("out_dir")
    p.add_argument("--lexicon", help="lexicon.txt; transcript words not in "
                                     "it become <unk> (text.no_oov step)")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--heldout", type=int, default=0,
                   help="hold out the first N sentences for perplexity")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    from collections import Counter

    from speech_recognition_tools_tpu_torch.io.text import read_text_file
    from speech_recognition_tools_tpu_torch.models.ngram_lm import (
        sentences_from_text,
        train_ngram_lm,
        write_arpa,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    texts = read_text_file(args.text)
    lexicon = None
    if args.lexicon:
        with open(args.lexicon) as f:
            lexicon = {
                line.split()[0]
                for line in f
                if line.strip() and not line.startswith("!SIL")
            }
    sents = sentences_from_text(texts.values(), lexicon)

    counts = Counter(w for s in sents for w in s)
    with open(os.path.join(args.out_dir, "word.counts"), "w") as f:
        for w, c in counts.most_common():
            f.write(f"{c} {w}\n")

    heldout = sents[: args.heldout]
    train = sents[args.heldout:] if args.heldout else sents
    lm = train_ngram_lm(train, order=args.order, add_lexicon=lexicon)
    arpa = os.path.join(args.out_dir, f"{args.order}gram.arpa.gz")
    write_arpa(lm, arpa)
    print(f"wrote {arpa} ({len(lm.logprob)} n-grams, vocab {len(lm.vocab)})")
    ppl_set = heldout if heldout else train
    which = "held-out" if heldout else "train"
    print(f"{which} perplexity: {lm.perplexity(ppl_set):.2f}")


if __name__ == "__main__":
    main()
