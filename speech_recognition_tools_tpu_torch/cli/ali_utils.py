"""Alignment / dictionary glue utilities (host code).

Port of speech_recognition_tools_tpu/cli/ali_utils.py, the native
equivalents of the reference's Kaldi-glue shell scripts
(recipes/timit/local_pyspeech/):
  * convert  — convert_ali.sh:11-18 (convert-ali between models): a
    label map applied to ali.pkl alignments (the native alignment
    container of recipes/run_corpus.py and io.build_egs).
  * combine  — combine_alidirs_blindly.sh:10-18: merge several ali.pkl
    files into one (key collisions get a directory-name prefix, like the
    reference's ali.$data_name.N.gz renaming).
  * simplify-lexicon — simplify_dictionary.sh:14-28: map phones through a
    phone_map file ('base alt1 alt2 ...' lines) and deduplicate
    pronunciations.
  * combine-lexicon — combine_dict.sh:16-30: merge several lexicon files
    into one universal dictionary (per-source uppercase normalisation —
    the reference uppercases only the Fisher lexicon — first occurrence
    wins on (word, phones) duplicates).

Usage:
  python -m speech_recognition_tools_tpu_torch.cli.ali_utils convert in_ali.pkl out_ali.pkl \\
      --label_map map.txt
  ... ali_utils combine out_ali.pkl in1.pkl in2.pkl ...
  ... ali_utils simplify-lexicon in_lexicon.txt out_lexicon.txt phone_map.txt
  ... ali_utils combine-lexicon out_lexicon.txt in1.txt in2.txt [--uppercase 0,2|all]
"""

import argparse
import os
import pickle


def get_parser():
    p = argparse.ArgumentParser("alignment/dictionary glue utilities")
    sub = p.add_subparsers(dest="cmd", required=True)

    cv = sub.add_parser("convert", help="apply a label map to alignments")
    cv.add_argument("in_ali", help="ali.pkl ({utt: int frame labels})")
    cv.add_argument("out_ali")
    cv.add_argument("--label_map", required=True,
                    help="text map: 'old new' int pairs per line")

    cb = sub.add_parser("combine", help="merge alignment pickles")
    cb.add_argument("out_ali")
    cb.add_argument("in_alis", nargs="+")

    sl = sub.add_parser("simplify-lexicon",
                        help="collapse phone variants per a phone map")
    sl.add_argument("in_lexicon", help="word phone [phone ...] lines")
    sl.add_argument("out_lexicon")
    sl.add_argument("phone_map", help="'base alt1 alt2 ...' lines")

    cl = sub.add_parser("combine-lexicon",
                        help="merge lexicons into a universal dictionary")
    cl.add_argument("out_lexicon")
    cl.add_argument("in_lexicons", nargs="+")
    cl.add_argument("--uppercase", default="",
                    help="comma-separated 0-based indices of inputs whose "
                         "words to uppercase (combine_dict.sh uppercases "
                         "only the Fisher lexicon); 'all' for every input")
    return p


def convert_alignments(alis, label_map):
    import numpy as np

    out = {}
    for k, v in alis.items():
        v = np.asarray(v)
        bad = [int(x) for x in np.unique(v) if int(x) not in label_map]
        if bad:
            raise ValueError(f"{k}: labels not in map: {bad[:10]}")
        lut = np.zeros(int(v.max()) + 1, v.dtype)
        for old, new in label_map.items():
            if old <= int(v.max()):
                lut[old] = new
        out[k] = lut[v]
    return out


def combine_alignments(named_alis):
    """named_alis: [(name, {utt: labels})]; duplicate keys across inputs
    get '<name>_' prefixes (combine_alidirs_blindly renaming)."""
    out = {}
    for name, alis in named_alis:
        for k, v in alis.items():
            key = k if k not in out else f"{name}_{k}"
            out[key] = v
    return out


def simplify_lexicon(lines, phone_map):
    """phone_map: {alt: base}; returns deduped 'word phones' lines with
    every alternate phone collapsed to its base."""
    seen = set()
    out = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        word, phones = parts[0], [phone_map.get(x, x) for x in parts[1:]]
        key = (word, tuple(phones))
        if key in seen:
            continue
        seen.add(key)
        out.append(" ".join([word] + phones))
    return out


def combine_lexicons(lexicon_lines, uppercase=()):
    """lexicon_lines: list of line-lists, one per input lexicon, merged
    in order; duplicates on (word, phones) are dropped (first wins).
    uppercase: indices of inputs whose words are uppercased first."""
    uppercase = set(uppercase)
    seen = set()
    out = []
    for i, lines in enumerate(lexicon_lines):
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            word = parts[0].upper() if i in uppercase else parts[0]
            key = (word, tuple(parts[1:]))
            if key in seen:
                continue
            seen.add(key)
            out.append(" ".join([word] + parts[1:]))
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.cmd == "convert":
        with open(args.in_ali, "rb") as f:
            alis = pickle.load(f)
        lm = {}
        with open(args.label_map) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    lm[int(parts[0])] = int(parts[1])
        out = convert_alignments(alis, lm)
        with open(args.out_ali, "wb") as f:
            pickle.dump(out, f)
        print(f"converted {len(out)} alignments -> {args.out_ali}")
    elif args.cmd == "combine-lexicon":
        all_lines = []
        for path in args.in_lexicons:
            with open(path) as f:
                all_lines.append(f.read().splitlines())
        if args.uppercase == "all":
            up = range(len(all_lines))
        elif args.uppercase:
            up = [int(x) for x in args.uppercase.split(",")]
        else:
            up = ()
        out = combine_lexicons(all_lines, uppercase=up)
        with open(args.out_lexicon, "w") as f:
            f.write("\n".join(out) + "\n")
        print(f"combined {sum(map(len, all_lines))} -> {len(out)} entries")
    elif args.cmd == "combine":
        named = []
        for path in args.in_alis:
            with open(path, "rb") as f:
                named.append(
                    (os.path.basename(os.path.dirname(path) or path),
                     pickle.load(f))
                )
        out = combine_alignments(named)
        with open(args.out_ali, "wb") as f:
            pickle.dump(out, f)
        print(f"combined {len(out)} alignments -> {args.out_ali}")
    else:
        pm = {}
        with open(args.phone_map) as f:
            for line in f:
                parts = line.split()
                for alt in parts[1:]:
                    pm[alt] = parts[0]
        with open(args.in_lexicon) as f:
            lines = f.read().splitlines()
        out = simplify_lexicon(lines, pm)
        with open(args.out_lexicon, "w") as f:
            f.write("\n".join(out) + "\n")
        print(f"{len(lines)} -> {len(out)} lexicon entries")


if __name__ == "__main__":
    main()
