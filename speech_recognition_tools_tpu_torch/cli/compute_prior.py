"""Class log-prior CLI (replaces compute_log_prior.py): counts labels in
alignment arks (or egs labels) and writes the pickled log-prior vector.

Port of speech_recognition_tools_tpu/cli/compute_prior.py (host code, the
same flags and the same pickle).
"""

import argparse
import pickle


def get_parser():
    p = argparse.ArgumentParser("Compute class log-priors")
    p.add_argument("source", help="alignment ark file OR egs directory")
    p.add_argument("save_file")
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--ali_type", default="pdf", choices=["pdf", "phone"])
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    import os

    from speech_recognition_tools_tpu_torch.infer.posteriors import (
        compute_log_prior_from_alignments,
    )

    if os.path.isdir(args.source):
        from speech_recognition_tools_tpu_torch.io.egs import load_egs

        _, utts = load_egs(args.source)
        it = ((k, l) for k, _, l in utts if l is not None)
        prior = compute_log_prior_from_alignments(
            it, args.num_classes, ali_type="pdf"
        )
    else:
        from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_vec_int_ark

        prior = compute_log_prior_from_alignments(
            read_vec_int_ark(args.source), args.num_classes, args.ali_type
        )
    with open(args.save_file, "wb") as f:
        pickle.dump(prior, f)
    print(f"log-priors ({args.num_classes} classes) -> {args.save_file}")


if __name__ == "__main__":
    main()
