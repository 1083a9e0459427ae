"""Hybrid WFST decoding CLI: the native decode_dnn.sh stages 1-2.

Reference flow (recipes/timit/local_pyspeech/decode_dnn.sh): dump
log-likelihoods (cli/dump_outputs.py = stage 0) -> mkgraph + Kaldi
latgen-faster-mapped -> score. Here the graph is built natively
(decode/graph.py: HMM x lexicon x n-gram from cli/train_ngram.py) and
decoded by the C++ beam-Viterbi core (native/fst_decode.cpp); scoring is
eval/wer.score_hypotheses.

Port of speech_recognition_tools_tpu/cli/decode_wfst.py with its three
subcommands and flags. The graph build and the searches are host code, as
in the JAX package, over the port's own native library (io/native.py,
built with g++ at first use; it raises where the JAX loader falls back to
Python). --rescore_lm_dir loads the train_lm checkpoint with the port's
cli/recog_e2e.py::_load_lm onto --device (default "cuda"; the RNNLM is the
only device work here, and --device is read only with --rescore_lm_dir).

Usage:
  build a graph:  decode_wfst build-graph <arpa> <lexicon.txt> <graph_dir>
  decode:         decode_wfst decode <graph_dir> <loglikes.ark> <out.txt>
                      [--ref_text text] [--acoustic_scale 0.1] ...
"""

import argparse
import os


def get_parser():
    p = argparse.ArgumentParser("Native WFST graph build + hybrid decode")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-graph", help="HMM x lexicon x n-gram -> WFST")
    b.add_argument("arpa", help="ARPA LM (train_ngram output; .gz ok)")
    b.add_argument("lexicon", help="lexicon text: word phone [phone ...] "
                                   "(phones as 0-based integer ids)")
    b.add_argument("graph_dir")
    b.add_argument("--states_per_phone", type=int, default=3)
    b.add_argument("--self_loop_prob", type=float, default=0.5)
    b.add_argument("--silence_phone", type=int, default=None)
    b.add_argument("--silence_states", type=int, default=None,
                   help="silence phone's own HMM chain length (Kaldi's "
                        "5-state silence / 3-state phones tier)")
    b.add_argument("--wpd_silence", action="store_true",
                   help="word-position-dependent silence: distinct pdf "
                        "block for utterance-boundary silence")

    d = sub.add_parser("decode", help="decode loglikes ark over a graph")
    d.add_argument("graph_dir")
    d.add_argument("loglikes", help="ark of (T, num_pdfs) log-likelihoods "
                                    "(cli/dump_outputs.py output)")
    d.add_argument("out", help="output hypothesis text file")
    d.add_argument("--acoustic_scale", type=float, default=0.1)
    d.add_argument("--beam", type=float, default=16.0)
    d.add_argument("--max_active", type=int, default=7000)
    d.add_argument("--num_threads", type=int, default=1,
                   help="parallel decode workers (the latgen-faster-"
                        "mapped-parallel --num-threads analogue; the C++ "
                        "search releases the GIL)")
    d.add_argument("--nbest", type=int, default=1,
                   help=">1 enables N-best decoding (+ LM rescoring if "
                        "--rescore_lm_dir is given)")
    d.add_argument("--rescore_arpa",
                   help="ARPA LM the graph was built from (required for "
                        "rescoring: its score is removed exactly)")
    d.add_argument("--rescore_lm_dir",
                   help="train_lm RNNLM checkpoint dir used to rescore "
                        "the N-best (lattice-rescoring equivalent)")
    d.add_argument("--rescore_weight", type=float, default=1.0)
    d.add_argument("--device", default="cuda",
                   help="(--rescore_lm_dir) the RNNLM's device: 'cuda' (default) or 'cpu'")
    d.add_argument("--ref_text", help="Kaldi text file for WER scoring")
    d.add_argument("--lattice_dir",
                   help="decode via lattices and write each utterance's "
                        "word lattice to <dir>/<utt>.lat.gz (the "
                        "latgen-faster-mapped lat.JOB.gz analogue); "
                        "rescoring then runs exactly on the lattice and "
                        "--ref_text also reports oracle WER")
    d.add_argument("--lattice_beam", type=float, default=8.0)
    d.add_argument("--consensus", action="store_true",
                   help="with --lattice_dir: decode each utterance by "
                        "confusion-network consensus over its own lattice "
                        "(the single-system MBR/sausage decode) instead "
                        "of the best path")

    c = sub.add_parser(
        "combine",
        help="posterior-fuse lattices of multiple systems "
             "(lattice-combine + sausage decode analogue)",
    )
    c.add_argument("out", help="output hypothesis text file")
    c.add_argument("--lattice_dirs", required=True,
                   help="comma list of decode --lattice_dir outputs")
    c.add_argument("--weights", help="comma per-system weights")
    c.add_argument("--words", required=True,
                   help="words.txt of the (shared) decode graph")
    c.add_argument("--ref_text")
    return p


def _build(args):
    from speech_recognition_tools_tpu_torch.decode.graph import (
        GraphConfig,
        build_decoding_graph,
    )
    from speech_recognition_tools_tpu_torch.models.ngram_lm import read_arpa

    lex = {}
    with open(args.lexicon) as f:
        for line in f:
            parts = line.split()
            if parts:
                lex[parts[0]] = [int(x) for x in parts[1:]]
    lm = read_arpa(args.arpa)
    g = build_decoding_graph(
        lm, lex,
        GraphConfig(
            states_per_phone=args.states_per_phone,
            self_loop_prob=args.self_loop_prob,
            silence_phone=args.silence_phone,
            silence_states=args.silence_states,
            wpd_silence=args.wpd_silence,
        ),
    )
    os.makedirs(args.graph_dir, exist_ok=True)
    g.write(os.path.join(args.graph_dir, "HCLG.txt"))
    g.write_words(os.path.join(args.graph_dir, "words.txt"))
    with open(os.path.join(args.graph_dir, "num_pdfs"), "w") as f:
        f.write(f"{g.num_pdfs}\n")
    print(
        f"built graph: {g.num_states} states, {len(g.arcs)} arcs, "
        f"{g.num_pdfs} pdfs -> {args.graph_dir}"
    )


def _decode(args):
    from speech_recognition_tools_tpu_torch.decode.wfst import WfstDecoder
    from speech_recognition_tools_tpu_torch.io.native import read_ark_native

    dec = WfstDecoder(os.path.join(args.graph_dir, "HCLG.txt"))
    id2w = {}
    with open(os.path.join(args.graph_dir, "words.txt")) as f:
        for line in f:
            w, i = line.split()
            id2w[int(i)] = w

    rescore = None
    old_lm = None
    rnnlm = None
    if args.consensus and args.rescore_arpa and args.lattice_dir:
        # one_lattice returns the rescored best path before reaching the
        # consensus branch; make the precedence loud instead of silent
        import sys

        print(
            "WARNING: --consensus is ignored when --rescore_arpa is given "
            "(exact lattice rescoring takes precedence and returns its "
            "best path); drop --rescore_arpa for the consensus decode",
            file=sys.stderr,
        )
    if args.rescore_arpa and (args.nbest > 1 or args.lattice_dir):
        from speech_recognition_tools_tpu_torch.decode.wfst import (
            rescore_nbest,
            rnnlm_sequence_scorer,
        )
        from speech_recognition_tools_tpu_torch.models.ngram_lm import read_arpa

        old_lm = read_arpa(args.rescore_arpa)
        scorer = None
        if args.rescore_lm_dir:
            from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load_lm
            from speech_recognition_tools_tpu_torch.io.text import load_vocab

            rnnlm = _load_lm(args.rescore_lm_dir, device=args.device)
            lm_vocab = load_vocab(
                os.path.join(args.rescore_lm_dir, "vocab.json")
            )
            scorer = rnnlm_sequence_scorer(rnnlm, lm_vocab)

        def rescore(hyps):
            return rescore_nbest(
                hyps, id2w, old_lm, scorer,
                new_weight=args.rescore_weight,
            )

    lattices = {}
    if args.lattice_dir:
        os.makedirs(args.lattice_dir, exist_ok=True)

        from speech_recognition_tools_tpu_torch.decode.lattice import (
            decode_lattice,
            write_lattice,
        )

    def one_lattice(key, ll):
        lat = decode_lattice(
            dec, ll, acoustic_scale=args.acoustic_scale, beam=args.beam,
            max_active=args.max_active, lattice_beam=args.lattice_beam,
        )
        wl = lat.word_lattice()
        write_lattice(
            wl, os.path.join(args.lattice_dir, f"{key}.lat.gz")
        )
        if args.ref_text:
            # only oracle-WER needs the lattice after it is on disk;
            # keep decode memory flat otherwise
            lattices[key] = wl
        if old_lm is not None:
            # exact lattice rescoring (every path, not an N-best cut)
            new_scorer = None
            if rnnlm is not None:
                from speech_recognition_tools_tpu_torch.decode.wfst import (
                    rnnlm_conditional_scorer,
                )

                new_scorer = rnnlm_conditional_scorer(rnnlm, lm_vocab)
            return lat.rescore(
                id2w, old_lm, new_scorer=new_scorer,
                new_weight=args.rescore_weight,
            )
        if args.consensus:
            from speech_recognition_tools_tpu_torch.decode.lattice import (
                cn_combine,
            )

            # single-lattice confusion-network consensus = the MBR-style
            # expected-WER decode lattices enable beyond Viterbi
            return cn_combine([wl]), lat.best_path()[1]
        return lat.best_path()

    def one(item):
        key, ll = item
        try:
            if args.lattice_dir:
                ids, cost = one_lattice(key, ll)
            elif args.nbest > 1:
                hyps_n = dec.decode_nbest(
                    ll, nbest=args.nbest,
                    acoustic_scale=args.acoustic_scale,
                    beam=args.beam, max_active=args.max_active,
                )
                if rescore is not None:
                    hyps_n = rescore(hyps_n)
                ids, cost = hyps_n[0]
            else:
                ids, cost = dec.decode(
                    ll, acoustic_scale=args.acoustic_scale,
                    beam=args.beam, max_active=args.max_active,
                )
        except (RuntimeError, ValueError) as e:
            # Kaldi's latgen warns and moves on when an utterance falls off
            # the beam (RuntimeError from the C++ core); lattice rescoring
            # can also prune away every path (ValueError). Aborting the
            # whole run on one hard utterance would lose every other
            # hypothesis.
            print(f"WARNING: {key}: decode failed ({e}); "
                  "emitting empty hypothesis")
            return key, "", float("inf")
        return key, " ".join(id2w[i] for i in ids), cost

    hyps = {}
    with open(args.out, "w") as out:
        if args.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(args.num_threads) as pool:
                results = pool.map(one, read_ark_native(args.loglikes))
                for key, hyp, cost in results:
                    hyps[key] = hyp
                    out.write(f"{key} {hyp}\n")
                    print(f"{key}: {hyp} (cost {cost:.1f})")
        else:
            for item in read_ark_native(args.loglikes):
                key, hyp, cost = one(item)
                hyps[key] = hyp
                out.write(f"{key} {hyp}\n")
                print(f"{key}: {hyp} (cost {cost:.1f})")

    if args.ref_text:
        from speech_recognition_tools_tpu_torch.eval.wer import score_hypotheses

        refs = {}
        with open(args.ref_text) as f:
            for line in f:
                parts = line.split(maxsplit=1)
                refs[parts[0]] = (
                    parts[1].split() if len(parts) > 1 else []
                )
        wer, _per_utt = score_hypotheses(
            refs, {k: v.split() for k, v in hyps.items()}
        )
        print(f"WER: {wer:.2f}%")
        if lattices:
            w2i = {w: i for i, w in id2w.items()}
            oerr = otot = 0
            for k, lat in lattices.items():
                if k not in refs:
                    continue
                # OOV reference words map to -1: never matched by any
                # lattice word, so they count as errors (Kaldi
                # lattice-oracle semantics) instead of being dropped
                ref_ids = [w2i.get(w, -1) for w in refs[k]]
                e, n, _ = lat.oracle_wer(ref_ids)
                oerr += e
                otot += n
            if otot:
                print(f"lattice oracle WER: {100.0 * oerr / otot:.2f}%")


def _combine(args):
    import glob

    from speech_recognition_tools_tpu_torch.decode.lattice import (
        cn_combine,
        read_lattice,
    )

    dirs = args.lattice_dirs.split(",")
    weights = (
        [float(x) for x in args.weights.split(",")]
        if args.weights else [1.0] * len(dirs)
    )
    id2w = {}
    with open(args.words) as f:
        for line in f:
            w, i = line.split()
            id2w[int(i)] = w
    keys = sorted({
        os.path.basename(p)[: -len(".lat.gz")]
        for d in dirs
        for p in glob.glob(os.path.join(d, "*.lat.gz"))
    })
    hyps = {}
    with open(args.out, "w") as out:
        for k in keys:
            lats, wts = [], []
            for d, w in zip(dirs, weights):
                p = os.path.join(d, f"{k}.lat.gz")
                if os.path.exists(p):
                    lats.append(read_lattice(p))
                    wts.append(w)
            if not lats:
                continue
            ids = cn_combine(lats, wts)
            hyps[k] = " ".join(id2w[i] for i in ids)
            out.write(f"{k} {hyps[k]}\n")
            print(f"{k}: {hyps[k]}")
    if args.ref_text:
        from speech_recognition_tools_tpu_torch.eval.wer import score_hypotheses

        refs = {}
        with open(args.ref_text) as f:
            for line in f:
                parts = line.split(maxsplit=1)
                refs[parts[0]] = (
                    parts[1].split() if len(parts) > 1 else []
                )
        wer, _ = score_hypotheses(
            refs, {k: v.split() for k, v in hyps.items()}
        )
        print(f"combined WER: {wer:.2f}%")


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.cmd == "build-graph":
        _build(args)
    elif args.cmd == "combine":
        _combine(args)
    else:
        _decode(args)


if __name__ == "__main__":
    main()
