"""The port's hybrid decode end held against the JAX package:
`cli/compute_prior.py` (and `infer/posteriors.py`'s prior), the Kaldi
ark/scp readers and writers, `cli/dump_outputs.py --arch rnn` with
`decode/export.py`, `decode/viterbi.py`, `models/ngram_lm.py` with
`cli/train_ngram.py`, `decode/graph.py`, the native decoder
(`io/native.py`, `decode/wfst.py`), `decode/lattice.py` and
`cli/decode_wfst.py` (build-graph, decode in every mode, combine).

Both sides get the same files: egs, checkpoints, arks, texts, lexicons
and graphs. Output files must be identical (ARPA files compared after
gunzip: gzip stamps the time), log-likelihoods within 1e-5. The tiny
graphs are those of tests/test_wfst_decode.py and tests/test_lattice.py,
built here. The JAX side runs on the CPU with the conftest's x64; the port
runs on the CPU.
"""

import gzip
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.cli import compute_prior as jcompute_prior
from speech_recognition_tools_tpu.cli import decode_wfst as jdecode_wfst
from speech_recognition_tools_tpu.cli import dump_outputs as jdump
from speech_recognition_tools_tpu.cli import train_am as jtrain_am
from speech_recognition_tools_tpu.cli import train_ngram as jtrain_ngram
from speech_recognition_tools_tpu.decode import lattice as jlattice
from speech_recognition_tools_tpu.decode import viterbi as jviterbi
from speech_recognition_tools_tpu.decode import wfst as jwfst
from speech_recognition_tools_tpu.decode.graph import GraphConfig as JGraphConfig
from speech_recognition_tools_tpu.decode.graph import build_decoding_graph as jbuild
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.io import kaldi_ark as jark
from speech_recognition_tools_tpu.io import scp as jscp
from speech_recognition_tools_tpu.models import ngram_lm as jngram
from speech_recognition_tools_tpu_torch.cli import compute_prior, decode_wfst, dump_outputs
from speech_recognition_tools_tpu_torch.cli import train_lm, train_ngram
from speech_recognition_tools_tpu_torch.decode import lattice as tlattice
from speech_recognition_tools_tpu_torch.decode import viterbi as tviterbi
from speech_recognition_tools_tpu_torch.decode import wfst as twfst
from speech_recognition_tools_tpu_torch.decode.export import export_loglikes_ark
from speech_recognition_tools_tpu_torch.decode.graph import GraphConfig, build_decoding_graph
from speech_recognition_tools_tpu_torch.io import kaldi_ark as tark
from speech_recognition_tools_tpu_torch.io import scp as tscp
from speech_recognition_tools_tpu_torch.models import ngram_lm as tngram

torch.set_num_threads(1)

LEX = {"go": [0], "stop": [1, 2], "left": [3], "right": [4, 0]}
SENTS = [
    "go stop".split(), "go left".split(), "stop go".split(),
    "right stop".split(), "go stop left".split(), "stop".split(),
    "left right go".split(), "go go stop".split(),
]
S = 2  # states per phone: 5 phones, 10 pdfs
D, CLASSES = 6, 10
TRUTH = {"u0": ["go", "stop"], "u1": ["left", "right"], "u2": ["stop", "go", "left"],
         "u3": ["right", "stop"]}


def _loglikes_for(words, num_pdfs, noise, rs, frames_per_state=3):
    """(T, P) log-likelihoods strongly favouring the pdf chain of `words`."""
    pdfs = [ph * S + st for w in words for ph in LEX[w] for st in range(S)
            for _ in range(frames_per_state)]
    ll = np.full((len(pdfs), num_pdfs), -10.0, np.float32)
    ll[np.arange(len(pdfs)), pdfs] = 0.0
    return ll + rs.randn(*ll.shape).astype(np.float32) * noise


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _lines(out, prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """text, lexicon, ARPA (order 2), graph dir (states_per_phone 2), a
    ref text, loglikes arks of two systems and a char RNNLM dir."""
    root = tmp_path_factory.mktemp("hybrid")
    text = root / "text"
    text.write_text("".join(f"s{i} {' '.join(s)}\n" for i, s in enumerate(SENTS)))
    lexicon = root / "lexicon.txt"
    lexicon.write_text("".join(f"{w} {' '.join(map(str, ps))}\n" for w, ps in LEX.items()))
    jtrain_ngram.main([str(text), str(root / "lm"), "--order", "2"])
    arpa = str(root / "lm" / "2gram.arpa.gz")
    gdir = str(root / "graph")
    jdecode_wfst.main(["build-graph", arpa, str(lexicon), gdir, "--states_per_phone", str(S)])
    ref = root / "ref"
    ref.write_text("".join(f"{k} {' '.join(v)}\n" for k, v in TRUTH.items()))
    arks = {}
    for sysid, noise, seed in (("A", 0.6, 1), ("B", 0.9, 2)):
        rs = np.random.RandomState(seed)
        arks[sysid] = jark.write_ark_scp(
            {k: _loglikes_for(v, CLASSES, noise, rs) for k, v in TRUTH.items()},
            str(root / f"ll{sysid}"))[0]
    lm_dir = str(root / "rnnlm")
    train_lm.main([str(text), lm_dir, "--embed_dim", "8", "--hidden", "16", "--epochs", "1",
                   "--batch_size", "4", "--device", "cpu"])
    return dict(root=root, text=str(text), lexicon=str(lexicon), arpa=arpa, graph=gdir,
                ref=str(ref), arks=arks, lm_dir=lm_dir)


@pytest.fixture(scope="module")
def am(tmp_path_factory):
    """An egs dir with frame labels and a JAX train_am --arch rnn
    checkpoint trained on it for one epoch."""
    root = tmp_path_factory.mktemp("am")
    rs = np.random.RandomState(3)
    utts = [(f"u{i}", rs.randn(T, D).astype(np.float32)) for i, T in enumerate((23, 9, 17, 30))]
    labels = {k: rs.randint(0, CLASSES, f.shape[0]) for k, f in utts}
    labels["u1"][:] = 1  # class 0 is never seen in u1, some classes maybe never
    egs = str(root / "egs")
    jegs.build_egs(iter(utts), egs, labels, num_targets=CLASSES)
    store = str(root / "exp")
    jtrain_am.main([egs, store, "--arch", "rnn", "--num_layers", "2", "--hidden_dim", "12",
                    "--epochs", "1", "--batch_size", "2"])
    return dict(egs=egs, store=store, labels=labels)


# ------------------------------------------------------------------ priors


@pytest.mark.parametrize("source", ["egs", "binary-pdf", "text-pdf", "binary-phone"])
def test_log_prior_pickles_match_jax(am, tmp_path, source):
    """compute_prior from an egs dir and from alignment arks (binary, text;
    --ali_type pdf and phone): the pickled log-priors are byte-identical."""
    if source == "egs":
        src, extra = am["egs"], []
    else:
        kind, ali_type = source.split("-")
        src = str(tmp_path / "ali.ark")
        shift = 1 if ali_type == "phone" else 0  # ali-to-phones ids are 1-based
        jark.write_vec_int_ark({k: v + shift for k, v in am["labels"].items()}, src,
                               binary=kind == "binary")
        extra = ["--ali_type", ali_type]
    outs = []
    for name, main in (("port", compute_prior.main), ("jax", jcompute_prior.main)):
        outs.append(str(tmp_path / f"{name}.pkl"))
        main([src, outs[-1], "--num_classes", str(CLASSES), *extra])
    assert _read(outs[0], "rb") == _read(outs[1], "rb")
    with open(outs[0], "rb") as f:
        prior = pickle.load(f)
    assert prior.shape == (CLASSES,) and np.isfinite(prior).any()


# ------------------------------------------------------------------ ark / scp


def test_ark_and_scp_readers_read_the_other_packages_writers(tmp_path):
    """Float32 and float64 matrices through write_ark_scp -> read_ark /
    read_mat_scp / read_scp_entry, each package reading the other's files
    (identical bytes from both writers); int vectors through
    write_vec_int_ark (binary and text) -> read_vec_int_ark both ways; a
    hand-written text matrix ark; write_scp."""
    rs = np.random.RandomState(0)
    mats = {"a": rs.randn(3, 4).astype(np.float32), "b": rs.randn(5, 4),
            "c": rs.randn(1, 2).astype(np.float32)}
    (ta, ts), (ja, js) = (tark.write_ark_scp(mats, str(tmp_path / "t")),
                          jark.write_ark_scp(mats, str(tmp_path / "j")))
    assert _read(ta, "rb") == _read(ja, "rb")
    for reader, ark, scp in ((tark, ja, js), (jark, ta, ts)):
        got = dict(reader.read_ark(ark))
        assert list(got) == list(mats)
        for k, m in mats.items():
            assert got[k].dtype == m.dtype and np.array_equal(got[k], m)
        assert all(np.array_equal(m, mats[k]) for k, m in reader.read_mat_scp(scp))
    for binary in (True, False):
        vecs = {"x": rs.randint(0, 50, 7), "y": rs.randint(0, 50, 1), "z": np.zeros(0, int)}
        tp, jp = str(tmp_path / f"t{binary}.ali"), str(tmp_path / f"j{binary}.ali")
        tark.write_vec_int_ark(vecs, tp, binary=binary)
        jark.write_vec_int_ark(vecs, jp, binary=binary)
        assert _read(tp, "rb") == _read(jp, "rb")
        for got in (dict(tark.read_vec_int_ark(jp)), dict(jark.read_vec_int_ark(tp))):
            assert set(got) == set(vecs)
            assert all(got[k].dtype == np.int32 and np.array_equal(got[k], v)
                       for k, v in vecs.items())
    txt = tmp_path / "text.ark"
    txt.write_text("m1  [\n  1.5 2 3\n  4 5 6 ]")
    got, want = list(tark.read_ark(str(txt))), list(jark.read_ark(str(txt)))
    assert [k for k, _ in got] == [k for k, _ in want] == ["m1"] and got[0][1].shape == (2, 3)
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    entries = [("u1", "/a/b.wav"), ("u2", "sox x.wav -t wav - |")]
    tscp.write_scp(entries, str(tmp_path / "t.scp"))
    jscp.write_scp(entries, str(tmp_path / "j.scp"))
    assert _read(tmp_path / "t.scp") == _read(tmp_path / "j.scp")
    assert tscp.read_scp(str(tmp_path / "t.scp")) == entries


# ------------------------------------------------------------------ dump_outputs


@pytest.mark.parametrize("mode", ["prior", "add_softmax", "logits"])
def test_dump_outputs_matches_jax(am, tmp_path, mode):
    """dump_outputs on the JAX train_am checkpoint, batch 3 (ragged padded
    batches): the same keys and shapes, values within 1e-5 of the JAX
    CLI's, with --prior (from compute_prior) at --prior_weight 0.8,
    --add_softmax, or the raw logits."""
    extra = []
    if mode == "prior":
        prior = str(tmp_path / "prior.pkl")
        compute_prior.main([am["egs"], prior, "--num_classes", str(CLASSES)])
        extra = ["--prior", prior, "--prior_weight", "0.8"]
    elif mode == "add_softmax":
        extra = ["--add_softmax"]
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    dump_outputs.main([am["store"], am["egs"], tout, "--batch_size", "3", *extra,
                       "--device", "cpu"])
    jdump.main([am["store"], am["egs"], jout, "--batch_size", "3", *extra])
    got, want = dict(tark.read_ark(tout + ".ark")), dict(jark.read_ark(jout + ".ark"))
    assert list(got) == list(want) and len(got) == 4
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[1] == CLASSES
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    if mode == "add_softmax":
        np.testing.assert_allclose(got["u0"].sum(1), 1.0, rtol=1e-5)


def test_export_loglikes_ark_is_dump_outputs(am, tmp_path):
    """decode/export.py over the checkpoint's model writes the ark that
    dump_outputs --prior writes."""
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches

    prior = str(tmp_path / "prior.pkl")
    compute_prior.main([am["egs"], prior, "--num_classes", str(CLASSES)])
    with open(prior, "rb") as f:
        log_prior = pickle.load(f)
    model, _, _ = dump_outputs.load_model_from_checkpoint(am["store"], device="cpu")

    def apply(feats, lengths):
        return model(torch.as_tensor(feats), torch.as_tensor(lengths))

    ark, scp = export_loglikes_ark(apply, iter_egs_batches(am["egs"], 3),
                                   str(tmp_path / "exp"), log_prior, 0.8)
    dump_outputs.main([am["store"], am["egs"], str(tmp_path / "dump"), "--batch_size", "3",
                       "--prior", prior, "--device", "cpu"])
    assert _read(ark, "rb") == _read(tmp_path / "dump.ark", "rb")
    assert os.path.exists(scp)


def test_dump_outputs_refuses_what_is_not_ported(am, tmp_path):
    import json
    import shutil

    with pytest.raises(IndexError):
        dump_outputs.main([am["store"], am["egs"], str(tmp_path / "o"), "--layer", "1",
                           "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 1"):
        dump_outputs.main([am["store"], am["egs"], str(tmp_path / "o"),
                           "--multi_egs_dirs", "x", "--device", "cpu"])
    other = str(tmp_path / "cnn")
    shutil.copytree(os.path.join(am["store"], "final"), os.path.join(other, "final"))
    cfg_path = os.path.join(other, "final", "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, arch="cnn"), f)
    with pytest.raises(NotImplementedError, match="item 1"):
        dump_outputs.main([other, am["egs"], str(tmp_path / "o"), "--device", "cpu"])


# ------------------------------------------------------------------ viterbi


@pytest.mark.parametrize("ragged,init", [(False, False), (True, False), (True, True)])
def test_viterbi_and_greedy_match_jax(ragged, init):
    """B = 3, T = 17, S = 6 with forbidden transitions (-inf) and exact
    ties: paths identical to the JAX scans' (-1 past each length), scores
    within 1e-5; greedy_decode and collapse_repeats identical."""
    rs = np.random.RandomState(5)
    ll = np.log(rs.dirichlet(np.ones(6), size=(3, 17))).astype(np.float32)
    ll[1, 4:8] = ll[1, 3]  # repeated frames: ties in the argmax chains
    trans = np.log(rs.dirichlet(np.ones(6), size=6)).astype(np.float32)
    trans[0, 3] = trans[2, 5] = -np.inf
    lens = np.array([17, 11, 1], np.int32) if ragged else None
    log_init = np.log(rs.dirichlet(np.ones(6))).astype(np.float32) if init else None
    jp, js = jviterbi.viterbi_decode(jnp.asarray(ll), jnp.asarray(trans),
                                     None if log_init is None else jnp.asarray(log_init),
                                     None if lens is None else jnp.asarray(lens))
    tp, ts = tviterbi.viterbi_decode(torch.as_tensor(ll), torch.as_tensor(trans),
                                     None if log_init is None else torch.as_tensor(log_init),
                                     None if lens is None else torch.as_tensor(lens))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    tg = tviterbi.greedy_decode(torch.as_tensor(ll), None if lens is None else
                                torch.as_tensor(lens))
    jg = jviterbi.greedy_decode(jnp.asarray(ll), None if lens is None else jnp.asarray(lens))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for b in range(3):
        assert tviterbi.collapse_repeats(tg[b]) == jviterbi.collapse_repeats(np.asarray(jg[b]))
        assert tviterbi.collapse_repeats(tp[b]) == jviterbi.collapse_repeats(np.asarray(jp[b]))


# ------------------------------------------------------------------ n-gram and graph


def test_train_ngram_matches_jax(tmp_path, capsys):
    """train_ngram (order 3, a lexicon that maps one word to <unk>, 2
    held-out sentences): the ARPA text (after gunzip), word.counts and the
    printed perplexity identical; both packages read either ARPA to the
    same model."""
    text = tmp_path / "text"
    sents = SENTS + [["go", "jump"], ["stop", "right", "left", "go"]]
    text.write_text("".join(f"s{i} {' '.join(s)}\n" for i, s in enumerate(sents)))
    lexicon = tmp_path / "lexicon.txt"
    lexicon.write_text("".join(f"{w} {' '.join(map(str, ps))}\n" for w, ps in LEX.items())
                       + "!SIL 5\n")
    outs = {}
    for name, main in (("port", train_ngram.main), ("jax", jtrain_ngram.main)):
        d = tmp_path / name
        main([str(text), str(d), "--order", "3", "--lexicon", str(lexicon), "--heldout", "2"])
        with gzip.open(d / "3gram.arpa.gz", "rt") as f:
            printed = capsys.readouterr().out.replace(str(d), "<out_dir>")
            outs[name] = (f.read(), _read(d / "word.counts"), printed)
    assert outs["port"] == outs["jax"]
    assert "<unk>" in outs["port"][1] and "perplexity" in outs["port"][2]
    tlm = tngram.read_arpa(str(tmp_path / "jax" / "3gram.arpa.gz"))
    jlm = jngram.read_arpa(str(tmp_path / "port" / "3gram.arpa.gz"))
    assert tlm.logprob == jlm.logprob and tlm.backoff == jlm.backoff and tlm.order == 3
    assert tlm.perplexity(sents) == jlm.perplexity(sents)


@pytest.mark.parametrize("extra", [
    ["--states_per_phone", "1"],
    ["--states_per_phone", "2", "--silence_phone", "5", "--self_loop_prob", "0.3"],
    ["--states_per_phone", "3", "--silence_phone", "5", "--silence_states", "5",
     "--wpd_silence"],
])
def test_build_graph_matches_jax(corpus, tmp_path, extra):
    """decode_wfst build-graph: HCLG.txt, words.txt and num_pdfs
    byte-identical to the JAX CLI's, plain and with the silence topologies;
    build_decoding_graph gives the same arcs from the port's own n-gram."""
    outs = []
    for name, main in (("port", decode_wfst.main), ("jax", jdecode_wfst.main)):
        d = str(tmp_path / name)
        main(["build-graph", corpus["arpa"], corpus["lexicon"], d, *extra])
        outs.append([_read(os.path.join(d, f)) for f in ("HCLG.txt", "words.txt", "num_pdfs")])
    assert outs[0] == outs[1] and len(outs[0][0].splitlines()) > 20
    lm = tngram.train_ngram_lm(SENTS, order=2)
    g = build_decoding_graph(lm, LEX, GraphConfig(states_per_phone=2, silence_phone=5))
    jg = jbuild(jngram.train_ngram_lm(SENTS, order=2), LEX,
                JGraphConfig(states_per_phone=2, silence_phone=5))
    assert g.arcs == jg.arcs and g.finals == jg.finals and g.num_pdfs == jg.num_pdfs


# ------------------------------------------------------------------ decoders


def test_native_decoder_and_lattices_match_jax(corpus):
    """On the graph and both systems' loglikes: WfstDecoder.decode /
    decode_nbest (acoustic scale 1.0 and 0.1) and decode_py give the JAX
    package's words and costs; decode_lattice (scale 1.0) gives lattices
    with the same nodes, links and finals, the same best path, N-best, word
    lattice, oracle WER, posteriors and rescoring (with the graph's own LM
    and, on the first utterance, with an RNNLM conditional scorer); N-best
    rescoring with the RNNLM's sequence scorer ranks and costs alike."""
    hclg = os.path.join(corpus["graph"], "HCLG.txt")
    tdec, jdec = twfst.WfstDecoder(hclg), jwfst.WfstDecoder(hclg)
    assert (tdec.num_states, tdec.num_arcs) == (jdec.num_states, jdec.num_arcs)
    id2w = {}
    for line in _read(os.path.join(corpus["graph"], "words.txt")).splitlines():
        w, i = line.split()
        id2w[int(i)] = w
    w2i = {w: i for i, w in id2w.items()}
    old = tngram.read_arpa(corpus["arpa"])
    jold = jngram.read_arpa(corpus["arpa"])
    from speech_recognition_tools_tpu.cli.recog_e2e import _load_lm as jload_lm
    from speech_recognition_tools_tpu.io.text import load_vocab
    from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load_lm

    vocab = load_vocab(os.path.join(corpus["lm_dir"], "vocab.json"))
    trnn = _load_lm(corpus["lm_dir"], device="cpu")
    jrnn = jload_lm(corpus["lm_dir"])
    checked = 0
    for ark in corpus["arks"].values():
        for key, ll in jark.read_ark(ark):
            for scale in (1.0, 0.1):
                kw = dict(acoustic_scale=scale, beam=100.0, max_active=7000)
                assert tdec.decode(ll, **kw) == jdec.decode(ll, **kw)
                assert tdec.decode_nbest(ll, 5, **kw) == jdec.decode_nbest(ll, 5, **kw)
            tl = tlattice.decode_lattice(tdec, ll, 1.0, 100.0, 7000, 6.0)
            jl = jlattice.decode_lattice(jdec, ll, 1.0, 100.0, 7000, 6.0)
            for f in ("frames", "link_from", "link_to", "link_olabel", "link_graph", "link_ac"):
                np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
            assert tl.finals == jl.finals and tl.best_cost == jl.best_cost
            assert tl.num_links > tl.num_nodes > 1
            assert tl.best_path() == jl.best_path()
            assert tl.nbest(4) == jl.nbest(4)
            twl, jwl = tl.word_lattice(), jl.word_lattice()
            assert (twl.num_nodes, twl.num_links) == (jwl.num_nodes, jwl.num_links)
            ref = [w2i[w] for w in TRUTH[key]]
            assert tl.oracle_wer(ref) == jl.oracle_wer(ref)
            np.testing.assert_array_equal(tl.posteriors(), jl.posteriors())
            assert tlattice.cn_combine([twl]) == jlattice.cn_combine([jwl])
            assert tl.rescore(id2w, old) == jl.rescore(id2w, jold)
            if checked == 0:  # the JAX scorer compiles once per prefix length
                got = tl.rescore(id2w, old, twfst.rnnlm_conditional_scorer(trnn, vocab),
                                 new_weight=0.5)
                want = jl.rescore(id2w, jold, jwfst.rnnlm_conditional_scorer(*jrnn, vocab),
                                  new_weight=0.5)
                assert got[0] == want[0] and abs(got[1] - want[1]) < 1e-4
            checked += 1
            hyps = tdec.decode_nbest(ll, 4, acoustic_scale=1.0, beam=100.0)
            t_seq = twfst.rnnlm_sequence_scorer(trnn, vocab)
            j_seq = jwfst.rnnlm_sequence_scorer(*jrnn, vocab)
            got = twfst.rescore_nbest(hyps, id2w, old, t_seq, new_weight=0.5)
            want = jwfst.rescore_nbest(hyps, id2w, jold, j_seq, new_weight=0.5)
            assert [h for h, _ in got] == [h for h, _ in want]
            np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=1e-4)
        assert twfst.decode_py(hclg, ll, 0.5) == jwfst.decode_py(hclg, ll, 0.5)
    assert checked == 8


@pytest.mark.parametrize("mode", ["onebest", "threads", "nbest_arpa", "nbest_rnnlm",
                                  "lattice_consensus", "lattice_rescore"])
def test_decode_wfst_cli_matches_jax(corpus, tmp_path, capsys, mode):
    """decode_wfst decode on both systems' arks: the hypothesis files and
    the printed WER and lattice-oracle WER lines identical to the JAX
    CLI's; the written lattices read back to the same lattices."""
    extra = {
        "onebest": [],
        "threads": ["--num_threads", "3"],
        "nbest_arpa": ["--nbest", "4", "--rescore_arpa", corpus["arpa"]],
        "nbest_rnnlm": ["--nbest", "4", "--rescore_arpa", corpus["arpa"],
                        "--rescore_lm_dir", corpus["lm_dir"], "--rescore_weight", "0.5"],
        "lattice_consensus": ["--lattice_beam", "10", "--consensus"],
        "lattice_rescore": ["--rescore_arpa", corpus["arpa"], "--rescore_lm_dir",
                            corpus["lm_dir"]],
    }[mode]
    lattice = mode.startswith("lattice")
    for sysid, ark in corpus["arks"].items():
        outs = {}
        for name, main, dev in (("port", decode_wfst.main, ["--device", "cpu"]),
                                ("jax", jdecode_wfst.main, [])):
            out = str(tmp_path / f"{name}{sysid}.txt")
            lats = ["--lattice_dir", str(tmp_path / f"lat_{name}{sysid}")] if lattice else []
            port_dev = dev if "--rescore_lm_dir" in extra else []
            main(["decode", corpus["graph"], ark, out, "--acoustic_scale", "1.0",
                  "--beam", "100", "--ref_text", corpus["ref"], *extra, *lats, *port_dev])
            printed = capsys.readouterr().out
            outs[name] = (_read(out), _lines(printed, ("WER", "lattice oracle WER")))
        assert outs["port"] == outs["jax"]
        assert len(outs["port"][0].splitlines()) == len(TRUTH)
        assert len(outs["port"][1]) == (2 if lattice else 1)
        if lattice:
            for key in TRUTH:
                t = tlattice.read_lattice(str(tmp_path / f"lat_port{sysid}" / f"{key}.lat.gz"))
                j = jlattice.read_lattice(str(tmp_path / f"lat_jax{sysid}" / f"{key}.lat.gz"))
                assert (t.num_nodes, t.num_links, t.finals) == (j.num_nodes, j.num_links,
                                                                j.finals)
                assert t.best_path() == j.best_path()


def test_combine_matches_jax(corpus, tmp_path, capsys):
    """decode_wfst combine over both systems' lattice dirs (written by the
    port's decode), weighted: the fused hypotheses and combined WER line
    identical to the JAX CLI's."""
    dirs = []
    for sysid, ark in corpus["arks"].items():
        dirs.append(str(tmp_path / f"lat{sysid}"))
        decode_wfst.main(["decode", corpus["graph"], ark, str(tmp_path / f"h{sysid}.txt"),
                          "--acoustic_scale", "1.0", "--beam", "100", "--lattice_dir", dirs[-1],
                          "--lattice_beam", "10"])
    capsys.readouterr()
    outs = {}
    for name, main in (("port", decode_wfst.main), ("jax", jdecode_wfst.main)):
        out = str(tmp_path / f"{name}.txt")
        main(["combine", out, "--lattice_dirs", ",".join(dirs), "--weights", "0.6,0.4",
              "--words", os.path.join(corpus["graph"], "words.txt"), "--ref_text",
              corpus["ref"]])
        outs[name] = (_read(out), _lines(capsys.readouterr().out, "combined WER"))
    assert outs["port"] == outs["jax"] and len(outs["port"][1]) == 1
    assert len(outs["port"][0].splitlines()) == len(TRUTH)


def test_default_device_raises_without_a_card(am, corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        dump_outputs.main([am["store"], am["egs"], str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="cuda"):
        decode_wfst.main(["decode", corpus["graph"], corpus["arks"]["A"],
                          str(tmp_path / "h.txt"), "--nbest", "2", "--rescore_arpa",
                          corpus["arpa"], "--rescore_lm_dir", corpus["lm_dir"]])
