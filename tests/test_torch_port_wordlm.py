"""The port's look-ahead word LM held against the JAX package: the word list
reader and the lexical tree, `LookaheadWordLM` rows (GRU and LSTM word
LMs), the word vocabulary and batches of `train_lm --unit word`, resume
across packages, and `recog_e2e --word_lm_dir` offline and `--streaming`.

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise, carried over by io/jax_params.py). The JAX
side runs on the CPU with the conftest's x64; the port runs on the CPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.cli import train_lm as jtrain_lm
from speech_recognition_tools_tpu.decode import wordlm as jwordlm
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.cli import train_lm
from speech_recognition_tools_tpu_torch.decode import LookaheadWordLM
from speech_recognition_tools_tpu_torch.decode import wordlm as twordlm
from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_batched
from speech_recognition_tools_tpu_torch.io import text as ttext
from speech_recognition_tools_tpu_torch.io.jax_params import rnnlm_from_jax
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM

torch.set_num_threads(1)

CVOCAB = jtext.build_char_vocab(["ab cab d"])  # blank 0 unk 1 space 2 a b c d, eos 7
A, B, C, DD = (CVOCAB[c] for c in "abcd")
SP, EOS = CVOCAB["<space>"], CVOCAB["<sos/eos>"]
# 'xyz' is not spellable in the char vocabulary and stays out of the tree
WVOCAB = {"<eos>": 0, "<unk>": 1, "ab": 2, "cab": 3, "d": 4, "a": 5, "bad": 6, "xyz": 7}
D = 8


def _word_lm(cell="gru", seed=1, V=len(WVOCAB)):
    """(jax RNNLM, perturbed params, the port's RNNLM on them)."""
    model = jrnnlm.RNNLM(vocab_size=V, embed_dim=8, hidden=16, layers=1, cell=cell)
    params = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, 3), jnp.int32))
    rs = np.random.RandomState(seed + 50)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rs.randn(*a.shape)).astype(np.float32), params)
    port = RNNLM(V, 8, 16, 1, cell, device="cpu")
    port.load_state_dict(rnnlm_from_jax(params))
    return model, params, port.eval()


def _walk(jn, tn):
    assert tn.wid == jn.wid and np.array_equal(tn.ids, jn.ids)
    assert sorted(tn.children) == sorted(jn.children)
    for c in jn.children:
        _walk(jn.children[c], tn.children[c])


def test_lexical_tree_matches_jax():
    """Every node's sorted word ids, terminal word id and children equal
    JAX's; unspellable and special entries are skipped by both."""
    jroot = jwordlm.make_lexical_tree(WVOCAB, CVOCAB)
    troot = twordlm.make_lexical_tree(WVOCAB, CVOCAB)
    _walk(jroot, troot)
    assert list(troot.ids) == [2, 3, 4, 5, 6]
    assert troot.children[A].wid == 5 and troot.children[A].children[B].wid == 2


def _prefix_batches():
    """Batches of equal-width prefixes (sos first; eos ends the parse)."""
    return [
        [[EOS], [EOS], [EOS]],
        [[EOS, A], [EOS, C], [EOS, DD]],  # in-tree, terminal 'a' and 'd'
        [[EOS, A, B, SP], [EOS, C, A, B], [EOS, B, A, DD]],  # closed word, terminals
        [[EOS, DD, DD, SP], [EOS, A, A, A], [EOS, C, C, A]],  # OOV closes, OOV mode
        [[EOS, A, B, SP, C, A, B, SP, DD], [EOS, A, SP, B, A, DD, SP, A, B],
         [EOS, A, B, EOS, EOS, EOS, EOS, EOS, EOS]],  # longer histories, eos
        [[EOS, DD, SP, DD, SP, DD, SP, A, SP, DD, SP, A, B, SP, C, A, B, B]],
    ]


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_lookahead_rows_match_jax(cell):
    """LookaheadWordLM rows against JAX's on the same word LM (perturbed
    weights) over in-tree, terminal, OOV-mode, closed-word and eos
    prefixes, at two oov penalties: the NEG (-1e30) entries identical, the
    rest within atol 1e-5."""
    jm, jp, port = _word_lm(cell)
    for pen in (1e-4, 0.05):
        js = jwordlm.LookaheadWordLM(jm, jp, WVOCAB, CVOCAB, oov_penalty=pen)
        ts = LookaheadWordLM(port, WVOCAB, CVOCAB, oov_penalty=pen)
        for batch in _prefix_batches():
            toks = np.asarray(batch, np.int32)
            want = np.asarray(js(toks))
            got = ts(torch.as_tensor(toks))
            assert got.shape == want.shape == (len(batch), len(CVOCAB))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got == twordlm.NEG, want == jwordlm.NEG)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        s = ts.stats
        assert s["misses"] > 0 and s["hits"] > 0 and s["host_s"] > 0 and s["device_s"] > 0


def test_lru_bound_and_char_convention_rejection():
    """With cache_size 3 the memo never holds more than 3 histories and an
    evicted history's row is recomputed identically; a char-convention
    map (it holds <blank>/<space>) and a map without <unk> are refused, as
    by JAX."""
    _, _, port = _word_lm()
    ts = LookaheadWordLM(port, WVOCAB, CVOCAB, cache_size=3)
    batches = _prefix_batches()
    first = [ts(np.asarray(b, np.int32)) for b in batches]
    assert len(ts._dist) <= 3
    for b, want in zip(batches, first):
        np.testing.assert_array_equal(ts(np.asarray(b, np.int32)), want)
        assert len(ts._dist) <= 3
    cport = RNNLM(len(CVOCAB), 4, 8, 1, device="cpu")
    with pytest.raises(ValueError, match="CHAR-convention"):
        LookaheadWordLM(cport, CVOCAB, CVOCAB)
    with pytest.raises(ValueError, match="<unk>"):
        LookaheadWordLM(port, {"<eos>": 0, "ab": 1}, CVOCAB)
    with pytest.raises(ValueError, match="spellable"):
        LookaheadWordLM(port, {"<eos>": 0, "<unk>": 1, "xyz": 2}, CVOCAB)


def test_word_vocab_from_dict_matches_jax(tmp_path):
    """word_vocab_from_dict: the same map (<eos> appended when absent) and
    the same errors (no <unk>, a malformed line, ids past the LM's rows)."""
    cases = {"ok": "<unk> 1\nab 2\n\ncab 3\n", "with_eos": "<eos> 0\n<unk> 1\nd 2\n",
             "nounk": "ab 1\n", "bad": "<unk> 1\nab 2 3\n"}
    for name, body in cases.items():
        f = tmp_path / f"{name}.txt"
        f.write_text(body)
        for n_vocab in (None, 3):
            outs = []
            for fn in (jwordlm.word_vocab_from_dict, twordlm.word_vocab_from_dict):
                try:
                    outs.append(fn(str(f), n_vocab=n_vocab))
                except ValueError as e:
                    outs.append(("error", str(e)))
            assert outs[0] == outs[1], (name, n_vocab)
    assert twordlm.word_vocab_from_dict(str(tmp_path / "ok.txt"))["<eos>"] == 4


def _texts(seed=0, n=9):
    """n word transcripts over a small vocabulary, some words rare."""
    rs = np.random.RandomState(seed)
    words = ["ab", "cab", "d", "a", "bad", "dab", "cc"]
    p = np.asarray([5, 4, 4, 3, 2, 1, 1], np.float64)
    return {f"u{i}": " ".join(words[j] for j in rs.choice(7, rs.randint(1, 7), p=p / p.sum()))
            for i in range(n)}


def _write_text(path, texts):
    with open(path, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return str(path)


def test_word_vocab_encode_and_batches_match_jax():
    """build_word_vocab (capped and not), encode_words and lm_batches(unit
    "word") equal JAX's: <eos> id 0 is both BOS and EOS; char batches are
    unchanged."""
    texts = _texts()
    for size in (5, 65000):
        v = ttext.build_word_vocab(texts.values(), size)
        assert v == jtext.build_word_vocab(texts.values(), size)
        for t in texts.values():
            assert ttext.encode_words(t + " zz", v) == jtext.encode_words(t + " zz", v)
        for seed in (None, 3):
            got = list(train_lm.lm_batches(texts, v, 4, 5, seed=seed, unit="word"))
            want = list(jtrain_lm.lm_batches(texts, v, 4, 5, seed=seed, unit="word"))
            assert len(got) == len(want)
            for (gt, gl), (wt, wl) in zip(got, want):
                np.testing.assert_array_equal(gt, wt)
                np.testing.assert_array_equal(gl, wl)
    toks, lens = next(train_lm.lm_batches(texts, v, 4, 16, unit="word"))
    assert toks[0, 0] == 0 and toks[0, lens[0] - 1] == 0


TINY = ["--embed_dim", "8", "--hidden", "16", "--batch_size", "4", "--bptt_len", "5",
        "--unit", "word", "--word_vocab_size", "6"]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_train_lm_word_resumes_from_the_others_epoch(tmp_path, capsys, first):
    """train_lm --unit word: one package trains epoch 1 (its final is then
    removed), the other resumes from epoch_1 to epoch 2; the same resume by
    the first package gives the same epoch-2 nll (rtol 1e-5). The word
    vocab.json is the JAX CLI's."""
    text = _write_text(tmp_path / "text", _texts())
    mains = {"jax": jtrain_lm.main, "port": lambda a: train_lm.main(a + ["--device", "cpu"])}
    second = "port" if first == "jax" else "jax"
    nll = {}
    for who in (second, first):
        store = str(tmp_path / f"resumed_by_{who}")
        mains[first]([text, store, *TINY, "--epochs", "1"])
        shutil.rmtree(os.path.join(store, "final"))
        with open(os.path.join(store, "vocab.json")) as f:
            assert json.load(f) == jtext.build_word_vocab(_texts().values(), 6)
        capsys.readouterr()
        mains[who]([text, store, *TINY, "--epochs", "2"])
        out = capsys.readouterr().out
        assert f"resumed from {store}/epoch_1 at epoch 1" in out, out
        line = [ln for ln in out.splitlines() if ln.startswith("epoch 2: nll")]
        assert len(line) == 1
        nll[who] = float(line[0].split()[3])
    np.testing.assert_allclose(nll[second], nll[first], rtol=1e-5)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A chunked-attention e2e model dir and a word LM dir (GRU, vocab.json
    = WVOCAB), both written by the JAX package, a word list file, and egs
    of two utterances."""
    root = tmp_path_factory.mktemp("wordlm")
    V = len(CVOCAB)
    hyper = dict(vocab_size=V, adim=16, aheads=2, elayers=2, eunits=32, dlayers=1, dunits=32,
                 mtlalpha=0.3, lsm_weight=0.0, encoder_type="transformer",
                 attn_chunk=3, attn_left_chunks=2)
    model = jtasr.TransformerASR(jtasr.TransformerASRConfig(**hyper, dropout=0.0))
    params = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, D)),
                        jnp.asarray([16]), jnp.zeros((1, 4), jnp.int32))
    rs = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
    am = str(root / "am")
    os.makedirs(am)
    jtext.save_vocab(CVOCAB, os.path.join(am, "vocab.json"))
    jckpt.save_checkpoint(am, "final_avg", params, hyper)
    _, lm_params, _ = _word_lm("gru", seed=4)
    lm = str(root / "wordlm")
    jckpt.save_checkpoint(lm, "final", lm_params, dict(
        model_class="RNNLM", vocab_size=len(WVOCAB), embed_dim=8, hidden=16, layers=1,
        cell="gru"))
    jtext.save_vocab(WVOCAB, os.path.join(lm, "vocab.json"))
    wdict = root / "wordlist.txt"
    # ESPnet's layout: no <eos> line (appended at max id + 1 = 7, where the
    # LM dir's vocab.json has it at 0), 'xyz' left out
    wdict.write_text("".join(f"{w} {i}\n" for w, i in WVOCAB.items()
                             if w not in ("<eos>", "xyz")))
    feats = [(f"u{i}", rs.randn(T, D).astype(np.float32)) for i, T in enumerate((57, 57))]
    egs = str(root / "egs")
    jegs.build_egs(iter(feats), egs)
    return am, lm, str(wdict), egs


@pytest.mark.parametrize("mode", [[], ["--word_lm_dict"], ["--streaming"],
                                  ["--streaming", "--word_lm_dict"]],
                         ids=["vocab_json", "word_lm_dict", "streaming", "streaming_dict"])
def test_recog_e2e_word_lm_matches_jax(dirs, tmp_path, mode):
    """recog_e2e --word_lm_dir (beam 3, max_len 6, lm_weight 0.7,
    oov_penalty 0.01), with the LM dir's vocab.json or --word_lm_dict, in
    the offline host search and --streaming's beam final: out_text
    identical to the JAX CLI's."""
    am, lm, wdict, egs = dirs
    flags = [m for m in mode if m != "--word_lm_dict"]
    if "--word_lm_dict" in mode:
        flags += ["--word_lm_dict", wdict]
    common = ["--beam_size", "3", "--max_len", "6", "--word_lm_dir", lm, "--lm_weight", "0.7",
              "--oov_penalty", "0.01", *flags]
    tout, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    trecog.main([am, egs, tout, *common, "--device", "cpu"])
    jrecog.main([am, egs, jout, *common])
    with open(tout) as f, open(jout) as g:
        got, want = f.read(), g.read()
    assert got == want and len(got.splitlines()) == 2


def test_word_lm_exclusivity_errors(dirs, tmp_path):
    """--word_lm_dir with --lm_dir, --jit_decode or --api cl is refused
    (ValueError in the port, AssertionError in the JAX CLI), as is a word
    vocab whose ids pass the LM's embedding rows; the beam search refuses
    an RNNLM together with a prefix scorer."""
    am, lm, _, egs = dirs
    out = str(tmp_path / "o.txt")
    for extra in (["--lm_dir", lm], ["--jit_decode"], ["--api", "cl"]):
        argv = [am, egs, out, "--word_lm_dir", lm, "--max_len", "2", *extra]
        with pytest.raises(ValueError):
            trecog.main(argv + ["--device", "cpu"])
        with pytest.raises(AssertionError):
            jrecog.main(argv)
    big = tmp_path / "big"
    shutil.copytree(lm, big)
    jtext.save_vocab({**WVOCAB, "cc": 8}, str(big / "vocab.json"))
    argv = [am, egs, out, "--word_lm_dir", str(big), "--max_len", "2"]
    with pytest.raises(ValueError, match="embedding rows"):
        trecog.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="embedding rows"):
        jrecog.main(argv)
    model, _, _ = trecog._load(am, "final_avg", device="cpu")
    port = _word_lm()[2]
    with pytest.raises(ValueError, match="exclusive"):
        beam_search_batched(model, np.zeros((1, 20, D), np.float32), [20], max_len=2,
                            lm=port, prefix_scorer=LookaheadWordLM(port, WVOCAB, CVOCAB),
                            device="cpu")
