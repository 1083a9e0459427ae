"""The port's forced aligner held against the JAX package: the state
chains (utterance_states, trailing_optional, min_align_frames,
equal_align), the batched Viterbi DP, the train-align loop realign_corpus,
the force_align CLI and every ali_utils subcommand.

Both sides get the same numpy inputs; realign_corpus's initial weights
are JAX's own draws (jax.random.key(seed + it)) handed to the port through
`init_weights`. The JAX side runs on the CPU with the conftest's x64 and
float32 inputs; the port runs on the CPU.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu import models as jmodels
from speech_recognition_tools_tpu.align import forced as jforced
from speech_recognition_tools_tpu.cli import ali_utils as jali_utils
from speech_recognition_tools_tpu.cli import force_align as jforce_align
from speech_recognition_tools_tpu_torch import align as talign
from speech_recognition_tools_tpu_torch.align import forced as tforced
from speech_recognition_tools_tpu_torch.cli import ali_utils as tali_utils
from speech_recognition_tools_tpu_torch.cli import force_align as tforce_align
from speech_recognition_tools_tpu_torch.io.jax_params import rnn_classifier_from_jax
from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp

torch.set_num_threads(1)

LEX = {"go": [0], "stop": [1, 2], "left": [3]}  # tests/test_forced_align.py's

# (words, states_per_phone, silence_phone, HmmTopology extras or None):
# the configurations tests/test_forced_align.py aligns
CHAINS = [
    (["go", "stop"], 2, 4, None),
    (["go", "stop"], 1, None, None),
    (["stop"], 2, None, None),
    (["go"], 3, 4, dict(silence_states=5)),
    (["go", "stop"], 1, 4, dict(wpd_silence=True)),
    (["go", "stop"], 2, 4, dict(silence_states=3, wpd_silence=True)),
    (["left", "go", "stop", "left"], 2, 4, dict(silence_states=5, wpd_silence=True)),
    (["go", "stop"], 2, 4, dict()),  # a uniform topology: the legacy numbering
]


def _topo(mod, S, sil, extra):
    return None if extra is None else mod.HmmTopology(5, states_per_phone=S, silence_phone=sil,
                                                      **extra)


@pytest.mark.parametrize("case", range(len(CHAINS)))
def test_state_chains_match_jax(case):
    """utterance_states, trailing_optional, min_align_frames and equal_align
    (at 1 frame, fewer frames than states, and many) identical to JAX's;
    an unknown word raises KeyError in both."""
    words, S, sil, extra = CHAINS[case]
    chains = []
    for mod in (jforced, tforced):
        topo = _topo(mod, S, sil, extra)
        p, sk, st = mod.utterance_states(words, LEX, states_per_phone=S, silence_phone=sil,
                                         topo=topo)
        fin = mod.trailing_optional(p, sk, sil, S, topo=topo)
        chains.append((p, sk, int(st), fin, mod.min_align_frames(p, sk, st, fin),
                       [mod.equal_align(n, p) for n in (1, 3, len(p) + 7, 40)]))
    (jp, jsk, jst, jfin, jmin, jeq), (tp, tsk, tst, tfin, tmin, teq) = chains
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tsk, jsk)
    assert tp.dtype == jp.dtype and tsk.dtype == jsk.dtype
    assert (tst, tfin, tmin) == (jst, jfin, jmin)
    for a, b in zip(teq, jeq):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for mod in (jforced, tforced):
        with pytest.raises(KeyError):
            mod.utterance_states(["nope"], LEX)


def _chain(mod, words, S=2, sil=4, extra=None):
    topo = _topo(mod, S, sil, extra)
    p, sk, st = mod.utterance_states(words, LEX, states_per_phone=S, silence_phone=sil,
                                     topo=topo)
    return p, sk, st, mod.trailing_optional(p, sk, sil, S, topo=topo)


def _check_same(got, want):
    assert len(got) == len(want)
    for (gl, gs), (wl, ws) in zip(got, want):
        if wl is None:
            assert gl is None and gs == ws == -np.inf
        else:
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("self_loop", [0.5, 0.8])
def test_viterbi_align_batch_matches_jax(self_loop):
    """A padded batch of five chains (silence, none, silence states and
    word-position silence, different lengths) on seeded random and sharp
    log-likelihoods, one utterance with too few frames: labels identical,
    scores within 1e-6 relative, the infeasible one (None, -inf) in both;
    the DP timings are recorded."""
    rs = np.random.RandomState(11)
    specs = [(["go", "stop"], 2, 4, None), (["stop", "left"], 1, None, None),
             (["left", "go"], 2, 4, dict(silence_states=3, wpd_silence=True)),
             (["go", "left", "stop"], 2, 4, None), (["stop", "stop", "go"], 2, 4, None)]
    lengths = np.asarray([40, 23, 61, 55, 3])
    P = 14  # the widest topology: 4 x 2 + a 3-state silence + its edge block
    ll = rs.randn(len(specs), 64, P).astype(np.float32) * 2.0
    pdfs0 = _chain(jforced, ["go", "stop"])[0]  # 12 states: each 3 frames, the last 7
    true = np.repeat(pdfs0, [3] * (len(pdfs0) - 1) + [40 - 3 * (len(pdfs0) - 1)])
    ll[0, :40] = -8.0
    ll[0, np.arange(40), true] = 0.0  # sharp: the true path wins
    res = {}
    for name, mod in (("jax", jforced), ("port", tforced)):
        chains = [_chain(mod, w, S, sil, extra) for w, S, sil, extra in specs]
        kw = dict(device="cpu", timings={}) if mod is tforced else {}
        res[name] = mod.viterbi_align_batch(ll, lengths, chains, self_loop_prob=self_loop, **kw)
        if mod is tforced:
            assert kw["timings"]["dp"] > 0 and "traceback" in kw["timings"]
    _check_same(res["port"], res["jax"])
    assert res["port"][4] == (None, -np.inf) and res["port"][0][0].tolist() == true.tolist()
    # a tensor input runs on its device
    chains = [_chain(tforced, w, S, sil, extra) for w, S, sil, extra in specs]
    _check_same(tforced.viterbi_align_batch(torch.as_tensor(ll), lengths, chains,
                                            self_loop_prob=self_loop), res["jax"])


def _corpus(seed=3, n=10, D=5, S=2):
    """n utterances of two words over LEX's phones with silence edges:
    per-phone feature templates, unequal durations."""
    rs = np.random.RandomState(seed)
    temp = rs.randn(6, D).astype(np.float32) * 2.0
    feats, texts = {}, {}
    for i in range(n):
        words = [sorted(LEX)[j] for j in rs.randint(0, 3, 2)]
        phones = [4] + [p for w in words for p in LEX[w]] + [4]
        fr = [p for p in phones for _ in range(int(rs.randint(3, 9)))]
        feats[f"u{i}"] = temp[fr] + 0.3 * rs.randn(len(fr), D).astype(np.float32)
        texts[f"u{i}"] = " ".join(words)
    texts["u0"] = "stop stop stop stop stop stop stop stop stop stop"  # infeasible
    return feats, texts


def _jax_inits(feats, hidden, num_pdfs, seed):
    """JAX realign_corpus's own initial weights, iteration by iteration, in
    the port's layout."""
    D = next(iter(feats.values())).shape[1]
    model = jmodels.RNNClassifier(num_layers=1, hidden_size=hidden, out_size=num_pdfs)

    def init(it):
        params = model.init({"params": jax.random.key(seed + it)},
                            jnp.zeros((1, 8, D), jnp.float32), jnp.asarray([8]))
        return rnn_classifier_from_jax(jax.tree.map(np.asarray, params))

    return init


REALIGN = dict(states_per_phone=2, silence_phone=4, num_iters=2, am_epochs=2, hidden_dim=16,
               batch_size=4, seed=5)


@pytest.mark.parametrize("topology", [dict(), dict(silence_states=3, wpd_silence=True)],
                         ids=["uniform", "silence_states_wpd"])
def test_realign_corpus_matches_jax(topology):
    """realign_corpus from JAX's own initial weights (init_weights): the
    same utterances dropped as infeasible, labels identical, history
    identical (am_loss within 1e-5 relative), the same iter_callback
    calls."""
    feats, texts = _corpus()
    out = {}
    for name, mod in (("jax", jforced), ("port", tforced)):
        hist, calls, logs = [], [], []
        n_pdfs = tforced.HmmTopology(5, 2, 4, **topology).num_pdfs
        kw = dict(device="cpu", init_weights=_jax_inits(feats, 16, n_pdfs, REALIGN["seed"])
                  ) if mod is tforced else {}
        labels, n_pdfs = mod.realign_corpus(
            feats, texts, LEX, **REALIGN, **topology, history=hist,
            iter_callback=lambda it, lab: calls.append(it), log=logs.append, **kw)
        out[name] = (labels, n_pdfs, hist, calls, logs)
    (jl, jn, jh, jc, jlog), (tl, tn, th, tc, tlog) = out["jax"], out["port"]
    assert tn == jn and tc == jc and sorted(tl) == sorted(jl) and "u0" not in tl
    assert any("infeasible" in ln for ln in tlog)
    for u in jl:
        np.testing.assert_array_equal(tl[u], jl[u])
    assert len(th) == len(jh) == REALIGN["num_iters"]
    for a, b in zip(th, jh):
        assert a["iter"] == b["iter"] and a["frames_changed_pct"] == b["frames_changed_pct"]
        np.testing.assert_allclose(a["am_loss"], b["am_loss"], rtol=1e-5)


def test_saturated_iteration_reads_as_converged_in_both(monkeypatch):
    """The JAX fault at align/forced.py:498, reproduced: when every
    utterance's DP saturates in an iteration, 0 of 0 frames changed reads
    as 0% < converge_tol and the loop stops as converged after that
    iteration, keeping the flat-start labels (ROADMAP Queue 3)."""
    feats, texts = _corpus(n=6)
    for mod in (jforced, tforced):
        monkeypatch.setattr(mod, "viterbi_align_batch",
                            lambda ll, lens, chains, **kw: [(None, -np.inf)] * len(chains))
    out = {}
    for name, mod in (("jax", jforced), ("port", tforced)):
        hist, logs = [], []
        kw = dict(device="cpu") if mod is tforced else {}
        labels, _ = mod.realign_corpus(feats, texts, LEX, **REALIGN, history=hist,
                                       log=logs.append, **kw)
        out[name] = (labels, hist, logs)
        assert [h["frames_changed_pct"] for h in hist] == [0.0] and len(hist) == 1
        assert any("converged at iter 0" in ln for ln in logs)
        assert any("of 0 frames" in ln for ln in logs)
    for u, lab in out["jax"][0].items():
        p = tforced.utterance_states(texts[u].split(), LEX, 2, 4)[0]
        np.testing.assert_array_equal(out["port"][0][u], lab)
        np.testing.assert_array_equal(lab, tforced.equal_align(len(lab), p))


def test_force_align_cli_matches_jax(tmp_path):
    """force_align with every flag the JAX CLI has (--states_per_phone 2
    --silence_phone 4 --silence_states 3 --wpd_silence --self_loop_prob 0.6
    --iters 2 --epochs 2 --hidden_dim 16 --num_layers 1 --batch_size 4
    --seed 7), the port handed JAX's initial weights: an identical
    ali.pkl."""
    feats, texts = _corpus(seed=4, n=8)
    texts.pop("u0")
    write_ark_scp(feats, str(tmp_path / "feats"))
    (tmp_path / "text").write_text("".join(f"{u} {t}\n" for u, t in texts.items()))
    (tmp_path / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(map(str, ps))}\n" for w, ps in sorted(LEX.items())))
    args = [str(tmp_path / "feats.scp"), str(tmp_path / "text"), str(tmp_path / "lexicon.txt")]
    flags = ["--states_per_phone", "2", "--silence_phone", "4", "--silence_states", "3",
             "--wpd_silence", "--self_loop_prob", "0.6", "--iters", "2", "--epochs", "2",
             "--hidden_dim", "16", "--num_layers", "1", "--batch_size", "4", "--seed", "7"]
    jforce_align.main([*args, str(tmp_path / "jax.pkl"), *flags])
    n_pdfs = tforced.HmmTopology(5, 2, 4, silence_states=3, wpd_silence=True).num_pdfs
    tforce_align.main([*args, str(tmp_path / "port.pkl"), *flags, "--device", "cpu"],
                      init_weights=_jax_inits(feats, 16, n_pdfs, 7))
    with open(tmp_path / "jax.pkl", "rb") as f, open(tmp_path / "port.pkl", "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert sorted(got) == sorted(want) == sorted(texts)
    for u in want:
        assert got[u].dtype == want[u].dtype
        np.testing.assert_array_equal(got[u], want[u])


def test_ali_utils_match_jax(tmp_path):
    """Every ali_utils subcommand (convert, combine with a key collision,
    simplify-lexicon, combine-lexicon with --uppercase '', 1 and all) gives
    output files identical to the JAX CLI's; convert's unmapped label
    raises in both."""
    rs = np.random.RandomState(2)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        alis = {f"u{i}": rs.randint(0, 6, rs.randint(3, 9)).astype(np.int32)
                for i in range(3 if d == "a" else 2)}
        with open(tmp_path / d / "ali.pkl", "wb") as f:
            pickle.dump(alis, f)
    (tmp_path / "map.txt").write_text("".join(f"{i} {5 - i}\n" for i in range(6)))
    (tmp_path / "short_map.txt").write_text("0 1\n")
    (tmp_path / "lex1.txt").write_text("go g ow\nstop s t aa p\ngo g ow\nleft l eh f t\n")
    (tmp_path / "lex2.txt").write_text("Go g ow\nstop s t ao p\n\nright r ay t\n")
    (tmp_path / "phones.txt").write_text("aa ao\now oh\n")
    a, b = str(tmp_path / "a" / "ali.pkl"), str(tmp_path / "b" / "ali.pkl")
    runs = [
        (["convert", a, "{out}", "--label_map", str(tmp_path / "map.txt")], "pkl"),
        (["combine", "{out}", a, b], "pkl"),
        (["simplify-lexicon", str(tmp_path / "lex1.txt"), "{out}",
          str(tmp_path / "phones.txt")], "txt"),
        (["combine-lexicon", "{out}", str(tmp_path / "lex1.txt"), str(tmp_path / "lex2.txt")],
         "txt"),
        (["combine-lexicon", "{out}", str(tmp_path / "lex1.txt"), str(tmp_path / "lex2.txt"),
          "--uppercase", "1"], "txt"),
        (["combine-lexicon", "{out}", str(tmp_path / "lex1.txt"), str(tmp_path / "lex2.txt"),
          "--uppercase", "all"], "txt"),
    ]
    for k, (argv, kind) in enumerate(runs):
        outs = []
        for name, main in (("jax", jali_utils.main), ("port", tali_utils.main)):
            path = str(tmp_path / f"{name}_{k}.{kind}")
            main([x.format(out=path) for x in argv])
            if kind == "pkl":
                with open(path, "rb") as f:
                    outs.append(pickle.load(f))
            else:
                with open(path) as f:
                    outs.append(f.read())
        if kind == "pkl":
            assert sorted(outs[0]) == sorted(outs[1])
            for key in outs[0]:
                np.testing.assert_array_equal(outs[1][key], outs[0][key])
                assert outs[1][key].dtype == outs[0][key].dtype
        else:
            assert outs[0] == outs[1], argv
    assert len(pickle.load(open(tmp_path / "port_1.pkl", "rb"))) == 5
    for main in (jali_utils.main, tali_utils.main):
        with pytest.raises(ValueError, match="not in map"):
            main(["convert", a, str(tmp_path / "x.pkl"), "--label_map",
                  str(tmp_path / "short_map.txt")])


def test_align_package_exports_the_aligner():
    """align/__init__ exports what the JAX package's does."""
    import speech_recognition_tools_tpu.align as jalign

    names = [n for n in dir(jalign) if not n.startswith("_") and n != "forced"]
    assert names and all(hasattr(talign, n) for n in names)
