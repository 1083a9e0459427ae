"""The port's reference/ESPnet checkpoint importer held against the JAX
package's: `io/torch_import.py` and `cli/import_torch_ckpt.py`.

For every family `detect_family` knows, the test builds a state_dict with
that family's key names and shapes (seeded torch tensors; the reference's
own modules are not needed), and holds the port's converted tree to the
JAX importer's leaf by leaf, exactly, and the checkpoint files each CLI
writes to each other byte for byte. Then the families the port's models
load run in them: the ESPnet e2e transformer in recog_e2e's `_load`, the
ESPnet LM (LSTM and GRU) in `_load_lm`, and the reference nnetRNN in
`dump_outputs`, each against a torch reconstruction of the source model;
the `--egs` data import writes the JAX CLI's egs directory; and a family
the port has no model for imports, then raises NotImplementedError in the
port's loader, naming its ROADMAP item.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from test_espnet_import import _E2E, AHEADS, D_FEAT, ODIM, _Classifier, _EspnetLM

from speech_recognition_tools_tpu.cli import import_torch_ckpt as jcli
from speech_recognition_tools_tpu.io import torch_import as jti
from speech_recognition_tools_tpu_torch.cli import dump_outputs as tdump
from speech_recognition_tools_tpu_torch.cli import import_torch_ckpt as tcli
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io import torch_import as tti
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark

torch.set_num_threads(1)

D, H, BN, C = 6, 10, 4, 5  # features, hidden, bottleneck, classes


class _SD(dict):
    """A state_dict under construction: seeded tensors with the reference
    modules' key names and torch layouts."""

    def __init__(self, seed):
        super().__init__()
        self.g = torch.Generator().manual_seed(seed)

    def t(self, *shape):
        return torch.randn(*shape, generator=self.g) * 0.3

    def gru(self, p, d, h, suffix="_l0"):
        for name, shape in (("weight_ih", (3 * h, d)), ("weight_hh", (3 * h, h)),
                            ("bias_ih", (3 * h,)), ("bias_hh", (3 * h,))):
            self[p + name + suffix] = self.t(*shape)

    def lstm(self, p, d, h, suffix="_l0"):
        for name, shape in (("weight_ih", (4 * h, d)), ("weight_hh", (4 * h, h)),
                            ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,))):
            self[p + name + suffix] = self.t(*shape)

    def grus(self, p, d, h, n):
        for i in range(n):
            self.gru(f"{p}layers.{i}.", d if i == 0 else h, h)

    def lin(self, p, i, o):
        self[p + "weight"], self[p + "bias"] = self.t(o, i), self.t(o)

    def c1(self, p, i, o):  # a 1x1 Conv1d
        self[p + "weight"], self[p + "bias"] = self.t(o, i, 1), self.t(o)

    def conv(self, p, i, o, k=3):
        self[p + "weight"], self[p + "bias"] = self.t(o, i, k, k), self.t(o)

    def convT(self, p, i, o, k=3):
        self[p + "weight"], self[p + "bias"] = self.t(i, o, k, k), self.t(o)


def _vae(sd, p="", dec_layers=1):
    sd.grus(p + "vae_encoder.", D, H, 2)
    sd.c1(p + "vae_encoder.means.", H, BN)
    sd.c1(p + "vae_encoder.vars.", H, BN)
    sd.grus(p + "vae_decoder.", BN, H, dec_layers)
    sd.c1(p + "vae_decoder.means.", H, D)
    sd.c1(p + "vae_decoder.vars.", H, D)  # dead in the reference's forward


def _curl_encoder(sd, p, K=2):
    sd.grus(p + "curl_encoder.", D, H, 2)
    for k in range(K):
        sd.lin(f"{p}curl_encoder.means.{k}.", H, BN)
        sd.lin(f"{p}curl_encoder.var.{k}.", H, BN)
    sd.lin(p + "curl_encoder.categorical.", H, K)


def _curl_unsup(sd, p=""):
    _curl_encoder(sd, p)
    sd.grus(p + "curl_decoder.", BN, H, 1)
    sd.lin(p + "curl_decoder.means.", H, D)


def _conv_stack(sd, p, chans=(1, 3, 4)):
    for i in range(len(chans) - 1):
        sd.conv(f"{p}cnn_layers.{i}.", chans[i], chans[i + 1])


def _build(family, seed=0):
    """(state_dict, hyper, extra CLI flags) of one family."""
    sd, hyper, flags = _SD(seed), {"dropout": 0.1, "epoch": 3}, []
    if family == "rnn":
        sd.grus("", D, H, 2)
        sd.c1("regression.", H, C)
    elif family == "feedforward":
        sd.lin("layers.0.", D, H), sd.lin("layers.1.", H, H), sd.lin("layers.2.", H, C)
    elif family == "linear":
        sd.c1("layers.0.", D, H), sd.c1("layers.1.", H, H), sd.c1("layers.2.", H, C)
    elif family in ("multitask_ae", "multitask_aear"):
        sd.grus("encoder.", D, H, 2)
        sd.c1("encoder.bottleneck.", H, BN)
        sd.grus("classifier.", BN, H, 1)
        sd.c1("classifier.regression.", H, C)
        for part in ("ae", "ar") if family == "multitask_aear" else ("ae",):
            sd.grus(f"{part}.", BN, H, 1)
            sd.c1(f"{part}.regression.", H, D)
        hyper["time_shift"] = 2
    elif family in ("vae", "vae_classifier"):
        _vae(sd)
        hyper["only_AE"] = True
        if family == "vae_classifier":
            sd.grus("classifier.", BN, H, 1)
            sd.c1("classifier.regression.", H, C)
    elif family == "arvae":
        sd.grus("vae_encoder.", D, H, 2)
        sd.c1("vae_encoder.means.", H, BN)
        sd.c1("vae_encoder.vars.", H, BN)
        for i in range(2):
            sd.grus(f"vae_decoder.{i}.", BN, H, 1)
            sd.c1(f"vae_decoder.{i}.means.", H, D)
    elif family == "curl":
        _curl_encoder(sd, "")
        for k in range(2):
            sd.grus(f"classifier.{k}.", BN, H, 1)
            sd.c1(f"classifier.{k}.regression.", H, C)
            sd.gru(f"curl_decoder.layers.{k}.0.", BN, H)
            sd.lin(f"curl_decoder.means.{k}.", H, D)
    elif family == "curl_unsup":
        _curl_unsup(sd)
    elif family == "multimod":
        for s in range(2):
            sd.grus(f"subnets.{s}.", 3, 4, 2)
        sd.grus("", 8, H, 1)
        sd.c1("regression.", H, C)
    elif family == "cnn":
        _conv_stack(sd, "")
        sd.c1("lin.", 4 * D, C)
    elif family == "cldnn":
        _conv_stack(sd, "")
        sd.c1("dim_reduce.", 4 * D, 8)
        sd.lstm("lstm_layers.0.", 8, 8), sd.lstm("lstm_layers.1.", 8, 8)
        sd.c1("dnn_layers.0.", 8, 8), sd.c1("dnn_layers.1.", 8, C)
    elif family in ("vae_cnn", "vae_cnn_pool"):
        _conv_stack(sd, "vae_encoder.")
        if family == "vae_cnn":
            sd.c1("vae_encoder.means.", 4 * D, BN), sd.c1("vae_encoder.vars.", 4 * D, BN)
            sd.c1("vae_decoder.expand_linear.", BN, 4 * D)
        else:  # 8 x 8 inputs pooled twice: a 2 x 2 x 4 bottleneck
            sd.lin("vae_encoder.means.", 16, BN), sd.lin("vae_encoder.vars.", 16, BN)
            sd.lin("vae_decoder.expand_linear.", BN, 16)
            flags = ["--input_hw", "8,8"]
        sd.convT("vae_decoder.cnn_layers.0.", 4, 3), sd.convT("vae_decoder.cnn_layers.1.", 3, 1)
    elif family == "rs_vae":
        sd.conv("vae_encoder.cnn_layers.0.", 1, 3)
        sd["vae_encoder.cnn_layers.1.rates"] = sd.t(4, 3)
        sd["vae_encoder.cnn_layers.1.scales"] = sd.t(4, 3)
        sd.c1("vae_encoder.means.", 4 * D, BN), sd.c1("vae_encoder.vars.", 4 * D, BN)
        sd.c1("vae_decoder.expand_linear.", BN, 4 * D)
        sd["vae_decoder.cnn_layers.0.rates"] = sd.t(4, 3)
        sd["vae_decoder.cnn_layers.0.scales"] = sd.t(4, 3)
        sd.convT("vae_decoder.cnn_layers.1.", 3, 1)
    elif family in ("modnet", "modnet_sigmoid"):
        # 7 feature bins x 9 frames, two VALID 3 x 3 convs: 3 x 3 x 5 maps
        sd.conv("encoder.layers.0.", 1, 2), sd.conv("encoder.layers.1.", 2, 3)
        if family == "modnet":
            sd.lin("encoder.regressors.0.", 45, 4), sd.lin("encoder.regressors.1.", 45, 4)
            sd.lin("classifier.layers.0.", 7 * 2, H)
        else:
            sd.lin("encoder.regression.", 45, 4)
            sd["encoder.input_filter.weight"] = sd.t(1, 1, 3)
            sd["encoder.input_filter.bias"] = sd.t(1)
            sd.lin("classifier.layers.0.", 7 * 4, H)
        sd.lin("classifier.layers.1.", H, C)
    elif family == "vae_encoded":
        _vae(sd, "vae_model.")
        sd.c1("layers.0.", BN, 8), sd.c1("layers.1.", 8, C)
    elif family == "curl_encoded":
        _curl_unsup(sd, "curl_model.")
        sd.c1("layers.0.", BN, 8), sd.c1("layers.1.", 8, C)
    else:
        raise KeyError(family)
    return dict(sd), hyper, flags


REFERENCE_FAMILIES = ["rnn", "feedforward", "linear", "multitask_ae", "multitask_aear", "vae",
                      "vae_classifier", "arvae", "curl", "curl_unsup", "multimod", "cnn",
                      "cldnn", "vae_cnn", "vae_cnn_pool", "rs_vae", "modnet", "modnet_sigmoid",
                      "vae_encoded", "curl_encoded"]


def _espnet_e2e(seed):
    torch.manual_seed(seed)
    return _E2E().eval()


def _espnet_lm(seed, typ):
    torch.manual_seed(seed)
    return _Classifier(_EspnetLM(ODIM, 6, 10, 2, typ=typ)).eval()


def _units(path):
    toks = ["<unk>", "<space>"] + [chr(ord("a") + i) for i in range(ODIM - 4)]
    path.write_text("".join(f"{t} {i + 1}\n" for i, t in enumerate(toks)))
    return str(path)


def _tree_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


def _files(root):
    """Every file under `root`, its path inside `root` spelled <dest> (the
    frozen-encoder families' head config records its base's path)."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read().replace(
                    str(root).encode(), b"<dest>")
    return out


def test_the_state_dicts_cover_every_family():
    """The families built here are every family detect_family can return,
    and each state_dict is detected as its own."""
    detected = {}
    for fam in REFERENCE_FAMILIES:
        detected[fam] = tti.detect_family(_build(fam)[0])
    assert detected.pop("vae_cnn_pool") == "vae_cnn"  # the 2-D heads pick the pooled path
    assert all(k == v for k, v in detected.items()), detected
    detected["espnet_e2e"] = tti.detect_family(_espnet_e2e(0).state_dict())
    detected["espnet_lm"] = tti.detect_family(_espnet_lm(0, "lstm").state_dict())
    known = set(jti._CONVERTERS) | {"vae_encoded", "curl_encoded", "espnet_e2e", "espnet_lm"}
    assert set(detected.values()) == known == set(tti._CONVERTERS) | {
        "vae_encoded", "curl_encoded", "espnet_e2e", "espnet_lm"}


@pytest.mark.parametrize("family", REFERENCE_FAMILIES)
def test_reference_family_tree_and_bytes_match_jax(family, tmp_path):
    """The converted flax tree and config equal the JAX importer's exactly
    (key order, dtypes, values), and the import CLIs write the same files,
    byte for byte (state.msgpack, config.json; a base and a head for the
    frozen-encoder families)."""
    sd, hyper, flags = _build(family)
    if family in ("vae_encoded", "curl_encoded"):
        got, want = tti.convert_encoded_classifier(sd, hyper), jti.convert_encoded_classifier(
            sd, hyper)
    else:
        if flags:
            hyper["input_hw"] = (8, 8)
        got, want = tti.convert_state_dict(sd, hyper), jti.convert_state_dict(sd, hyper)
    for g, w in zip(got, want):
        _tree_equal(g, w)
    src = str(tmp_path / "ref.model")
    torch.save({"model_state_dict": sd, **hyper, "optimizer_state_dict": {}}, src)
    jcli.main([src, str(tmp_path / "jax"), *flags])
    tcli.main([src, str(tmp_path / "port"), *flags])
    jf = _files(tmp_path / "jax")
    assert jf and _files(tmp_path / "port") == jf


@pytest.mark.parametrize("kind", ["espnet_e2e", "espnet_lm_lstm", "espnet_lm_gru"])
def test_espnet_tree_and_bytes_match_jax(kind, tmp_path):
    """ESPnet e2e (with --espnet_units, --aheads, --mtlalpha, --attn_chunk)
    and ESPnet LM checkpoints (LSTM and GRU, as a snapshot wrapper with
    DataParallel prefixes): the same trees and files as the JAX importer."""
    units = _units(tmp_path / "units.txt")
    if kind == "espnet_e2e":
        sd = _espnet_e2e(1).state_dict()
        _tree_equal(tti.convert_espnet_e2e(sd, AHEADS, 0.3, 2, 3)[0],
                    jti.convert_espnet_e2e(sd, AHEADS, 0.3, 2, 3)[0])
        assert tti.convert_espnet_e2e(sd, AHEADS)[1] == jti.convert_espnet_e2e(sd, AHEADS)[1]
        blob = sd
        flags = ["--espnet_units", units, "--aheads", str(AHEADS), "--mtlalpha", "0.4",
                 "--attn_chunk", "2", "--attn_left_chunks", "3"]
    else:
        sd = _espnet_lm(2, kind.rsplit("_", 1)[1]).state_dict()
        for g, w in zip(tti.convert_espnet_lm(sd), jti.convert_espnet_lm(sd)):
            _tree_equal(g, w)
        blob = {"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 4}
        flags = ["--espnet_units", units]
    src = str(tmp_path / "model.best")
    torch.save(blob, src)
    jcli.main([src, str(tmp_path / "jax"), *flags])
    tcli.main([src, str(tmp_path / "port"), *flags])
    jf = _files(tmp_path / "jax")
    assert "vocab.json" in jf and _files(tmp_path / "port") == jf


def test_espnet_e2e_import_runs_in_the_port(tmp_path):
    """An ESPnet e2e transformer imported by the port's CLI loads in the
    port's recog_e2e `_load`; its encoder output, CTC logits and decoder
    logits equal the torch reconstruction's (rtol 1e-4, atol 6e-5)."""
    e2e = _espnet_e2e(5)
    src = str(tmp_path / "model.acc.best")
    torch.save(e2e.state_dict(), src)
    dest = str(tmp_path / "imported")
    tcli.main([src, dest, "--espnet_units", _units(tmp_path / "u.txt"), "--aheads",
               str(AHEADS)])
    model, cfg, vocab = trecog._load(dest, "final_avg", device="cpu")
    assert vocab["<blank>"] == 0 and vocab["<sos/eos>"] == ODIM - 1
    assert cfg.aheads == AHEADS and cfg.vocab_size == ODIM
    rs = np.random.RandomState(0)
    x = rs.randn(2, 29, D_FEAT).astype(np.float32)
    tokens = rs.randint(0, ODIM, (2, 7))
    with torch.no_grad():
        mem_t = e2e.encoder(torch.from_numpy(x))
        ctc_t = e2e.ctc.ctc_lo(mem_t)
        dec_t = e2e.decoder(torch.from_numpy(tokens), mem_t)
        mem, n, ctc = model.encode(torch.from_numpy(x), torch.tensor([29, 29]))
        dec = model.decode_step(torch.from_numpy(tokens), mem, n)
    assert int(n[0]) == mem_t.shape[1]
    for got, want in ((mem, mem_t), (ctc, ctc_t), (dec, dec_t)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=6e-5)


@pytest.mark.parametrize("typ", ["lstm", "gru"])
def test_espnet_lm_import_runs_in_the_port(typ, tmp_path):
    """An ESPnet DefaultRNNLM (2 layers) imported by the port's CLI loads in
    recog_e2e's `_load_lm` with its cell; its logits, and its step() logits
    one token at a time, equal the torch reconstruction's (rtol 1e-4, atol
    1e-5)."""
    lm_t = _espnet_lm(9, typ)
    src = str(tmp_path / "rnnlm.model.best")
    torch.save(lm_t.state_dict(), src)
    dest = str(tmp_path / "lm")
    tcli.main([src, dest])
    lm = trecog._load_lm(dest, device="cpu")
    assert lm.cell == typ
    tokens = torch.as_tensor(np.random.RandomState(1).randint(0, ODIM, (3, 9)))
    with torch.no_grad():
        want = lm_t.predictor(tokens).numpy()
        got = lm(tokens).numpy()
        state, steps = lm.init_state(3), []
        for s in range(9):
            logits, state = lm.step(tokens[:, s], state)
            steps.append(logits.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.stack(steps, 1), want, rtol=1e-4, atol=1e-5)


class _NnetRNN(torch.nn.Module):
    """A reconstruction of the reference's nnetRNN: single-layer nn.GRUs
    over packed sequences (zeros past each length), then a 1x1 Conv1d."""

    def __init__(self, sd):
        super().__init__()
        n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
        self.layers = torch.nn.ModuleList(
            torch.nn.GRU(sd[f"layers.{i}.weight_ih_l0"].shape[1],
                         sd[f"layers.{i}.weight_hh_l0"].shape[1], batch_first=True)
            for i in range(n))
        w = sd["regression.weight"]
        self.regression = torch.nn.Conv1d(w.shape[1], w.shape[0], 1)
        self.load_state_dict(sd)

    def forward(self, x, lengths):
        pack = torch.nn.utils.rnn.pack_padded_sequence
        unpack = torch.nn.utils.rnn.pad_packed_sequence
        for gru in self.layers:
            x, _ = unpack(gru(pack(x, lengths, batch_first=True, enforce_sorted=False))[0],
                          batch_first=True, total_length=x.shape[1])
        return self.regression(x.transpose(1, 2)).transpose(1, 2)


def test_nnet_rnn_import_runs_in_dump_outputs(tmp_path):
    """A reference nnetRNN .model dict imported by the port's CLI is read by
    the port's dump_outputs, whose logits (no prior) on every frame of an
    egs directory equal the torch reconstruction's (rtol 1e-4, atol 1e-5)."""
    sd, hyper, _ = _build("rnn", seed=4)
    src = str(tmp_path / "final.model")
    torch.save({"model_state_dict": sd, **hyper}, src)
    dest = str(tmp_path / "am")
    tcli.main([src, dest])
    rs = np.random.RandomState(2)
    utts = [(f"u{i}", rs.randn(n, D).astype(np.float32)) for i, n in enumerate((17, 9, 12))]
    egs = tegs.build_egs(iter(utts), str(tmp_path / "egs"))
    tdump.main([dest, egs, str(tmp_path / "ll"), "--device", "cpu"])
    got = dict(read_ark(str(tmp_path / "ll.ark")))
    ref = _NnetRNN(sd).eval()
    for key, x in utts:
        with torch.no_grad():
            want = ref(torch.from_numpy(x[None]), torch.tensor([len(x)]))[0].numpy()
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5)


def test_egs_import_matches_jax(tmp_path):
    """--egs: a reference egs directory (padded per-utterance .pt files,
    lengths.pkl, labels.pkl) becomes the same native egs files as the JAX
    CLI writes, byte for byte."""
    src = tmp_path / "ref_egs"
    src.mkdir()
    rng = np.random.default_rng(40)
    lengths, labels = {}, {}
    for i, n in enumerate((16, 9, 12)):
        padded = np.zeros((16, 5), np.float32)
        padded[:n] = rng.standard_normal((n, 5))
        torch.save(torch.from_numpy(padded), src / f"utt{i}.pt")
        lengths[f"utt{i}.pt"] = n
        labels[f"utt{i}.pt"] = torch.from_numpy(np.pad(rng.integers(0, 7, n), (0, 16 - n)))
    with open(src / "lengths.pkl", "wb") as f:
        pickle.dump(lengths, f)
    torch.save(labels, src / "labels.pkl")
    jcli.main([str(src), str(tmp_path / "jax"), "--egs"])
    tcli.main([str(src), str(tmp_path / "port"), "--egs", "--num_targets", "9"])
    jcli.main([str(src), str(tmp_path / "jax9"), "--egs", "--num_targets", "9"])
    jf = _files(tmp_path / "jax9")
    assert jf and _files(tmp_path / "port") == jf
    assert _files(tmp_path / "jax") != jf  # num_targets is recorded
    _, utts = tegs.load_egs(str(tmp_path / "port"))
    assert [len(f) for _, f, _ in utts] == [16, 9, 12]


@pytest.mark.parametrize("family", ["cnn", "vae_encoded"])
def test_unloadable_family_imports_then_raises_in_the_port(family, tmp_path):
    """A family the port has no model for yet is imported all the same (the
    JAX package's files); the port's dump_outputs then raises
    NotImplementedError naming ROADMAP Queue 1 item 1 (the model zoo)."""
    sd, hyper, _ = _build(family)
    src = str(tmp_path / "ref.model")
    torch.save({"model_state_dict": sd, **hyper}, src)
    dest = str(tmp_path / "imported")
    tcli.main([src, dest])
    egs = tegs.build_egs(iter([("u0", np.zeros((9, D), np.float32))]), str(tmp_path / "egs"))
    with pytest.raises(NotImplementedError, match="item 1: the rest of the model zoo"):
        tdump.main([dest, egs, str(tmp_path / "o"), "--device", "cpu"])

