"""PM-driven adaptation, lifelong decoding and the continual-learning
decode of the port held against the JAX package: eval/wer.py's
per_utt_fer and parse_kaldi_per_utt, infer/adapt.py (every AdaptConfig
variant) and cli/adapt_am.py, infer/lifelong.py and
cli/lifelong_decode.py (every --fusion), and
models/transformer_asr.py::cl_decode, with the JAX faults the port
reproduces (ROADMAP Queue 3).

Both sides get the same numpy inputs and the same weights (flax inits
perturbed with seeded noise, carried over by io/jax_params.py). Limits:
adaptation losses within 1e-6 relative and the parameters after one step
within 1e-5 of their scale, under sgd (lr 0.5, clipped at global norm 1)
and adam (lr 1e-3; its first update lr * g / (|g| + eps) is safe here,
every gradient entry being far above eps); lifelong.py's functions on
identical inputs within 1e-12; the fused arks of lifelong_decode within
1e-5 of their scale, the VAEs' latent noise fed to both packages;
cl_decode's hypotheses token for token and its best hypothesis' fused
score within 1e-5 relative (beam 2, max_len 6). Widths: 2 GRU layers,
hidden 16, bn 4, 6-dim features, 5 classes; the transformers adim 16, 2
heads, 2/1 layers. Everything runs on the CPU; the JAX side with the
conftest's x64.
"""

import functools
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu import models as J
from speech_recognition_tools_tpu.cli import adapt_am as jadapt_cli
from speech_recognition_tools_tpu.cli import lifelong_decode as jlife_cli
from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.cli import train_am as jtrain
from speech_recognition_tools_tpu.eval import wer as jwer
from speech_recognition_tools_tpu.infer import adapt as jadapt
from speech_recognition_tools_tpu.infer import lifelong as jlife
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.models import vae as jvae
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import adapt_am as tadapt_cli
from speech_recognition_tools_tpu_torch.cli import lifelong_decode as tlife_cli
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.eval import wer as twer
from speech_recognition_tools_tpu_torch.infer import adapt as tadapt
from speech_recognition_tools_tpu_torch.infer import lifelong as tlife
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io.jax_params import (
    rnn_classifier_from_jax,
    rnn_classifier_to_jax,
    transformer_asr_from_jax,
    zoo_from_jax,
)
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
from speech_recognition_tools_tpu_torch.models import recurrent as R
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.models import vae as tvae

torch.set_num_threads(1)

D, C, H, BN = 6, 5, 16, 4
LOSS_REL, STEP_REL, LIFE_TOL, ARK_REL, SCORE_REL = 1e-6, 1e-5, 1e-12, 1e-5, 1e-5


def _perturb(tree, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rs.randn(*np.shape(a))).astype(
        np.float32), tree)


def _tree_rel(got, want):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_g) == set(flat_w)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in flat_w.values())
    return max(float(np.abs(np.asarray(flat_g[p]) - np.asarray(v)).max())
               for p, v in flat_w.items()) / scale


def _dict_rel(got, want):
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / scale


# ------------------------------------------------------------- eval.wer


def test_per_utt_fer_and_kaldi_per_utt_match_jax(tmp_path):
    """per_utt_fer divides by the posterior frame count even where the
    alignment is shorter or longer (the reference's convention); an
    utterance without posteriors is skipped."""
    rs = np.random.RandomState(0)
    post = {f"u{i}": rs.rand(n, C) for i, n in enumerate((12, 9, 15))}
    ali = {"u0": rs.randint(0, C, 12), "u1": rs.randint(0, C, 7), "u2": rs.randint(0, C, 18),
           "u9": rs.randint(0, C, 4)}
    ali["u0"][:6] = post["u0"][:6].argmax(1)
    assert twer.per_utt_fer(post, ali) == jwer.per_utt_fer(post, ali)
    path = tmp_path / "per_utt"
    path.write_text("u0 ref a b c\nu0 hyp a x c\nu0 op C S C\nu0 #csid 2 1 0 0\n"
                    "u1 #csid 3 0 2 1\nu2 #csid 0 1 0 3\n")
    assert twer.parse_kaldi_per_utt(str(path)) == jwer.parse_kaldi_per_utt(str(path))


# ---------------------------------------------------------- infer.adapt

T_AD, LENS_AD = 48, np.array([48, 37, 21])
VARIANTS = {
    "mse": {},
    "l1": dict(loss="l1"),
    "time_shift": dict(time_shift=3),
    "time_shifts": dict(time_shifts=(2, 4)),
    "contrastive": dict(contrastive=True),
    "contrastive_shifts": dict(contrastive=True, time_shifts=(2, 3), neg_weight=0.5),
    "l2_source": dict(l2_source=0.3),
    "supervised": dict(supervised_weight=0.5),
    "mm": dict(mm_weight=0.1),  # deltas 5, 25, 45 (65 >= T is skipped)
}
OPTS = {"sgd": 0.5, "adam": 1e-3}


@functools.lru_cache(maxsize=None)
def _adapt_setup():
    """JAX AM (2 x 16 GRU) and PM (pm_ae 1 + 1 x 16, bn 4) params, a batch,
    a PM mean and a source tree for the L2 pull."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, T_AD, D).astype(np.float32)
    labels = rs.randint(0, C, (3, T_AD)).astype(np.int32)
    jam, jpm = J.RNNClassifier(2, H, C), J.AutoencoderRNN(1, 1, H, BN)
    am = _perturb(jam.init({"params": jax.random.key(0)}, jnp.asarray(x),
                           jnp.asarray(LENS_AD)), 2)
    pm = _perturb(jpm.init({"params": jax.random.key(1)}, jnp.zeros((3, T_AD, C), jnp.float32),
                           jnp.asarray(LENS_AD)), 3)
    source = _perturb(am, 4, scale=0.05)
    mean = (0.2 * rs.randn(C)).astype(np.float32)
    return jam, jpm, am, pm, source, mean, dict(feats=x, lengths=LENS_AD, labels=labels)


def _port_models(am, pm):
    tam = R.RNNClassifier(D, 2, H, C, device="cpu")
    tam.load_state_dict(rnn_classifier_from_jax(am))
    tpm = R.AutoencoderRNN(C, 1, 1, H, BN, device="cpu")
    tpm.load_state_dict(zoo_from_jax(tpm, pm))
    return tam, tpm


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_adapt_step_matches_jax(variant, opt):
    """One adaptation step of every AdaptConfig variant: the loss before
    it and the AM's parameters after it; the PM is frozen (no gradient,
    not in the optimizer, unchanged)."""
    jam, jpm, am, pm, source, mean, batch = _adapt_setup()
    cfg_kw = dict(VARIANTS[variant], optimizer=opt, learning_rate=OPTS[opt])
    jstep, jtx = jadapt.make_adapt_step(
        lambda p, f, n: jam.apply(p, f, n), jpm.apply, pm, mean,
        jadapt.AdaptConfig(**cfg_kw), source_params=source)
    jparams, _, jloss = jstep(am, jtx.init(am), {k: jnp.asarray(v) for k, v in batch.items()})
    tam, tpm = _port_models(am, pm)
    pm_before = {k: v.clone() for k, v in tpm.state_dict().items()}
    tsource = {k: v for k, v in rnn_classifier_from_jax(source).items()}
    tstep, topt = tadapt.make_adapt_step(tam, tpm, mean, tadapt.AdaptConfig(**cfg_kw), tsource)
    state = topt.init(dict(tam.named_parameters()))
    _, tloss = tstep(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss)), (tloss, jloss)
    got = rnn_classifier_to_jax(tam.state_dict())
    assert _tree_rel(got, jparams) <= STEP_REL
    assert _tree_rel(got, am) > 10 * STEP_REL  # the step moved the AM
    assert all(not p.requires_grad and p.grad is None for p in tpm.parameters())
    for k, v in tpm.state_dict().items():
        assert torch.equal(v, pm_before[k]), k


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Egs dirs (6-dim test and dev egs with labels over 5 classes, 5-dim
    egs for p(x) models over posteriors, 6-dim egs of two utterances), JAX
    train_am inits (two rnn AMs,
    two vaes over features, two over posteriors, two pm_ae PMs over the
    AMs' outputs) and two log-prior pickles."""
    root = tmp_path_factory.mktemp("adapt")
    rs = np.random.RandomState(5)
    out = {}
    for name, n_utts, d in (("test", 6, D), ("dev", 4, D), ("post", 6, C), ("pair", 2, D)):
        utts = [(f"{name}{i}", rs.randn(int(n), d).astype(np.float32))
                for i, n in enumerate(rs.randint(12, 30, n_utts))]
        labels = {k: rs.randint(0, C, len(f)) for k, f in utts}
        out[name] = tegs.build_egs(iter(utts), str(root / name), labels, num_targets=C)
    common = ["--num_layers", "2", "--num_layers_dec", "2", "--hidden_dim", str(H), "--bn_dim",
              str(BN), "--epochs", "0"]
    for i in range(2):
        for tag, arch, egs in (("am", "rnn", "test"), ("vae", "vae", "test"),
                               ("qvae", "vae", "post"), ("pm", "pm_ae", "post")):
            out[f"{tag}{i}"] = str(root / f"{tag}{i}")
            jtrain.main([out[egs], out[f"{tag}{i}"], "--arch", arch, *common, "--seed", str(i)])
        prior = np.log(rs.dirichlet(np.ones(C)))
        out[f"prior{i}"] = str(root / f"prior{i}.pkl")
        with open(out[f"prior{i}"], "wb") as f:
            pickle.dump(prior, f)
    out["mean"] = str(root / "mean.pkl")
    with open(out["mean"], "wb") as f:
        pickle.dump((0.1 * rs.randn(C)).astype(np.float32), f)
    return out


def _fers(text):
    return [float(v) for v in re.findall(r"'fer': ([0-9.eE+-]+)", text)]


@pytest.mark.parametrize("flags", [
    ["--optimizer", "sgd", "--learning_rate", "0.5", "--time_shift", "2"],
    ["--optimizer", "adam", "--learning_rate", "1e-3", "--contrastive", "--time_shifts", "2,3",
     "--mm_weight", "0.1", "--l2_source", "0.1", "--loss", "l1"],
], ids=["sgd_time_shift", "adam_contrastive_mm_l2"])
def test_adapt_am_matches_jax(flags, dirs, tmp_path, capsys):
    """adapt_am.main of both packages on the same checkpoints (one epoch
    of two batches): the adapted weights within 1e-5 of their scale, the
    dev FER before and after equal, and the port's checkpoint restored by
    the JAX package into its model's template."""
    argv = [dirs["am0"], dirs["pm0"], dirs["test"], "--dev_egs_dir", dirs["dev"],
            "--cmvn_mean", dirs["mean"], "--epochs", "1", "--batch_size", "4", *flags]
    jadapt_cli.main([*argv[:3], str(tmp_path / "j"), *argv[3:]])
    j_fer = _fers(capsys.readouterr().out)
    res = tadapt_cli.main([*argv[:3], str(tmp_path / "p"), *argv[3:], "--device", "cpu"])
    t_fer = _fers(capsys.readouterr().out)
    assert len(j_fer) == 2 and t_fer == pytest.approx(j_fer, rel=1e-6)
    assert len(res["log"]) == 2 and [m["fer"] for m in res["dev"]] == t_fer
    jpay, jcfg = jckpt.load_checkpoint(str(tmp_path / "j" / "adapted"))
    template = J.RNNClassifier(2, H, C).init({"params": jax.random.key(0)},
                                             jnp.zeros((1, 4, D), jnp.float32), jnp.array([4]))
    tpay, tcfg = jckpt.load_checkpoint(str(tmp_path / "p" / "adapted"),
                                       template={"params": template})
    assert _tree_rel(tpay["params"], jpay["params"]) <= STEP_REL
    assert tcfg == jcfg


# ------------------------------------------------------- infer.lifelong


def test_lifelong_functions_match_jax():
    rs = np.random.RandomState(6)
    K, T = 3, 80
    pcx = [rs.dirichlet(np.ones(C), size=T) for _ in range(K)]
    priors = [np.log(rs.dirichlet(np.ones(C))) for _ in range(K)]
    px = [float(v) for v in 0.01 * rs.randn(K)]
    pxf = [np.exp(0.1 * rs.randn(T)) for _ in range(K)]
    x, rec = rs.randn(2, T, D), rs.randn(2, T, D)
    mu, lv = 0.3 * rs.randn(2, T, BN), 0.2 * rs.randn(2, T, BN)

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=LIFE_TOL, atol=LIFE_TOL)

    assert tlife.powerset(range(3)) == jlife.powerset(range(3))
    close(tlife.framewise_vae_score(x, rec, mu, lv), jlife.framewise_vae_score(x, rec, mu, lv))
    close(tlife.mmeasure_loss(pcx[0]), jlife.mmeasure_loss(pcx[0]))
    for mode in ("dp", "mm", "lowent", "fixed"):
        kw = dict(posteriors=pcx, fixed=[0.2, 0.3, 0.5], beta=300.0)
        close(tlife.task_priors(mode, px, **kw), jlife.task_priors(mode, px, **kw))
    tp = jlife.task_priors("dp", px, beta=300.0)
    for wp in (False, True):
        close(tlife.lifelong_fusion_powerset(pcx, priors, tp, 0.8, weighted_power=wp),
              jlife.lifelong_fusion_powerset(pcx, priors, tp, 0.8, weighted_power=wp))
    close(tlife.lifelong_fusion_incremental(pcx, priors, tp),
          jlife.lifelong_fusion_incremental(pcx, priors, tp))
    close(tlife.lifelong_fusion_perframe(pcx, pxf, priors, 0.8, 300.0),
          jlife.lifelong_fusion_perframe(pcx, pxf, priors, 0.8, 300.0))
    (tb, tt), (jb, jt) = tlife.autoT_fusion(pcx, priors, px), jlife.autoT_fusion(pcx, priors, px)
    close(tb, jb)
    assert tt == jt


def _fed(shape):
    n = int(np.prod(shape))
    return (1.3 * np.sin(0.7 * np.arange(n) + 0.3)).reshape(shape).astype(np.float32)


@pytest.fixture
def fed_noise(monkeypatch):
    """Both packages' VAE latent draws replaced by _fed."""
    monkeypatch.setattr(jvae, "sample_latent", lambda key, m, lv: m + jnp.exp(lv) * jnp.asarray(
        _fed(m.shape), m.dtype))
    monkeypatch.setattr(tvae, "draw_eps", lambda like, eps=None, generator=None: torch.tensor(
        _fed(tuple(like.shape)), dtype=like.dtype))


@pytest.mark.parametrize("fusion,task_prior", [
    ("powerset", "0.3,0.7"), ("postpm", "dp"), ("incremental", "mm"), ("perframe", "dp"),
    ("autoT", "lowent")])
def test_lifelong_decode_matches_jax(fusion, task_prior, dirs, fed_noise, tmp_path):
    """lifelong_decode.main over two rnn classifiers and two vaes (over the
    features, or for postpm over the classifier outputs), one batch of the
    six utterances: the fused arks within 1e-5 of their scale."""
    px = "qvae" if fusion == "postpm" else "vae"
    argv = [f"{dirs['am0']},{dirs['am1']}", f"{dirs[px + '0']},{dirs[px + '1']}", dirs["test"],
            f"{dirs['prior0']},{dirs['prior1']}", task_prior]
    extra = ["--fusion", fusion, "--batch_size", "8"]
    if fusion == "postpm":
        extra += ["--pm_on", "posteriors"]
    jlife_cli.main([*argv, str(tmp_path / "j"), *extra])
    got = tlife_cli.main([*argv, str(tmp_path / "p"), *extra, "--device", "cpu"])
    want = dict(read_ark(str(tmp_path / "j.ark")))
    assert all(np.isfinite(v).all() for v in want.values())
    assert _dict_rel(got, want) <= ARK_REL


def test_lifelong_decode_over_a_pm_ae_reads_its_bottleneck_as_a_latent(dirs, tmp_path):
    """A JAX fault the port reproduces (ROADMAP Queue 3): a pm_ae p(x)
    model returns (recon, bottleneck), and lifelong_decode reads the
    bottleneck (B, T, bn) as (means, logvars): the batch's first
    utterance's rows as every utterance's means and its second's (the
    first's again in a batch of one, where jax clamps the index) as their
    log-stds. Both packages write the same arks (here at a batch of one),
    which change with the batch size."""
    argv = [f"{dirs['am0']},{dirs['am1']}", f"{dirs['pm0']},{dirs['pm1']}", dirs["pair"],
            f"{dirs['prior0']},{dirs['prior1']}", "dp"]
    jlife_cli.main([*argv, str(tmp_path / "j"), "--batch_size", "1", "--pm_on", "posteriors"])
    got = {bs: tlife_cli.main([*argv, str(tmp_path / f"p{bs}"), "--batch_size", bs, "--pm_on",
                               "posteriors", "--device", "cpu"]) for bs in ("1", "2")}
    assert _dict_rel(got["1"], dict(read_ark(str(tmp_path / "j.ark")))) <= ARK_REL
    assert _dict_rel(got["2"], got["1"]) > 1e-3


# ------------------------------------------------------------- cl_decode

V_CL, MAX_LEN_CL = 12, 6


class _Jitted:
    """A flax module whose apply(params, *args, method=m) runs jitted (one
    compile per method and shape instead of one per op): the JAX cl_decode
    applies its models eagerly."""

    def __init__(self, module):
        self.module = module

    @functools.lru_cache(maxsize=None)
    def _fn(self, method):
        return jax.jit(functools.partial(self.module.apply, method=method))

    def apply(self, params, *args, method):
        return self._fn(method)(params, *args)


@functools.lru_cache(maxsize=None)
def _cl_models():
    """Three JAX TransformerASRs (seeds 0-2; decoder output kernels scaled
    by 4 against near ties) and their port twins, and one utterance."""
    cfg = jtasr.TransformerASRConfig(vocab_size=V_CL, adim=16, aheads=2, elayers=2, eunits=32,
                                     dlayers=1, dunits=32, dropout=0.0)
    tcfg = ttasr.TransformerASRConfig(vocab_size=V_CL, adim=16, aheads=2, elayers=2, eunits=32,
                                      dlayers=1, dunits=32, dropout=0.0)
    jm, pairs, ports = jtasr.TransformerASR(cfg), [], []
    jj = _Jitted(jm)
    for seed in range(3):
        params = _perturb(jm.init({"params": jax.random.key(seed)},
                                  jnp.zeros((1, 40, 8), jnp.float32), jnp.asarray([40]),
                                  jnp.zeros((1, 4), jnp.int32)), 10 + seed)
        params["params"]["decoder"]["output"]["kernel"] *= 4.0
        pairs.append((jj, params))
        tm = ttasr.TransformerASR(tcfg, 8, device="cpu")
        tm.load_state_dict(transformer_asr_from_jax(params))
        ports.append(tm.eval())
    x = np.random.RandomState(7).randn(1, 40, 8).astype(np.float32)
    return cfg, tcfg, pairs, ports, x, np.array([37], np.int32)


def _fused_score(step_logp, seq, w, eos, max_len):
    """The search's score of `seq`: sum over its steps (and eos, if it
    ended before max_len) of sum_k w_k log_softmax of model k's decoder
    at that step; step_logp(k, tokens) -> (len(tokens), V) log-softmaxes
    of model k's one full-prefix pass over [sos] + tokens[:-1]."""
    toks = seq + ([eos] if len(seq) < max_len else [])
    return sum(float(wk * step_logp(k, toks)[np.arange(len(toks)), toks].sum())
               for k, wk in enumerate(w))


@pytest.mark.parametrize("pm_scores", [(0.002, 0.001), (0.0, 0.004)])
def test_cl_decode_matches_jax(pm_scores):
    cfg, tcfg, pairs, ports, x, n = _cl_models()
    want = jtasr.cl_decode(pairs[:2], list(pm_scores), jnp.asarray(x), jnp.asarray(n), cfg,
                           beam_size=2, max_len=MAX_LEN_CL)
    got = ttasr.cl_decode(ports[:2], list(pm_scores), torch.tensor(x), torch.tensor(n), tcfg,
                          beam_size=2, max_len=MAX_LEN_CL)
    assert got == want and len(got) > 0
    w = np.exp(300.0 * np.asarray(pm_scores)) / np.exp(300.0 * np.asarray(pm_scores)).sum()

    def jlogp(k, toks):
        jm, p = pairs[k]
        mem, el, _ = jm.apply(p, jnp.asarray(x), jnp.asarray(n),
                              method=jtasr.TransformerASR.encode)
        prefix = jnp.asarray([[cfg.sos_id, *toks[:-1]]], jnp.int32)
        dl = jm.apply(p, prefix, mem, el, method=jtasr.TransformerASR.decode_step)
        return np.asarray(jax.nn.log_softmax(dl[0], -1))

    def tlogp(k, toks):
        with torch.no_grad():
            mem, el, _ = ports[k].encode(torch.tensor(x), torch.tensor(n))
            dl = ports[k].decode_step(torch.tensor([[tcfg.sos_id, *toks[:-1]]]), mem, el)
        return torch.log_softmax(dl[0], -1).numpy()

    sj = _fused_score(jlogp, want, w, cfg.eos_id, MAX_LEN_CL)
    st = _fused_score(tlogp, got, w, tcfg.eos_id, MAX_LEN_CL)
    assert abs(st - sj) <= SCORE_REL * abs(sj)


def test_cl_decode_drops_models_past_the_pm_scores_in_both():
    """A JAX fault the port reproduces (ROADMAP Queue 3): zip pairs the
    weights with the models, so with two scores for three models the third
    is dropped without a word: the decode equals the two-model one."""
    cfg, tcfg, pairs, ports, x, n = _cl_models()
    pm = [0.002, 0.001]
    for decode, models, xx, nn, c in (
            (jtasr.cl_decode, pairs, jnp.asarray(x), jnp.asarray(n), cfg),
            (ttasr.cl_decode, ports, torch.tensor(x), torch.tensor(n), tcfg)):
        three = decode(models, pm, xx, nn, c, beam_size=2, max_len=6)
        assert three == decode(models[:2], pm, xx, nn, c, beam_size=2, max_len=6)


def test_recog_e2e_api_cl_without_pm_scores_raises_in_both(tmp_path):
    """A JAX fault the port reproduces (ROADMAP Queue 3): without
    --pm_scores, "".split(",") is [""] and float("") raises ValueError
    before the [1.0] * K fallback can apply."""
    cfg, _, pairs, _, x, n = _cl_models()
    vocab = jtext.build_char_vocab(["abcdefgh"])
    assert len(vocab) == V_CL
    hyper = dict(vocab_size=V_CL, adim=16, aheads=2, elayers=2, eunits=32, dlayers=1,
                 dunits=32, mtlalpha=0.3, lsm_weight=0.0, feature_dim=8)
    dirs = []
    for k in range(2):
        d = str(tmp_path / f"m{k}")
        os.makedirs(d)
        jtext.save_vocab(vocab, os.path.join(d, "vocab.json"))
        jckpt.save_checkpoint(d, "final_avg", pairs[k][1], hyper)
        dirs.append(d)
    egs = tegs.build_egs(iter([("u0", x[0, : int(n[0])])]), str(tmp_path / "egs"))
    for main, extra in ((jrecog.main, []), (trecog.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="could not convert string to float"):
            main([",".join(dirs), egs, str(tmp_path / "o.txt"), "--api", "cl", *extra])
