"""The port's hybrid acoustic-model slice held against the JAX package:
CMVN, the masked GRU classifier with weights carried over by
io/jax_params.py, posteriors, and the whole chain wav -> FDLP -> CMVN ->
RNNClassifier -> prior-normalised log-likelihoods.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu import models as jmodels
from speech_recognition_tools_tpu.dsp import FdlpConfig as JaxFdlpConfig
from speech_recognition_tools_tpu.dsp import fdlp_spectrogram_batch as jax_fdlp
from speech_recognition_tools_tpu.infer import posteriors as jpost
from speech_recognition_tools_tpu.utils import cmvn as jcmvn
from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.dsp.fdlp import (
    FdlpConfig,
    fdlp_spectrogram_batch,
)
from speech_recognition_tools_tpu_torch.infer import posteriors as tpost
from speech_recognition_tools_tpu_torch.io.jax_params import rnn_classifier_from_jax
from speech_recognition_tools_tpu_torch.models.recurrent import (
    RNNClassifier,
    length_mask,
)
from speech_recognition_tools_tpu_torch.utils import cmvn as tcmvn

torch.set_num_threads(1)

D, LAYERS, HIDDEN, CLASSES = 20, 2, 32, 10
LENGTHS = np.array([13, 7, 10], np.int32)


def _jax_model():
    model = jmodels.RNNClassifier(num_layers=LAYERS, hidden_size=HIDDEN,
                                  out_size=CLASSES)
    x = jnp.zeros((1, 4, D), jnp.float32)
    params = model.init({"params": jax.random.key(0)}, x, jnp.asarray([4]))
    return model, jax.tree.map(np.asarray, params)


def _port_model(params):
    m = RNNClassifier(D, LAYERS, HIDDEN, CLASSES, device="cpu")
    m.load_state_dict(rnn_classifier_from_jax(params))
    return m.eval()


def _valid(arr, lengths):
    return np.concatenate([np.asarray(arr)[b, : lengths[b]] for b in range(len(lengths))])


def test_weight_conversion_covers_every_parameter():
    _, params = _jax_model()
    sd = rnn_classifier_from_jax(params)
    m = RNNClassifier(D, LAYERS, HIDDEN, CLASSES, device="cpu")
    assert set(sd) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert sd[k].shape == v.shape, k
    # the outer {"params": ...} is optional
    assert set(rnn_classifier_from_jax(params["params"])) == set(sd)


def test_gru_classifier_matches_jax():
    """Valid-frame logits at atol 1e-5 (f32 on both sides); padded
    outputs of every GRU layer are exactly zero."""
    model, params = _jax_model()
    x = np.random.RandomState(0).randn(3, int(LENGTHS.max()), D).astype(np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(LENGTHS)))
    port = _port_model(params)
    with torch.no_grad():
        got = port(torch.as_tensor(x), torch.as_tensor(LENGTHS)).numpy()
        hidden = port.gru(torch.as_tensor(x), torch.as_tensor(LENGTHS)).numpy()
    np.testing.assert_allclose(_valid(got, LENGTHS), _valid(ref, LENGTHS),
                               rtol=0, atol=1e-5)
    pad = ~length_mask(torch.as_tensor(LENGTHS), x.shape[1]).numpy()
    assert np.all(hidden[pad] == 0)
    # padded logits are the output bias, like the JAX model's
    np.testing.assert_allclose(got[pad], np.asarray(ref)[pad], rtol=0, atol=1e-6)


def test_gru_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        RNNClassifier(D, 1, 8, 4)


def test_device_lookup_leaves_tf32_flags_alone(monkeypatch):
    """resolve_device only looks the device up; configure_cuda is the one
    place that switches TF32 off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    RNNClassifier(D, 1, 8, 4, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    configure_cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("norm_var", [True, False])
def test_cmvn_matches_jax_f64(norm_var):
    feats = np.random.RandomState(1).randn(3, 13, D) * 3 + 1
    jm, js = jcmvn.cmvn_stats_masked(jnp.asarray(feats), jnp.asarray(LENGTHS))
    tm, ts = tcmvn.cmvn_stats_masked(torch.as_tensor(feats), torch.as_tensor(LENGTHS))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        tcmvn.apply_cmvn(torch.as_tensor(feats), tm, ts, norm_var).numpy(),
        np.asarray(jcmvn.apply_cmvn(jnp.asarray(feats), jm, js, norm_var)),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        tcmvn.apply_cmvn_per_utterance(torch.as_tensor(feats),
                                       torch.as_tensor(LENGTHS), norm_var).numpy(),
        np.asarray(jcmvn.apply_cmvn_per_utterance(jnp.asarray(feats),
                                                  jnp.asarray(LENGTHS), norm_var)),
        rtol=1e-10, atol=1e-12)


def test_posteriors_match_jax_f64():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, CLASSES)
    counts = rng.randint(1, 100, CLASSES)
    jprior = jpost.compute_log_prior_from_counts(counts)
    tprior = tpost.compute_log_prior_from_counts(counts)
    np.testing.assert_array_equal(tprior, jprior)
    tl = torch.as_tensor(logits)
    for kw in (dict(log_prior=tprior), dict(add_softmax=True), {}):
        jkw = dict(kw, log_prior=jprior) if "log_prior" in kw else kw
        np.testing.assert_allclose(
            tpost.genclassifier_outputs(tl, **kw).numpy(),
            np.asarray(jpost.genclassifier_outputs(jnp.asarray(logits), **jkw)),
            rtol=1e-12, atol=1e-12)
    embeds = [rng.randn(2, 5, 3), rng.randn(2, 5, 4)]

    def jfn(f, n):
        return [jnp.asarray(e) for e in embeds], jnp.asarray(logits)

    def tfn(f, n):
        return [torch.as_tensor(e) for e in embeds], tl

    for layer in (0, 1, 2):
        np.testing.assert_allclose(
            tpost.extract_posteriors(tfn, None, None, layer=layer).numpy(),
            np.asarray(jpost.extract_posteriors(jfn, None, None, layer=layer)),
            rtol=1e-12, atol=1e-12)


def test_hybrid_slice_matches_jax():
    """wav -> FDLP (fast) -> global CMVN -> GRU -> log-likelihoods, same
    waveforms and weights on both sides. Valid-frame log-likelihoods agree
    to atol 1e-2: f32 feature noise up to 2e-3 (the FDLP bound) passes
    through CMVN and the GRU stack. Observed maximum: 7.3e-7 (2 ragged
    utterances, CPU float32, seed 3)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 12000) * 1000).astype(np.float32)
    lens = np.array([12000, 8500], np.int32)
    x[1, 8500:] = 0
    kw = dict(nfilters=D)

    jfeats, jn = jax_fdlp(x, lens, JaxFdlpConfig(lpc_backend="scan", **kw))
    mean, std = jcmvn.cmvn_stats_masked(jfeats, jn)
    jfeats = jcmvn.apply_cmvn(jfeats, mean, std)
    model, params = _jax_model()
    counts = rng.randint(1, 1000, CLASSES)
    jll = np.asarray(jpost.genclassifier_outputs(
        model.apply(params, jfeats, jn),
        jnp.asarray(jpost.compute_log_prior_from_counts(counts))))

    tfeats, tn = fdlp_spectrogram_batch(x, lens, FdlpConfig(**kw), device="cpu")
    tfeats = tcmvn.apply_cmvn(tfeats, *tcmvn.cmvn_stats_masked(tfeats, tn))
    with torch.no_grad():
        tll = tpost.genclassifier_outputs(
            _port_model(params)(tfeats, tn),
            tpost.compute_log_prior_from_counts(counts)).numpy()

    jn = np.asarray(jn)
    np.testing.assert_array_equal(tn.numpy(), jn)
    err = np.max(np.abs(_valid(tll, jn) - _valid(jll, jn)))
    assert np.isfinite(tll).all()
    assert err < 1e-2, err
