"""Import reference PyTorch checkpoints into native flax checkpoints.

The port's own copy of speech_recognition_tools_tpu/io/torch_import.py:
host code (numpy and torch.load), every family's key mapping unchanged,
the same flax trees, and checkpoints written with the port's
train/checkpoint.py, which gives the JAX package's bytes and config.json.
The port's models load every family: the recurrent ones (nnetRNN, the
feedforward and linear stacks, the multitask AEs, the VAEs, ARVAE, the
CURL models, multimod and the frozen-encoder vae_encoded / curl_encoded
pairs) and the conv ones (cnn, cldnn, vae_cnn, vae_cnn_pool, rs_vae,
modnet, modnet_sigmoid) in dump_outputs (and the recurrent ones in
tandem_feats, pm_score_cli, adapt_am and lifelong_decode), the ESPnet e2e
transformer (recog_e2e) and the ESPnet LM with either cell (recog_e2e
--lm_dir, decode_wfst --rescore_lm_dir). The model names below are the
JAX package's.

The notes that follow are the JAX module's.

The reference saves self-describing torch dicts — constructor hyperparams +
``model_state_dict`` (train_rnn_nnet_classifier.py:273-288) — and its
inference scripts rebuild models from the file alone
(extract_posterior.py:30-36). This module gives users of the reference a
migration path: it maps those trained tensors onto the flax param trees of
the equivalent models here (models/recurrent.py, models/vae.py) and emits a
native self-describing checkpoint (train/checkpoint.py) that every CLI
(dump_outputs, adapt_am, pm_score, lifelong_decode) can consume.

Exactness notes:
  * torch ``nn.GRU`` and ``flax.linen.GRUCell`` share the same gate algebra
    (r, z, n with h' = (1-z)*n + z*h). torch stacks the gates as (r|z|n)
    blocks in ``weight_ih_l0`` [3H, D] / ``weight_hh_l0`` [3H, H] and keeps
    two bias vectors; flax keeps per-gate Dense kernels [D, H] and folds the
    r/z biases (they add *outside* the nonlinearity, so
    ``b = b_ih + b_hh`` is exact) while the n-gate keeps ``b_in`` on the
    input path and ``b_hn`` inside the ``r *`` term — exactly torch's
    placement. The mapping is bit-exact up to float association.
  * The reference's 1x1 ``Conv1d`` output/regression/bottleneck layers
    [out, in, 1] map to Dense kernels ``w[:, :, 0].T``; ``nn.Linear``
    [out, in] maps to ``w.T``.
  * Padded-frame semantics differ benignly: torch's pack/pad machinery
    zero-fills past each length, our masked scans freeze the carry and zero
    the outputs — identical on valid frames (golden-tested in
    tests/test_torch_import.py).

Dropped tensors: the reference ``VAEDecoder`` registers a ``vars`` conv it
never uses in ``forward`` (nnet_models.py:357, only ``means`` is applied);
it is discarded with a note.

Model family is *detected from the state_dict key structure* (the reference
checkpoint does not record the class name — each of its 23 trainers implies
one), so one importer covers every family below:

  nnetFeedforward              -> FeedforwardClassifier   (arch=feedforward)
  nnetLinearWithConv           -> LinearConvStack         (arch=linear)
  nnetRNN                      -> RNNClassifier           (arch=rnn)
  nnetAEClassifierMultitask    -> AEClassifierMultitask   (arch=multitask_ae)
  nnetAEClassifierMultitaskAEAR-> AEClassifierMultitaskAEAR (multitask_aear)
  nnetVAE (recurrent)          -> VAE                     (arch=vae)
  nnetVAEClassifier            -> VAEClassifier           (arch=vae_classifier)
  nnetARVAE                    -> ARVAE                   (arch=arvae)
  nnetCurlMultistreamClassifier-> CurlMultistreamClassifier (arch=curl)
  nnetCurlSupervised           -> CurlSupervised          (arch=curl_unsup)
  nnetRNNMultimod              -> MultistreamRNN          (arch=multimod)
  nnetCNNClassifier            -> CNNFrameClassifier      (arch=cnn)
  nnetCLDNN                    -> CLDNN                   (arch=cldnn)
  nnetVAECNNNopool             -> VAECNNNopool            (arch=vae_cnn)
  nnetVAECNN (pooled)          -> VAECNN                  (arch=vae_cnn_pool)
  nnetVaeRsModulation          -> VaeRsModulation         (arch=rs_vae)
  modulationNet                -> ModulationNet           (arch=modnet)
  modulationSigmoidNet         -> ModulationSigmoidNet    (arch=modnet_sigmoid)
  VAEEncodedClassifier         -> base VAE + head (convert_encoded_classifier)
  curlEncodedClassifier        -> base CURL + head (convert_encoded_classifier)

CNN-family notes: torch Conv2d (NCHW, symmetric (k-1)/2 padding) maps to
flax SAME NHWC kernels by transposing (2,3,1,0); torch ConvTranspose2d is
the conv adjoint, so its kernels are additionally spatially flipped; the
reference's .view(B, C*H, W) flattening is reconciled with our NHWC
(H, C) flattening by permuting the 1x1-head rows (_chw_perm). torch LSTM
gate blocks (i|f|g|o) map onto flax (Optimized)LSTMCell ii/if/ig/io +
hi/hf/hg/ho with biases folded onto the hidden denses. The pooled
nnetVAECNN's unpool indices are runtime values (argmax pooling on both
sides), so it imports as pure weight mapping — but its 2-D Linear heads
bake in the training geometry the .model dict doesn't store, so it needs
--input_hw FEATURE_DIM,NUM_FRAMES. With the modnets included, every
`train_am` --arch except `apc` (an external-clone pretrainer with no
reference checkpoint format) now has an importer.
"""

from __future__ import annotations

import re

import numpy as np


class UnsupportedTorchModel(ValueError):
    pass


def _np(t) -> np.ndarray:
    arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    return arr.astype(np.float32)


# ---------------------------------------------------------------- low level


def gru_cell_from_torch(sd: dict, prefix: str, suffix: str = "_l0") -> dict:
    """torch nn.GRU (single layer; suffix '_l0') or nn.GRUCell
    (suffix '') -> flax GRUCell param dict.

    torch gate stacking order is (reset | update | new) per the torch docs;
    flax GRUCell submodules are ir/iz/in (input path, with bias) and
    hr/hz/hn (hidden path, bias only on hn).
    """
    w_ih = _np(sd[prefix + "weight_ih" + suffix])  # (3H, D)
    w_hh = _np(sd[prefix + "weight_hh" + suffix])  # (3H, H)
    b_ih = _np(sd[prefix + "bias_ih" + suffix])  # (3H,)
    b_hh = _np(sd[prefix + "bias_hh" + suffix])  # (3H,)
    H = w_hh.shape[1]
    wr, wz, wn = w_ih[:H], w_ih[H : 2 * H], w_ih[2 * H :]
    ur, uz, un = w_hh[:H], w_hh[H : 2 * H], w_hh[2 * H :]
    return {
        "ir": {"kernel": wr.T, "bias": b_ih[:H] + b_hh[:H]},
        "iz": {"kernel": wz.T, "bias": b_ih[H : 2 * H] + b_hh[H : 2 * H]},
        "in": {"kernel": wn.T, "bias": b_ih[2 * H :]},
        "hr": {"kernel": ur.T},
        "hz": {"kernel": uz.T},
        "hn": {"kernel": un.T, "bias": b_hh[2 * H :]},
    }


def _count_layers(sd: dict, prefix: str, pattern: str) -> int:
    rx = re.compile(re.escape(prefix) + pattern)
    idx = {int(m.group(1)) for k in sd if (m := rx.fullmatch(k))}
    if not idx or idx != set(range(len(idx))):
        raise UnsupportedTorchModel(
            f"non-contiguous or empty layer list under {prefix!r}"
        )
    return len(idx)


def gru_stack_from_torch(sd: dict, prefix: str) -> tuple[dict, int, int]:
    """torch ModuleList-of-GRUs (`<prefix>layers.N.*`) -> GRUStack params.

    Returns (params, num_layers, hidden_size).
    """
    n = _count_layers(sd, prefix, r"layers\.(\d+)\.weight_ih_l0")
    params = {
        f"gru_{i}": {"cell": gru_cell_from_torch(sd, f"{prefix}layers.{i}.")}
        for i in range(n)
    }
    hidden = _np(sd[f"{prefix}layers.0.weight_hh_l0"]).shape[1]
    return params, n, hidden


def dense_from_linear(sd: dict, prefix: str) -> dict:
    w = _np(sd[prefix + "weight"])  # (out, in)
    return {"kernel": w.T, "bias": _np(sd[prefix + "bias"])}


def dense_from_conv1x1(sd: dict, prefix: str) -> dict:
    w = _np(sd[prefix + "weight"])  # (out, in, 1)
    if w.ndim != 3 or w.shape[-1] != 1:
        raise UnsupportedTorchModel(
            f"{prefix}weight has shape {w.shape}, expected (out, in, 1)"
        )
    return {"kernel": w[:, :, 0].T, "bias": _np(sd[prefix + "bias"])}


def _odd_kernel_only(w: np.ndarray, prefix: str):
    if w.shape[2] % 2 == 0 or w.shape[3] % 2 == 0:
        raise UnsupportedTorchModel(
            f"{prefix}weight has even kernel {w.shape[2:]} — torch's "
            "int((k-1)/2) padding then shrinks the map while flax SAME "
            "pads asymmetrically; only odd kernels map exactly"
        )


def conv2d_from_torch(sd: dict, prefix: str, same_padding=True) -> dict:
    """torch Conv2d (O, I, kh, kw), NCHW -> flax Conv HWIO kernel under
    NHWC. With symmetric (k-1)/2 torch padding the flax side is SAME —
    identical for odd kernels at stride 1, so even kernels are rejected;
    unpadded (VALID) convs map for any kernel (same_padding=False)."""
    w = _np(sd[prefix + "weight"])
    if same_padding:
        _odd_kernel_only(w, prefix)
    return {
        "kernel": w.transpose(2, 3, 1, 0),
        "bias": _np(sd[prefix + "bias"]),
    }


def conv_transpose2d_from_torch(sd: dict, prefix: str) -> dict:
    """torch ConvTranspose2d (I, O, kh, kw) is the conv adjoint
    (convolution); flax ConvTranspose correlates the dilated input with
    the kernel as given, so flip the spatial dims (verified numerically
    in tests/test_torch_import.py)."""
    w = _np(sd[prefix + "weight"])
    _odd_kernel_only(w, prefix)
    w = w[:, :, ::-1, ::-1]
    return {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)),
        "bias": _np(sd[prefix + "bias"]),
    }


def lstm_cell_from_torch(sd: dict, prefix: str, suffix: str = "_l0") -> dict:
    """torch nn.LSTM (single layer; suffix '_l0') or nn.LSTMCell
    (suffix ''); gate blocks i|f|g|o -> flax (Optimized)LSTMCell params
    (input denses ii/if/ig/io bias-free, hidden denses hi/hf/hg/ho carry
    the folded bias)."""
    w_ih = _np(sd[prefix + "weight_ih" + suffix])  # (4H, D)
    w_hh = _np(sd[prefix + "weight_hh" + suffix])  # (4H, H)
    b_ih = _np(sd[prefix + "bias_ih" + suffix])
    b_hh = _np(sd[prefix + "bias_hh" + suffix])
    H = w_hh.shape[1]
    out = {}
    for gi, g in enumerate("ifgo"):
        sl = slice(gi * H, (gi + 1) * H)
        out[f"i{g}"] = {"kernel": w_ih[sl].T}
        out[f"h{g}"] = {"kernel": w_hh[sl].T, "bias": b_ih[sl] + b_hh[sl]}
    return out


def _chw3_perm(C: int, H: int, W: int) -> np.ndarray:
    """torch .view(B, -1) of (C, H, W) (index c*H*W + h*W + w) vs our NHWC
    reshape (index h*W*C + w*C + c): perm[h*W*C + w*C + c] = c*H*W + h*W + w."""
    h = np.arange(H)[:, None, None]
    w = np.arange(W)[None, :, None]
    c = np.arange(C)[None, None, :]
    return (c * (H * W) + h * W + w).reshape(-1)


def _chw_perm(C: int, H: int) -> np.ndarray:
    """Row/col permutation between torch's flattened (C, H) order
    (index c*H + h, from .view(B, C*H, W)) and ours (h*C + c, from the
    NHWC reshape): perm[h*C + c] = c*H + h."""
    h = np.arange(H)[:, None]
    c = np.arange(C)[None, :]
    return (c * H + h).reshape(-1)


# ------------------------------------------------------- composite modules


def _encoder_rnn(sd: dict, prefix: str) -> tuple[dict, dict]:
    """reference encoderRNN -> our EncoderRNN tree. Returns (params, dims)."""
    stack, n, hidden = gru_stack_from_torch(sd, prefix)
    bottleneck = dense_from_conv1x1(sd, prefix + "bottleneck.")
    dims = {
        "num_layers": n,
        "hidden": hidden,
        "bn": bottleneck["bias"].shape[0],
        "input": _np(sd[prefix + "layers.0.weight_ih_l0"]).shape[1],
    }
    return {"GRUStack_0": stack, "bottleneck": bottleneck}, dims


def _decoder_rnn(sd: dict, prefix: str) -> tuple[dict, dict]:
    """reference decoderRNN -> our DecoderRNN tree."""
    stack, n, hidden = gru_stack_from_torch(sd, prefix)
    regression = dense_from_conv1x1(sd, prefix + "regression.")
    dims = {
        "num_layers": n,
        "hidden": hidden,
        "out": regression["bias"].shape[0],
    }
    return {"GRUStack_0": stack, "regression": regression}, dims


def _vae_encoder(sd: dict, prefix: str) -> tuple[dict, dict]:
    stack, n, hidden = gru_stack_from_torch(sd, prefix)
    means = dense_from_conv1x1(sd, prefix + "means.")
    logvars = dense_from_conv1x1(sd, prefix + "vars.")
    dims = {
        "num_layers": n,
        "hidden": hidden,
        "bn": means["bias"].shape[0],
        "input": _np(sd[prefix + "layers.0.weight_ih_l0"]).shape[1],
    }
    return {"GRUStack_0": stack, "means": means, "vars": logvars}, dims


def _vae_decoder(sd: dict, prefix: str) -> tuple[dict, dict]:
    # the reference VAEDecoder's `vars` conv is dead (never applied in
    # forward, nnet_models.py:357-369) — dropped here.
    stack, n, hidden = gru_stack_from_torch(sd, prefix)
    means = dense_from_conv1x1(sd, prefix + "means.")
    dims = {"num_layers": n, "hidden": hidden, "out": means["bias"].shape[0]}
    return {"GRUStack_0": stack, "means": means}, dims


# ----------------------------------------------------- family detect + map


def detect_family(sd: dict) -> str:
    keys = set(sd)
    tops = {k.split(".", 1)[0] for k in keys}
    if "encoder.encoders.0.self_attn.linear_q.weight" in keys or (
        "module.encoder.encoders.0.self_attn.linear_q.weight" in keys
    ):
        return "espnet_e2e"
    if "predictor.lo.weight" in keys or "module.predictor.lo.weight" in keys:
        return "espnet_lm"
    if "vae_model" in tops:
        return "vae_encoded"
    if "curl_model" in tops:
        return "curl_encoded"
    if "subnets" in tops:
        return "multimod"
    if "encoder.regressors.0.weight" in keys:
        return "modnet"
    if "encoder.regression.weight" in keys and "encoder.input_filter.weight" in keys:
        return "modnet_sigmoid"
    if {"cnn_layers", "lstm_layers"} <= tops:
        return "cldnn"
    if {"cnn_layers", "lin"} <= tops:
        return "cnn"
    if "vae_encoder.cnn_layers.0.weight" in keys or (
        "vae_encoder.means.weight" in keys
        and any(".rates" in k for k in keys)
    ):
        return (
            "rs_vae"
            if any(k.startswith("vae_encoder.cnn_layers") and k.endswith(".rates")
                   for k in keys)
            else "vae_cnn"
        )
    if {"curl_encoder", "classifier"} <= tops:
        return "curl"
    if {"curl_encoder", "curl_decoder"} <= tops:
        return "curl_unsup"
    if {"encoder", "classifier", "ae", "ar"} <= tops:
        return "multitask_aear"
    if {"encoder", "classifier", "ae"} <= tops:
        return "multitask_ae"
    if {"vae_encoder", "vae_decoder", "classifier"} <= tops:
        return "vae_classifier"
    if {"vae_encoder", "vae_decoder"} <= tops:
        # nnetARVAE stores a ModuleList: vae_decoder.0.layers...
        if any(re.match(r"vae_decoder\.\d+\.", k) for k in keys):
            return "arvae"
        return "vae"
    if "regression.weight" in keys and any(
        re.match(r"layers\.\d+\.weight_ih_l0", k) for k in keys
    ):
        return "rnn"
    if any(re.match(r"layers\.\d+\.weight", k) for k in keys):
        w0 = _np(sd["layers.0.weight"])
        return "feedforward" if w0.ndim == 2 else "linear"
    raise UnsupportedTorchModel(
        f"unrecognised state_dict structure (top-level modules: {sorted(tops)})"
    )


def _convert_rnn(sd: dict, hyper: dict) -> tuple[dict, dict]:
    stack, n, hidden = gru_stack_from_torch(sd, "")
    regression = dense_from_conv1x1(sd, "regression.")
    params = {"GRUStack_0": stack, "regression": regression}
    cfg = {
        "arch": "rnn",
        "model_class": "RNNClassifier",
        "num_layers": n,
        "hidden_dim": hidden,
        "num_classes": regression["bias"].shape[0],
        "feature_dim": _np(sd["layers.0.weight_ih_l0"]).shape[1],
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_feedforward(sd: dict, hyper: dict) -> tuple[dict, dict]:
    n_total = _count_layers(sd, "", r"layers\.(\d+)\.weight")
    hidden_n = n_total - 1
    params = {
        f"dense_{i}": dense_from_linear(sd, f"layers.{i}.")
        for i in range(hidden_n)
    }
    params["out"] = dense_from_linear(sd, f"layers.{hidden_n}.")
    # a single-Linear checkpoint (hidden_n == 0) has no dense_0; the
    # "first" layer is then the output head (same convention as
    # _convert_linear below)
    first = params.get("dense_0", params["out"])
    cfg = {
        "arch": "feedforward",
        "model_class": "FeedforwardClassifier",
        "num_layers": hidden_n,
        "hidden_dim": first["bias"].shape[0],
        "num_classes": params["out"]["bias"].shape[0],
        "feature_dim": first["kernel"].shape[0],
    }
    return params, cfg


def _convert_linear(sd: dict, hyper: dict) -> tuple[dict, dict]:
    n_total = _count_layers(sd, "", r"layers\.(\d+)\.weight")
    params = {
        f"dense_{i}": dense_from_conv1x1(sd, f"layers.{i}.")
        for i in range(n_total - 1)
    }
    params["out"] = dense_from_conv1x1(sd, f"layers.{n_total - 1}.")
    first = params.get("dense_0", params["out"])
    cfg = {
        "arch": "linear",
        "model_class": "LinearConvStack",
        "num_layers": n_total,
        "hidden_dim": first["bias"].shape[0],
        "num_classes": params["out"]["bias"].shape[0],
        "feature_dim": first["kernel"].shape[0],
    }
    return params, cfg


def _convert_multitask(sd: dict, hyper: dict, with_ar: bool) -> tuple[dict, dict]:
    enc, enc_d = _encoder_rnn(sd, "encoder.")
    cls, cls_d = _decoder_rnn(sd, "classifier.")
    ae, ae_d = _decoder_rnn(sd, "ae.")
    if cls_d["num_layers"] != ae_d["num_layers"]:
        raise UnsupportedTorchModel(
            "classifier and AE decoder depths differ "
            f"({cls_d['num_layers']} vs {ae_d['num_layers']}); the native "
            "CLI config ties them (--num_layers_dec). Build the model "
            "directly from models.recurrent if you need asymmetric depths."
        )
    params = {"encoder": enc, "classifier": cls, "ae": ae}
    cfg = {
        "arch": "multitask_aear" if with_ar else "multitask_ae",
        "model_class": (
            "AEClassifierMultitaskAEAR" if with_ar else "AEClassifierMultitask"
        ),
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": cls_d["num_layers"],
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "num_classes": cls_d["out"],
        "feature_dim": enc_d["input"],
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    if with_ar:
        ar, _ = _decoder_rnn(sd, "ar.")
        params["ar"] = ar
        cfg["time_shift"] = int(hyper.get("time_shift", 1))
    return params, cfg


def _convert_vae(sd: dict, hyper: dict) -> tuple[dict, dict]:
    enc, enc_d = _vae_encoder(sd, "vae_encoder.")
    dec, dec_d = _vae_decoder(sd, "vae_decoder.")
    params = {"encoder": enc, "decoder": dec}
    cfg = {
        "arch": "vae",
        "model_class": "VAE",
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": dec_d["num_layers"],
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "feature_dim": enc_d["input"],
        "num_classes": None,
        "dropout": float(hyper.get("dropout", 0.0)),
        "only_ae": bool(hyper.get("only_AE", hyper.get("only_ae", False))),
        "use_transformer": False,
    }
    return params, cfg


def _convert_vae_classifier(sd: dict, hyper: dict) -> tuple[dict, dict]:
    enc, enc_d = _vae_encoder(sd, "vae_encoder.")
    dec, dec_d = _vae_decoder(sd, "vae_decoder.")
    cls, cls_d = _decoder_rnn(sd, "classifier.")
    params = {"vae_encoder": enc, "vae_decoder": dec, "classifier": cls}
    if cls_d["num_layers"] != dec_d["num_layers"]:
        raise UnsupportedTorchModel(
            "classifier and VAE decoder depths differ; the native CLI "
            "config ties them (--num_layers_dec)."
        )
    cfg = {
        "arch": "vae_classifier",
        "model_class": "VAEClassifier",
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": cls_d["num_layers"],
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "num_classes": cls_d["out"],
        "feature_dim": enc_d["input"],
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_arvae(sd: dict, hyper: dict) -> tuple[dict, dict]:
    enc, enc_d = _vae_encoder(sd, "vae_encoder.")
    num_outs = _count_layers(sd, "", r"vae_decoder\.(\d+)\.layers\.0\.weight_ih_l0")
    params: dict = {"vae_encoder": enc}
    dec_d = None
    for i in range(num_outs):
        dec, dec_d = _vae_decoder(sd, f"vae_decoder.{i}.")
        params[f"decoder_{i}"] = dec
    cfg = {
        "arch": "arvae",
        "model_class": "ARVAE",
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": dec_d["num_layers"],
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "num_classes": None,
        "feature_dim": enc_d["input"],
        # build_model maps time_shift -> num_outs (cli/train_am.py arvae)
        "time_shift": num_outs,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_multimod(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetRNNMultimod -> MultistreamRNN: per-stream rnnSubnets
    (`subnets.{s}.layers.{i}`) + fused GRU stack + conv1x1 regression."""
    mod_num = _count_layers(sd, "", r"subnets\.(\d+)\.layers\.0\.weight_ih_l0")
    params: dict = {}
    sub_d = None
    for s in range(mod_num):
        stack, n_sub, hidden_sub = gru_stack_from_torch(sd, f"subnets.{s}.")
        params[f"subnet_{s}"] = {"GRUStack_0": stack}
        sub_d = (n_sub, hidden_sub)
    fused, n_fused, _ = gru_stack_from_torch(sd, "")
    params["fusion"] = fused
    params["regression"] = dense_from_conv1x1(sd, "regression.")
    in_size = _np(sd["subnets.0.layers.0.weight_ih_l0"]).shape[1]
    cfg = {
        "arch": "multimod",
        "model_class": "MultistreamRNN",
        "comp_num": mod_num,
        "num_layers": sub_d[0],
        "num_layers_dec": n_fused,
        # build_model: hidden_size_subband = hidden_dim // comp_num
        "hidden_dim": mod_num * sub_d[1],
        "num_classes": params["regression"]["bias"].shape[0],
        # without --multi_egs_dirs the CLI splits one feature vector into
        # comp_num contiguous streams
        "feature_dim": mod_num * in_size,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _conv_stack(sd: dict, prefix: str, our_prefix: str):
    """ModuleList of Conv2d (`<prefix>cnn_layers.N`) -> our conv_{i}
    trees + geometry (in/out channel lists, kernel)."""
    n = _count_layers(sd, prefix, r"cnn_layers\.(\d+)\.weight")
    params, ins, outs = {}, [], []
    kern = None
    for i in range(n):
        w = _np(sd[f"{prefix}cnn_layers.{i}.weight"])
        ins.append(int(w.shape[1]))
        outs.append(int(w.shape[0]))
        kern = (int(w.shape[2]), int(w.shape[3]))
        params[f"{our_prefix}{i}"] = conv2d_from_torch(
            sd, f"{prefix}cnn_layers.{i}."
        )
    return params, ins, outs, kern


def _convert_cnn(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetCNNClassifier -> CNNFrameClassifier. The 1x1 output conv
    consumes torch's (C, H) flattening; ours flattens (H, C) — permute
    the Dense rows."""
    params, ins, outs, kern = _conv_stack(sd, "", "conv_")
    if ins[0] != 1:
        raise UnsupportedTorchModel(
            f"expected a single input channel plane, got {ins[0]}"
        )
    lin = dense_from_conv1x1(sd, "lin.")
    C = outs[-1]
    H = lin["kernel"].shape[0] // C
    lin["kernel"] = lin["kernel"][_chw_perm(C, H)]
    params["lin"] = lin
    cfg = {
        "arch": "cnn",
        "model_class": "CNNFrameClassifier",
        "num_layers_dec": len(outs),
        "cnn_out_channels": outs,
        "cnn_kernel": list(kern),
        "hidden_dim": outs[-1] * 8,
        "num_classes": lin["bias"].shape[0],
        "feature_dim": H,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_cldnn(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetCLDNN -> CLDNN (convs -> dim_reduce -> LSTMs -> DNN)."""
    params, ins, outs, kern = _conv_stack(sd, "", "conv_")
    if ins[0] != 1:
        raise UnsupportedTorchModel(
            f"expected a single input channel plane, got {ins[0]}"
        )
    dim_reduce = dense_from_conv1x1(sd, "dim_reduce.")
    C = outs[-1]
    H = dim_reduce["kernel"].shape[0] // C
    dim_reduce["kernel"] = dim_reduce["kernel"][_chw_perm(C, H)]
    params["dim_reduce"] = dim_reduce
    hidden = dim_reduce["bias"].shape[0]
    n_lstm = _count_layers(sd, "", r"lstm_layers\.(\d+)\.weight_ih_l0")
    for i in range(n_lstm):
        params[f"lstm_{i}"] = {
            "cell": lstm_cell_from_torch(sd, f"lstm_layers.{i}.")
        }
    n_dnn = _count_layers(sd, "", r"dnn_layers\.(\d+)\.weight")
    for i in range(n_dnn - 1):
        params[f"dnn_{i}"] = dense_from_conv1x1(sd, f"dnn_layers.{i}.")
    params["dnn_out"] = dense_from_conv1x1(sd, f"dnn_layers.{n_dnn - 1}.")
    cfg = {
        "arch": "cldnn",
        "model_class": "CLDNN",
        "num_layers": n_lstm,
        "num_layers_dec": n_dnn,
        "hidden_dim": hidden,
        "cnn_out_channels": outs,
        "cnn_kernel": list(kern),
        "num_classes": params["dnn_out"]["bias"].shape[0],
        "feature_dim": H,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_vae_cnn_pooled(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetVAECNN (pooled, nnet_models_cnn.py:286) -> VAECNN.

    The unpool indices are runtime values recomputed from each input by
    argmax pooling (both sides break ties toward the first window slot),
    not checkpoint state, so the import is pure weight mapping. The 2-D
    Linear heads flatten torch's (C, H, W) bottleneck; the reference
    .model dict stores no geometry, so the bottleneck (h, w) split must
    come from hyper["input_hw"] = (feature_dim, num_frames) — the exact
    arguments train_CNN_VAE.py:140 constructed the model with.
    """
    params: dict = {}
    conv_params, ins, outs, kern = _conv_stack(
        sd, "vae_encoder.", "enc_conv_"
    )
    params.update(conv_params)
    C = outs[-1]
    means = dense_from_linear(sd, "vae_encoder.means.")
    logvars = dense_from_linear(sd, "vae_encoder.vars.")
    in_features = means["kernel"].shape[0]
    hw = hyper.get("input_hw")
    if hw is None:
        raise UnsupportedTorchModel(
            "pooled nnetVAECNN needs its training geometry to unflatten "
            "the Linear heads: pass --input_hw FEATURE_DIM,NUM_FRAMES "
            "(the reference trainer's config.feature_dim and "
            "left+right+1 context frames, train_CNN_VAE.py:115-140)"
        )
    H0, W0 = int(hw[0]), int(hw[1])
    h, w = H0, W0
    for _ in outs:
        # torch's int(floor((x-2)/2+1)) per 2x2/stride-2 pool == x//2
        h, w = h // 2, w // 2
    if h * w * C != in_features:
        raise UnsupportedTorchModel(
            f"--input_hw {H0},{W0} implies a {h}x{w}x{C} bottleneck "
            f"({h * w * C} features) but the checkpoint's heads expect "
            f"{in_features}"
        )
    perm = _chw3_perm(C, h, w)
    means["kernel"] = means["kernel"][perm]
    logvars["kernel"] = logvars["kernel"][perm]
    params["means"] = means
    params["vars"] = logvars
    expand = dense_from_linear(sd, "vae_decoder.expand_linear.")
    expand["kernel"] = expand["kernel"][:, perm]
    expand["bias"] = expand["bias"][perm]
    params["expand"] = expand
    n_dec = _count_layers(sd, "vae_decoder.", r"cnn_layers\.(\d+)\.weight")
    for i in range(n_dec):
        params[f"dec_conv_{i}"] = conv_transpose2d_from_torch(
            sd, f"vae_decoder.cnn_layers.{i}."
        )
    cfg = {
        "arch": "vae_cnn_pool",
        "model_class": "VAECNN",
        "cnn_in_channels": ins,
        "cnn_out_channels": outs,
        "cnn_kernel": list(kern),
        "bn_dim": means["bias"].shape[0],
        "hidden_dim": outs[-1] * 16,  # cosmetic; geometry keys win
        "num_classes": None,
        "feature_dim": H0,
        "num_frames": W0,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_vae_cnn(sd: dict, hyper: dict, rs: bool) -> tuple[dict, dict]:
    """nnetVAECNNNopool / nnetVaeRsModulation -> VAECNNNopool /
    VaeRsModulation; the pooled nnetVAECNN (2-D Linear heads) routes to
    _convert_vae_cnn_pooled."""
    if _np(sd["vae_encoder.means.weight"]).ndim == 2:
        return _convert_vae_cnn_pooled(sd, hyper)
    params: dict = {}
    ins, outs = [], []
    kern = None
    if rs:
        # plain convs then one rate-scale layer at the end
        idx = 0
        while f"vae_encoder.cnn_layers.{idx}.weight" in sd:
            w = _np(sd[f"vae_encoder.cnn_layers.{idx}.weight"])
            ins.append(int(w.shape[1]))
            outs.append(int(w.shape[0]))
            kern = (int(w.shape[2]), int(w.shape[3]))
            params[f"enc_conv_{idx}"] = conv2d_from_torch(
                sd, f"vae_encoder.cnn_layers.{idx}."
            )
            idx += 1
        rates = _np(sd[f"vae_encoder.cnn_layers.{idx}.rates"])  # (O, I)
        params["enc_rs"] = {
            "rates": rates,
            "scales": _np(sd[f"vae_encoder.cnn_layers.{idx}.scales"]),
        }
        ins.append(int(rates.shape[1]))
        outs.append(int(rates.shape[0]))
        if kern is None:  # rs-only encoder: take the kernel from a plain
            # decoder transpose conv (rates/scales carry no spatial dims)
            w1 = sd.get("vae_decoder.cnn_layers.1.weight")
            if w1 is None:
                raise UnsupportedTorchModel(
                    "cannot recover the rate-scale kernel size from a "
                    "conv-free checkpoint"
                )
            kern = (int(w1.shape[2]), int(w1.shape[3]))
    else:
        conv_params, ins, outs, kern = _conv_stack(
            sd, "vae_encoder.", "enc_conv_"
        )
        params.update(conv_params)
    C = outs[-1]
    means = dense_from_conv1x1(sd, "vae_encoder.means.")
    logvars = dense_from_conv1x1(sd, "vae_encoder.vars.")
    H = means["kernel"].shape[0] // C
    perm = _chw_perm(C, H)
    means["kernel"] = means["kernel"][perm]
    logvars["kernel"] = logvars["kernel"][perm]
    params["means"] = means
    params["vars"] = logvars
    # decoder: expand (cols permuted to our (H, C) order) + transposed
    # convs (first one rate-scale in the rs variant)
    expand = dense_from_conv1x1(sd, "vae_decoder.expand_linear.")
    expand["kernel"] = expand["kernel"][:, perm]
    expand["bias"] = expand["bias"][perm]
    params["expand"] = expand
    if rs:
        params["dec_rs"] = {
            "rates": _np(sd["vae_decoder.cnn_layers.0.rates"]),  # (I, O)
            "scales": _np(sd["vae_decoder.cnn_layers.0.scales"]),
        }
        i = 1
        while f"vae_decoder.cnn_layers.{i}.weight" in sd:
            params[f"dec_conv_{i - 1}"] = conv_transpose2d_from_torch(
                sd, f"vae_decoder.cnn_layers.{i}."
            )
            i += 1
    else:
        n_dec = _count_layers(sd, "vae_decoder.", r"cnn_layers\.(\d+)\.weight")
        for i in range(n_dec):
            params[f"dec_conv_{i}"] = conv_transpose2d_from_torch(
                sd, f"vae_decoder.cnn_layers.{i}."
            )
    cfg = {
        "arch": "rs_vae" if rs else "vae_cnn",
        "model_class": "VaeRsModulation" if rs else "VAECNNNopool",
        "cnn_in_channels": ins,
        "cnn_out_channels": outs,
        "cnn_kernel": list(kern),
        "bn_dim": means["bias"].shape[0],
        "hidden_dim": outs[-1] * 16,  # cosmetic; geometry keys win
        "num_classes": None,
        "feature_dim": H,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _modnet_convs(sd: dict) -> tuple[dict, list, list, int]:
    """modnet encoders use an unpadded (VALID) square-kernel Conv2d
    ModuleList named `encoder.layers.N` (nnet_models.py:761-766)."""
    n = _count_layers(sd, "encoder.", r"layers\.(\d+)\.weight")
    params, ins, outs = {}, [], []
    k = None
    for i in range(n):
        w = _np(sd[f"encoder.layers.{i}.weight"])
        ins.append(int(w.shape[1]))
        outs.append(int(w.shape[0]))
        k = int(w.shape[2])
        params[f"conv_{i}"] = conv2d_from_torch(
            sd, f"encoder.layers.{i}.", same_padding=False
        )
    if ins[0] != 1:
        raise UnsupportedTorchModel(
            f"expected single-plane modnet input, got {ins[0]} channels"
        )
    return params, ins, outs, k


def _convert_modnet(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """modulationNet -> ModulationNet. The patch geometry (H = feat bins,
    W = patch frames) is derived: classifier input = H * head_num; the
    regressor input = C' * H' * W' with H' = H - n(k-1). The reference's
    `input_filter` conv is dead in the gumbel forward (commented out,
    nnet_models.py:796-798) and is dropped."""
    conv_params, ins, outs, k = _modnet_convs(sd)
    n = len(outs)
    head_num = _count_layers(sd, "encoder.", r"regressors\.(\d+)\.weight")
    cls_n = _count_layers(sd, "classifier.", r"layers\.(\d+)\.weight")
    cls0 = _np(sd["classifier.layers.0.weight"])
    if cls0.shape[1] % head_num != 0:
        raise UnsupportedTorchModel(
            f"modnet classifier input {cls0.shape[1]} is not divisible by "
            f"head_num={head_num}; cannot derive the feature-bin count"
        )
    H = cls0.shape[1] // head_num
    reg0 = _np(sd["encoder.regressors.0.weight"])
    freq_num = reg0.shape[0]
    Cp, Hp = outs[-1], H - n * (k - 1)
    if Hp <= 0 or reg0.shape[1] % (Cp * Hp) != 0:
        raise UnsupportedTorchModel(
            f"modnet regressor input {reg0.shape[1]} is not divisible by "
            f"C'*H' = {Cp}*{Hp} (H={H}, kernel={k}, conv layers={n}); "
            f"patch geometry could not be derived"
        )
    Wp = reg0.shape[1] // (Cp * Hp)
    W = Wp + n * (k - 1)
    perm = _chw3_perm(Cp, Hp, Wp)
    enc = dict(conv_params)
    for h in range(head_num):
        d = dense_from_linear(sd, f"encoder.regressors.{h}.")
        d["kernel"] = d["kernel"][perm]
        enc[f"regressor_{h}"] = d
    cls = {
        f"dense_{i}": dense_from_linear(sd, f"classifier.layers.{i}.")
        for i in range(cls_n - 1)
    }
    cls["out"] = dense_from_linear(sd, f"classifier.layers.{cls_n - 1}.")
    params = {"encoder": enc, "classifier": cls}
    cfg = {
        "arch": "modnet",
        "model_class": "ModulationNet",
        "cnn_out_channels": outs,
        "cnn_kernel": [k],
        "freq_num": freq_num,
        "head_num": head_num,
        # build_model reconstructs wind_size as patch_width / 100 (the
        # reference recipes' convention); an exotic wind_size is not
        # recoverable from the state_dict
        "patch_width": W,
        "num_layers_dec": cls_n,
        "hidden_dim": (
            cls0.shape[0] if cls_n > 1 else outs[-1] * 8
        ),
        "num_classes": cls["out"]["bias"].shape[0],
        "feature_dim": H,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_modnet_sigmoid(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """modulationSigmoidNet -> ModulationSigmoidNet (deterministic
    sigmoid-gated variant; the input_filter conv IS live here)."""
    conv_params, ins, outs, k = _modnet_convs(sd)
    n = len(outs)
    cls_n = _count_layers(sd, "classifier.", r"layers\.(\d+)\.weight")
    cls0 = _np(sd["classifier.layers.0.weight"])
    reg = dense_from_linear(sd, "encoder.regression.")
    freq_num = reg["bias"].shape[0]
    if cls0.shape[1] % freq_num != 0:
        raise UnsupportedTorchModel(
            f"modnet classifier input {cls0.shape[1]} is not divisible by "
            f"freq_num={freq_num}; cannot derive the feature-bin count"
        )
    H = cls0.shape[1] // freq_num
    Cp, Hp = outs[-1], H - n * (k - 1)
    if Hp <= 0 or reg["kernel"].shape[0] % (Cp * Hp) != 0:
        raise UnsupportedTorchModel(
            f"modnet regression input {reg['kernel'].shape[0]} is not "
            f"divisible by C'*H' = {Cp}*{Hp} (H={H}, kernel={k}, conv "
            f"layers={n}); patch geometry could not be derived"
        )
    Wp = reg["kernel"].shape[0] // (Cp * Hp)
    W = Wp + n * (k - 1)
    reg["kernel"] = reg["kernel"][_chw3_perm(Cp, Hp, Wp)]
    wf = _np(sd["encoder.input_filter.weight"])  # (1, 1, kf)
    if wf.shape[2] % 2 == 0:
        raise UnsupportedTorchModel(
            "even input_filter kernels pad asymmetrically in torch; only "
            "odd kernels map onto SAME padding"
        )
    enc = dict(conv_params)
    enc["regression"] = reg
    enc["input_filter"] = {
        "kernel": wf.transpose(2, 1, 0),
        "bias": _np(sd["encoder.input_filter.bias"]),
    }
    cls = {
        f"dense_{i}": dense_from_linear(sd, f"classifier.layers.{i}.")
        for i in range(cls_n - 1)
    }
    cls["out"] = dense_from_linear(sd, f"classifier.layers.{cls_n - 1}.")
    params = {"encoder": enc, "classifier": cls}
    cfg = {
        "arch": "modnet_sigmoid",
        "model_class": "ModulationSigmoidNet",
        "cnn_out_channels": outs,
        "cnn_kernel": [k],
        "input_filter_kernel": int(wf.shape[2]),
        "freq_num": freq_num,
        "patch_width": W,
        "num_layers_dec": cls_n,
        "hidden_dim": (
            cls0.shape[0] if cls_n > 1 else outs[-1] * 8
        ),
        "num_classes": cls["out"]["bias"].shape[0],
        "feature_dim": H,
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _curl_encoder(sd: dict, prefix: str) -> tuple[dict, dict]:
    """reference curlEncoder -> our CurlEncoder tree. The reference keeps
    comp_num separate mean/var Linears (nnet_models.py:548-556); ours is one
    Dense with K*bn outputs reshaped to (K, bn) — concatenate the per-
    component weights along the output axis (identical math, one matmul)."""
    stack, n, hidden = gru_stack_from_torch(sd, prefix)
    comp_num = _count_layers(sd, prefix, r"means\.(\d+)\.weight")
    mean_heads = [
        dense_from_linear(sd, f"{prefix}means.{k}.") for k in range(comp_num)
    ]
    var_heads = [
        dense_from_linear(sd, f"{prefix}var.{k}.") for k in range(comp_num)
    ]
    means = {
        "kernel": np.concatenate([h["kernel"] for h in mean_heads], axis=1),
        "bias": np.concatenate([h["bias"] for h in mean_heads]),
    }
    logvars = {
        "kernel": np.concatenate([h["kernel"] for h in var_heads], axis=1),
        "bias": np.concatenate([h["bias"] for h in var_heads]),
    }
    cat = dense_from_linear(sd, prefix + "categorical.")
    dims = {
        "num_layers": n,
        "hidden": hidden,
        "bn": mean_heads[0]["bias"].shape[0],
        "comp_num": comp_num,
        "input": _np(sd[prefix + "layers.0.weight_ih_l0"]).shape[1],
    }
    params = {
        "GRUStack_0": stack,
        "means": means,
        "vars": logvars,
        "categorical": cat,
    }
    return params, dims


def _convert_curl(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetCurlMultistreamClassifier -> CurlMultistreamClassifier."""
    enc, enc_d = _curl_encoder(sd, "curl_encoder.")
    K = enc_d["comp_num"]
    params: dict = {"curl_encoder": enc}
    cls_d = dec_d = None
    streams = {}
    for k in range(K):
        cls, cls_d = _decoder_rnn(sd, f"classifier.{k}.")
        params[f"classifier_{k}"] = cls
        # curlDecoderMultistream: double-indexed ModuleList layers.{k}.{i}
        # + means.{k} (nnet_models.py:602-630); our stream_k is a DecoderRNN
        n_dec = _count_layers(
            sd, f"curl_decoder.layers.{k}.", r"(\d+)\.weight_ih_l0"
        )
        stack = {
            f"gru_{i}": {
                "cell": gru_cell_from_torch(sd, f"curl_decoder.layers.{k}.{i}.")
            }
            for i in range(n_dec)
        }
        streams[f"stream_{k}"] = {
            "GRUStack_0": stack,
            "regression": dense_from_linear(sd, f"curl_decoder.means.{k}."),
        }
        dec_d = {"num_layers": n_dec}
    params["curl_decoder"] = streams
    if cls_d["num_layers"] != dec_d["num_layers"]:
        raise UnsupportedTorchModel(
            "classifier and decoder-stream depths differ; the native CLI "
            "config ties them (--num_layers_dec)."
        )
    cls_hidden = _np(sd["classifier.0.layers.0.weight_hh_l0"]).shape[1]
    if cls_hidden != enc_d["hidden"]:
        raise UnsupportedTorchModel(
            f"hidden_size_classifier ({cls_hidden}) != hidden_size "
            f"({enc_d['hidden']}); the native CLI config ties them "
            "(--hidden_dim). Build CurlMultistreamClassifier directly for "
            "asymmetric widths."
        )
    cfg = {
        "arch": "curl",
        "model_class": "CurlMultistreamClassifier",
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": dec_d["num_layers"],
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "comp_num": K,
        "num_classes": cls_d["out"],
        "feature_dim": enc_d["input"],
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


def _convert_curl_unsup(sd: dict, hyper: dict) -> tuple[dict, dict]:
    """nnetCurlSupervised (CURL AE; one shared decoder) -> CurlSupervised."""
    enc, enc_d = _curl_encoder(sd, "curl_encoder.")
    stack, n_dec, _ = gru_stack_from_torch(sd, "curl_decoder.")
    decoder = {
        "DecoderRNN_0": {
            "GRUStack_0": stack,
            "regression": dense_from_linear(sd, "curl_decoder.means."),
        }
    }
    params = {"curl_encoder": enc, "curl_decoder": decoder}
    cfg = {
        "arch": "curl_unsup",
        "model_class": "CurlSupervised",
        "num_layers": enc_d["num_layers"],
        "num_layers_dec": n_dec,
        "hidden_dim": enc_d["hidden"],
        "bn_dim": enc_d["bn"],
        "comp_num": enc_d["comp_num"],
        "num_classes": None,
        "feature_dim": enc_d["input"],
        "dropout": float(hyper.get("dropout", 0.0)),
    }
    return params, cfg


_CONVERTERS = {
    "curl": _convert_curl,
    "curl_unsup": _convert_curl_unsup,
    "multimod": _convert_multimod,
    "cnn": _convert_cnn,
    "cldnn": _convert_cldnn,
    "vae_cnn": lambda sd, h: _convert_vae_cnn(sd, h, rs=False),
    "rs_vae": lambda sd, h: _convert_vae_cnn(sd, h, rs=True),
    "modnet": _convert_modnet,
    "modnet_sigmoid": _convert_modnet_sigmoid,
    "rnn": _convert_rnn,
    "feedforward": _convert_feedforward,
    "linear": _convert_linear,
    "multitask_ae": lambda sd, h: _convert_multitask(sd, h, with_ar=False),
    "multitask_aear": lambda sd, h: _convert_multitask(sd, h, with_ar=True),
    "vae": _convert_vae,
    "vae_classifier": _convert_vae_classifier,
    "arvae": _convert_arvae,
}


def convert_encoded_classifier(
    sd: dict, hyper: dict | None = None
) -> tuple[dict, dict, dict, dict]:
    """reference {VAE,curl}EncodedClassifier -> (head_vars, head_cfg,
    base_vars, base_cfg).

    The reference embeds the frozen generative model inside the classifier
    checkpoint (nnet_models.py:488-534 `self.vae_model` / `self.curl_model`);
    the native design keeps them as two checkpoints wired by the head
    config's `base_model` path (cli/train_am.py --base_model,
    cli/dump_outputs.py load_frozen_encoder). import_torch_checkpoint
    writes both and fills `base_model` in.
    """
    hyper = dict(hyper or {})
    family = detect_family(sd)
    if family not in ("vae_encoded", "curl_encoded"):
        raise UnsupportedTorchModel(f"not an encoded classifier: {family}")
    base_prefix = "vae_model." if family == "vae_encoded" else "curl_model."
    base_sd = {
        k[len(base_prefix):]: v for k, v in sd.items()
        if k.startswith(base_prefix)
    }
    head_sd = {k: v for k, v in sd.items() if not k.startswith(base_prefix)}
    base_vars, base_cfg = convert_state_dict(base_sd, hyper)
    if family == "curl_encoded" and base_cfg["arch"] != "curl_unsup":
        raise UnsupportedTorchModel(
            "curlEncodedClassifier expects an nnetCurlSupervised base "
            f"(forward unpacks a 2-tuple); found {base_cfg['arch']}"
        )
    lin_params, lin_cfg = _convert_linear(head_sd, hyper)
    head_vars = {"params": {"head": lin_params}}
    head_cfg = _finalize_cfg(
        {
            "arch": family,
            "model_class": (
                "VAEEncodedClassifier" if family == "vae_encoded"
                else "CurlEncodedClassifier"
            ),
            "num_layers": lin_cfg["num_layers"],
            "hidden_dim": lin_cfg["hidden_dim"],
            "num_classes": lin_cfg["num_classes"],
            # the pipeline feature dim is the *base* model's input dim (the
            # head sees latents; build_model takes no feat dim for these)
            "feature_dim": base_cfg["feature_dim"],
        },
        hyper,
    )
    return head_vars, head_cfg, base_vars, base_cfg


def convert_state_dict(sd: dict, hyper: dict | None = None) -> tuple[dict, dict]:
    """Map a reference state_dict -> (variables, config) where `variables`
    is the flax `{'params': tree}` dict `model.apply` takes (and the exact
    pytree the native checkpoints store — train_am saves `model.init(...)`
    output wholesale).

    `hyper` is the rest of the reference checkpoint dict (dropout,
    time_shift, only_AE, ... — anything not derivable from tensor shapes).
    """
    hyper = dict(hyper or {})
    family = detect_family(sd)
    if family in ("vae_encoded", "curl_encoded"):
        raise UnsupportedTorchModel(
            f"{family} embeds a frozen generative model; use "
            "convert_encoded_classifier / import_torch_checkpoint (which "
            "writes base + head checkpoints)"
        )
    params, cfg = _CONVERTERS[family](sd, hyper)
    _finalize_cfg(cfg, hyper)
    return {"params": params}, cfg


def _finalize_cfg(cfg: dict, hyper: dict) -> dict:
    """Defaults every native CLI expects to find in a checkpoint config."""
    cfg.setdefault("num_layers_dec", 1)
    cfg.setdefault("bn_dim", 0)
    cfg.setdefault("dropout", float(hyper.get("dropout", 0.0)))
    cfg.setdefault("comp_num", 2)
    cfg.setdefault("time_shift", 0)
    cfg.setdefault("only_ae", False)
    cfg.setdefault("use_transformer", False)
    cfg.setdefault("expert_parallel", 1)
    cfg["imported_from"] = "torch"
    for key in ("epoch", "lr", "err_p", "num_frames"):
        if key in hyper:
            cfg[f"torch_{key}"] = _scalar(hyper[key])
    return cfg


def _scalar(v):
    try:
        return v.item() if hasattr(v, "item") else v
    except Exception:
        return str(v)


def import_egs_dir(src_dir: str, out_dir: str, num_targets: int | None = None,
                   max_seq_len: int | None = None) -> str:
    """Convert a reference egs directory into a native one.

    The reference's data_prep_for_seq.py dumps per-utterance `<utt>.pt`
    FloatTensors zero-padded to max_seq_len, `lengths.pkl`
    ({'utt.pt': true_len}) and optionally `labels.pkl` (torch dict of
    padded LongTensors) (:93-131, :54-90). Padding is stripped using the
    true lengths so the native bucketing loader (io/egs.py) sees ragged
    utterances, and the result feeds train_am / dump_outputs directly.
    """
    import os
    import pickle

    import torch

    from speech_recognition_tools_tpu_torch.io.egs import build_egs

    with open(os.path.join(src_dir, "lengths.pkl"), "rb") as f:
        lengths = pickle.load(f)

    labels = None
    lab_path = os.path.join(src_dir, "labels.pkl")
    if os.path.exists(lab_path):
        raw = torch.load(lab_path, map_location="cpu", weights_only=False)
        labels = {}
        for k, v in raw.items():
            n = int(lengths.get(k, len(v)))
            labels[k[:-3]] = np.asarray(v)[:n].astype(np.int32)
        if num_targets is None:
            num_targets = int(max(int(v.max()) for v in labels.values())) + 1

    def feats_iter():
        for fname in sorted(os.listdir(src_dir)):
            if not fname.endswith(".pt"):
                continue
            t = torch.load(
                os.path.join(src_dir, fname), map_location="cpu",
                weights_only=False,
            )
            n = int(lengths.get(fname, t.shape[0]))
            yield fname[:-3], np.asarray(t)[:n].astype(np.float32)

    return build_egs(
        feats_iter(), out_dir, labels=labels, num_targets=num_targets,
        max_seq_len=max_seq_len,
    )


def load_torch_checkpoint(path: str) -> tuple[dict, dict]:
    """torch.load a reference .model file -> (state_dict, hyperparams)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
        hyper = {k: v for k, v in blob.items() if k != "model_state_dict"}
        hyper.pop("optimizer_state_dict", None)
    elif isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        # ESPnet-style snapshot: the state_dict rides under 'model'
        sd = blob["model"]
        hyper = {k: v for k, v in blob.items()
                 if k != "model" and isinstance(v, (int, float, str))}
    elif isinstance(blob, dict):
        sd, hyper = blob, {}
    else:  # a pickled nn.Module
        sd, hyper = blob.state_dict(), {}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return sd, hyper


def import_torch_checkpoint(src: str, dest_dir: str, tag: str = "final") -> str:
    """Convert a reference .model file into a native checkpoint directory.

    The result is loadable by every native CLI that rebuilds models from
    checkpoints (cli/dump_outputs.py load_model_from_checkpoint).
    """
    sd, hyper = load_torch_checkpoint(src)
    return import_state_dict(sd, hyper, dest_dir, tag=tag, src=src)


def import_state_dict(
    sd: dict, hyper: dict, dest_dir: str, tag: str = "final",
    src: str = "<state_dict>",
) -> str:
    """Convert an already-loaded reference state_dict (see
    load_torch_checkpoint) into a native checkpoint directory."""
    import os

    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    family = detect_family(sd)
    if family in ("vae_encoded", "curl_encoded"):
        # two checkpoints: the frozen generative base + the classifier head
        # wired to it via the head config's base_model path
        head_vars, head_cfg, base_vars, base_cfg = convert_encoded_classifier(
            sd, hyper
        )
        base_dir = os.path.join(dest_dir, "base")
        save_checkpoint(
            base_dir, tag, base_vars, base_cfg, extra={"imported_from": src}
        )
        head_cfg["base_model"] = base_dir
        return save_checkpoint(
            dest_dir, tag, head_vars, head_cfg, extra={"imported_from": src}
        )
    variables, cfg = convert_state_dict(sd, hyper)
    # native checkpoints store the full flax variables dict (train_am saves
    # model.init(...) output wholesale), so save `variables`, not the inner
    # param tree
    return save_checkpoint(
        dest_dir, tag, variables, cfg,
        extra={"imported_from": src},
    )


# ------------------------------------------------------------- espnet e2e
# The reference's e2e branch does not train with this repo's trainers at
# all — it calls out to ESPnet (e2e/wsj/path.sh:10 MAIN_ROOT=.../espnet;
# conf/train.yaml model-module espnet.nets.pytorch_backend.
# e2e_asr_transformer:E2E). Users migrating from the reference therefore
# hold ESPnet transformer checkpoints (model.acc.best / snapshot.ep.N =
# torch state_dicts), and TransformerASR here was deliberately built
# geometry-compatible with that E2E class (same conv2d VALID subsampling,
# pre-norm blocks, sinusoidal posenc with sqrt(adim) xscale, joint
# CTC/attention heads), so the import is a pure weight mapping.
#
# ESPnet state_dict layout (espnet/nets/pytorch_backend/transformer/*):
#   encoder.embed.conv.{0,2}.{weight,bias}        two stride-2 Conv2d
#   encoder.embed.out.0.{weight,bias}             Linear(adim*f' -> adim)
#   encoder.encoders.N.self_attn.linear_{q,k,v,out}.{weight,bias}
#   encoder.encoders.N.feed_forward.w_{1,2}.{weight,bias}
#   encoder.encoders.N.norm{1,2}.{weight,bias}    pre-norm LayerNorms
#   encoder.after_norm.{weight,bias}
#   ctc.ctc_lo.{weight,bias}                      Linear(adim -> odim)
#   decoder.embed.0.weight                        Embedding(odim, adim)
#   decoder.decoders.N.{self_attn,src_attn}.linear_*.…
#   decoder.decoders.N.feed_forward.w_{1,2}.…  + norm{1,2,3}
#   decoder.after_norm.…  decoder.output_layer.{weight,bias}
#
# Mapping notes:
#   * torch per-head packing (adim = heads*hd rows, head-major) maps onto
#     flax MultiHeadDotProductAttention DenseGeneral kernels by
#     W.T.reshape(in, heads, hd) (q/k/v) and W.T.reshape(heads, hd, out)
#     (out proj); both sides scale queries by 1/sqrt(hd).
#   * ESPnet flattens the conv output .view(b, t, c*f) (channel-major);
#     our NHWC reshape is (f-major, c-minor), so the embed Linear kernel
#     rows are permuted with _chw_perm(C, f').
#   * aheads is NOT recoverable from the state_dict (linear_q is always
#     (adim, adim)); it must come from the training conf (train.yaml
#     `aheads`), so the CLI requires --aheads.


def _espnet_ln(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[prefix + "weight"]),
            "bias": _np(sd[prefix + "bias"])}


def mha_from_espnet(sd: dict, prefix: str, aheads: int) -> dict:
    """espnet MultiHeadedAttention linear_{q,k,v,out} -> flax
    MultiHeadDotProductAttention {query,key,value,out} params."""
    wq = _np(sd[prefix + "linear_q.weight"])
    adim = wq.shape[0]
    if adim % aheads:
        raise UnsupportedTorchModel(
            f"adim {adim} not divisible by aheads={aheads} at {prefix}"
        )
    hd = adim // aheads

    def qkv(nm):
        w = _np(sd[prefix + f"linear_{nm}.weight"])  # (adim, in)
        b = _np(sd[prefix + f"linear_{nm}.bias"])
        return {"kernel": w.T.reshape(w.shape[1], aheads, hd),
                "bias": b.reshape(aheads, hd)}

    wo = _np(sd[prefix + "linear_out.weight"])  # (out, adim)
    return {
        "query": qkv("q"), "key": qkv("k"), "value": qkv("v"),
        "out": {"kernel": wo.T.reshape(aheads, hd, wo.shape[0]),
                "bias": _np(sd[prefix + "linear_out.bias"])},
    }


def _espnet_enc_layer(sd: dict, i: int, aheads: int) -> dict:
    p = f"encoder.encoders.{i}."
    return {
        "LayerNorm_0": _espnet_ln(sd, p + "norm1."),
        "MultiHeadDotProductAttention_0": mha_from_espnet(
            sd, p + "self_attn.", aheads
        ),
        "LayerNorm_1": _espnet_ln(sd, p + "norm2."),
        "Dense_0": dense_from_linear(sd, p + "feed_forward.w_1."),
        "Dense_1": dense_from_linear(sd, p + "feed_forward.w_2."),
    }


def _espnet_dec_layer(sd: dict, i: int, aheads: int) -> dict:
    p = f"decoder.decoders.{i}."
    return {
        "LayerNorm_0": _espnet_ln(sd, p + "norm1."),
        "MultiHeadDotProductAttention_0": mha_from_espnet(
            sd, p + "self_attn.", aheads
        ),
        "LayerNorm_1": _espnet_ln(sd, p + "norm2."),
        "MultiHeadDotProductAttention_1": mha_from_espnet(
            sd, p + "src_attn.", aheads
        ),
        "LayerNorm_2": _espnet_ln(sd, p + "norm3."),
        "Dense_0": dense_from_linear(sd, p + "feed_forward.w_1."),
        "Dense_1": dense_from_linear(sd, p + "feed_forward.w_2."),
    }


def convert_espnet_e2e(sd: dict, aheads: int, mtlalpha: float = 0.3,
                       attn_chunk: int = 0,
                       attn_left_chunks: int = -1) -> tuple[dict, dict]:
    """ESPnet E2E transformer state_dict -> (flax variables, cfg dict)
    loadable by cli/recog_e2e.py::_load (and every downstream consumer:
    streaming, serving, ring/PP encode, CL fusion)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    for req in ("encoder.embed.conv.0.weight", "encoder.embed.out.0.weight",
                "decoder.embed.0.weight", "ctc.ctc_lo.weight"):
        if req not in sd:
            raise UnsupportedTorchModel(
                f"missing {req!r} — not an ESPnet conv2d-input transformer "
                "E2E state_dict (only transformer-input-layer: conv2d "
                "models are supported)"
            )
    n_enc = _count_layers(sd, "encoder.",
                          r"encoders\.(\d+)\.norm1\.weight")
    n_dec = _count_layers(sd, "decoder.",
                          r"decoders\.(\d+)\.norm1\.weight")
    adim = _np(sd["encoder.embed.conv.0.weight"]).shape[0]
    eunits = _np(sd["encoder.encoders.0.feed_forward.w_1.weight"]).shape[0]
    dunits = _np(sd["decoder.decoders.0.feed_forward.w_1.weight"]).shape[0]
    odim = _np(sd["ctc.ctc_lo.weight"]).shape[0]

    # embed Linear: espnet flattens (b, c, t, f) -> (b, t, c*f'); ours is
    # (f'-major, c-minor), so permute the kernel rows
    w_out = _np(sd["encoder.embed.out.0.weight"])  # (adim, C*f')
    if w_out.shape[1] % adim:
        raise UnsupportedTorchModel(
            f"embed.out.0 input dim {w_out.shape[1]} is not a multiple of "
            f"adim={adim}; unexpected subsampling geometry"
        )
    fprime = w_out.shape[1] // adim
    embed = {
        "Conv_0": conv2d_from_torch(sd, "encoder.embed.conv.0.",
                                    same_padding=False),
        "Conv_1": conv2d_from_torch(sd, "encoder.embed.conv.2.",
                                    same_padding=False),
        "Dense_0": {
            "kernel": w_out.T[_chw_perm(adim, fprime)],
            "bias": _np(sd["encoder.embed.out.0.bias"]),
        },
    }
    encoder = {"embed": embed,
               "after_norm": _espnet_ln(sd, "encoder.after_norm.")}
    for i in range(n_enc):
        encoder[f"layer_{i}"] = _espnet_enc_layer(sd, i, aheads)
    decoder = {
        "embed": {"embedding": _np(sd["decoder.embed.0.weight"])},
        "after_norm": _espnet_ln(sd, "decoder.after_norm."),
        "output": dense_from_linear(sd, "decoder.output_layer."),
    }
    for i in range(n_dec):
        decoder[f"layer_{i}"] = _espnet_dec_layer(sd, i, aheads)
    variables = {"params": {
        "encoder": encoder,
        "decoder": decoder,
        "ctc_head": dense_from_linear(sd, "ctc.ctc_lo."),
    }}
    cfg = {
        "model_class": "TransformerASR",
        "arch": "espnet_e2e",
        "vocab_size": odim,
        "adim": adim, "aheads": aheads,
        "elayers": n_enc, "eunits": eunits,
        "dlayers": n_dec, "dunits": dunits,
        "mtlalpha": float(mtlalpha), "lsm_weight": 0.1,
        "encoder_type": "transformer",
    }
    if attn_chunk > 0:
        # decode-time chunked attention: an APPROXIMATION for a model
        # trained with full context, recorded so srt-serve / --streaming
        # can run it; offline recog then applies the same chunk mask,
        # keeping every decode path self-consistent
        cfg["attn_chunk"] = int(attn_chunk)
        cfg["attn_left_chunks"] = int(attn_left_chunks)
    return variables, cfg


def espnet_vocab_from_units(units_path: str, odim: int) -> dict:
    """ESPnet char dict ('token id' lines, ids from 1; 0 is the implicit
    CTC <blank>, odim-1 the implicit <sos/eos>) -> our vocab.json dict."""
    vocab = {"<blank>": 0}
    with open(units_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise UnsupportedTorchModel(
                    f"bad units line {line!r} (want 'token id')"
                )
            tok, idx = parts[0], int(parts[1])
            vocab[tok] = idx
    vocab.setdefault("<sos/eos>", odim - 1)
    ids = sorted(vocab.values())
    if ids != list(range(odim)):
        raise UnsupportedTorchModel(
            f"units file covers ids {ids[:3]}..{ids[-3:]} but the model's "
            f"odim is {odim}; pass the dict the model was trained with"
        )
    return vocab


def load_espnet_checkpoint(path: str) -> dict:
    """torch.load an ESPnet model file (model.acc.best = bare state_dict,
    or a snapshot dict carrying one under 'model')."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    if isinstance(blob, dict) and "model" in blob and isinstance(
        blob["model"], dict
    ):
        blob = blob["model"]
    if not isinstance(blob, dict):
        raise UnsupportedTorchModel(f"cannot read a state_dict from {path}")
    return blob


def import_espnet_model(src: str, dest_dir: str, units: str, aheads: int,
                        mtlalpha: float = 0.3, tag: str = "final_avg",
                        attn_chunk: int = 0, attn_left_chunks: int = -1,
                        sd: dict | None = None) -> str:
    """ESPnet E2E checkpoint + char dict -> a native e2e model directory
    (checkpoint under `tag` + vocab.json) that recog_e2e loads exactly
    like a train_e2e-produced one. ESPnet models are trained with FULL
    encoder context, so streaming/serving them needs a decode-time chunk
    geometry recorded at import (`attn_chunk`/`attn_left_chunks` — an
    approximation, not the exact offline result); without it the import
    is offline-decode only."""
    import os

    from speech_recognition_tools_tpu_torch.io.text import save_vocab
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    if sd is None:
        sd = load_espnet_checkpoint(src)
    variables, cfg = convert_espnet_e2e(
        sd, aheads, mtlalpha=mtlalpha, attn_chunk=attn_chunk,
        attn_left_chunks=attn_left_chunks,
    )
    vocab = espnet_vocab_from_units(units, cfg["vocab_size"])
    path = save_checkpoint(dest_dir, tag, variables, cfg,
                           extra={"imported_from": src})
    save_vocab(vocab, os.path.join(dest_dir, "vocab.json"))
    return path


# ------------------------------------------------------------- espnet lm
# The reference trains its fusion LMs with ESPnet lm_train.py too
# (e2e/wsj/run_fdlp_e1.sh:405-417; conf/lm.yaml 1x1000). ESPnet's
# DefaultRNNLM (espnet/nets/pytorch_backend/lm/default.py) is
# ClassifierWithState(RNNLM(embed -> ModuleList of LSTMCell/GRUCell ->
# Linear lo)), so its state_dicts carry:
#   predictor.embed.weight                     Embedding(n_vocab, n_embed)
#   predictor.rnn.N.{weight,bias}_{ih,hh}      nn.LSTMCell / nn.GRUCell
#   predictor.lo.{weight,bias}                 Linear(n_units, n_vocab)
# The cell type is derived from the gate-block count (4H rows = LSTM,
# 3H = GRU). Our RNNLM(cell=...) rebuilds either exactly; only
# CHARACTER LMs make sense to import (token ids must be the e2e model's
# char-dict ids — the reference's word-LM fusion is a different,
# multi-level mechanism).


def convert_espnet_lm(sd: dict) -> tuple[dict, dict]:
    """ESPnet DefaultRNNLM state_dict -> (flax variables, cfg dict)
    loadable by cli/recog_e2e.py::_load_lm for shallow fusion."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if "predictor.embed.weight" not in sd:
        raise UnsupportedTorchModel(
            "missing predictor.embed.weight — not an ESPnet DefaultRNNLM "
            "state_dict (sequential RNNLM variants are unsupported)"
        )
    n = _count_layers(sd, "predictor.", r"rnn\.(\d+)\.weight_ih")
    emb = _np(sd["predictor.embed.weight"])  # (n_vocab, n_embed)
    w_ih0 = _np(sd["predictor.rnn.0.weight_ih"])
    w_hh0 = _np(sd["predictor.rnn.0.weight_hh"])
    hidden = w_hh0.shape[1]
    gates = w_ih0.shape[0] // hidden
    if gates == 4:
        cell = "lstm"
        params = {
            f"rnn_{i}": {"cell": lstm_cell_from_torch(
                sd, f"predictor.rnn.{i}.", suffix=""
            )}
            for i in range(n)
        }
    elif gates == 3:
        cell = "gru"
        params = {"rnn": {
            f"gru_{i}": {"cell": gru_cell_from_torch(
                sd, f"predictor.rnn.{i}.", suffix=""
            )}
            for i in range(n)
        }}  # GRUStack scope: rnn/gru_i/cell
    else:
        raise UnsupportedTorchModel(
            f"rnn.0.weight_ih has {w_ih0.shape[0]} rows for hidden "
            f"{hidden} — neither LSTM (4H) nor GRU (3H)"
        )
    tree = {
        "embed": {"embedding": emb},
        "output": dense_from_linear(sd, "predictor.lo."),
    }
    tree.update(params)
    cfg = {
        "model_class": "RNNLM", "arch": "espnet_lm",
        "vocab_size": emb.shape[0], "embed_dim": emb.shape[1],
        "hidden": hidden, "layers": n, "cell": cell,
    }
    return {"params": tree}, cfg


def import_espnet_lm(src: str, dest_dir: str, tag: str = "final",
                     units: str | None = None,
                     sd: dict | None = None) -> str:
    """ESPnet LM checkpoint (rnnlm.model.best / snapshots) -> a native
    LM directory for `srt-recog-e2e --lm_dir` shallow fusion. Pass the
    char dict as `units` to also write vocab.json, making the directory
    a full train_lm drop-in (decode_wfst --rescore_lm_dir needs it)."""
    import os

    if sd is None:
        sd = load_espnet_checkpoint(src)
    variables, cfg = convert_espnet_lm(sd)
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    path = save_checkpoint(dest_dir, tag, variables, cfg,
                           extra={"imported_from": src})
    if units:
        from speech_recognition_tools_tpu_torch.io.text import save_vocab

        vocab = espnet_vocab_from_units(units, cfg["vocab_size"])
        save_vocab(vocab, os.path.join(dest_dir, "vocab.json"))
    return path
