"""Carry weights and optimizer state between the port and the JAX package.

`rnn_classifier_from_jax` maps the flax parameter tree of
speech_recognition_tools_tpu.models.RNNClassifier onto the state_dict of
models/recurrent.py::RNNClassifier. It is the inverse of
speech_recognition_tools_tpu/io/torch_import.py::gru_cell_from_torch for
this model. Flax names the tree GRUStack_0/gru_{i}/cell/{ir,iz,in,hr,hz,hn}
plus `regression`; its Dense kernels are [in, out], the r and z biases sit
on the input path (hr and hz have none) and hn keeps its bias inside the
`r *` term, exactly where the port's bias_hn sits. So the port's bias_ih is
the three input biases stacked r|z|n, and no bias is folded or split off.

`transformer_asr_from_jax` and `rnnlm_from_jax` do the same for
models/transformer_asr.py::TransformerASR (either encoder type: a tree
whose encoder layers hold `mhsa` is a conformer's) and models/rnnlm.py::RNNLM
(either cell: a GRU stack is rnn/gru_{i}/cell, LSTM layers are
rnn_{i}/cell with flax OptimizedLSTMCell's bias-free input kernels
ii/if/ig/io and biased recurrent hi/hf/hg/ho, the layout
io/torch_import.py::lstm_cell_from_torch writes), and raise if any leaf of
the flax tree is left unused.

`rnn_classifier_to_jax`, `transformer_asr_to_jax` and `rnnlm_to_jax` are
the exact inverses (a state_dict, or any dict of tensors keyed like one,
such as an optimizer's moments -> the flax tree with its outer
{"params": ...}): every mapping is a transpose, reshape or split, so the
round trip is bit-exact.
`adam_state_to_jax` / `adam_state_from_jax` carry train/optim.py's Adam
state in the layout flax's `to_state_dict` gives the optax state.
"""

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _nest(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


_GATES = ("r", "z", "n")


def gru_cell_from_jax(cell: dict) -> dict:
    """flax GRUCell params -> MaskedGRULayer state_dict entries."""
    return {
        "weight_ih": _t(np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T
                                        for g in _GATES])),
        "bias_ih": _t(np.concatenate([np.asarray(cell[f"i{g}"]["bias"])
                                      for g in _GATES])),
        "weight_hh": _t(np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T
                                        for g in _GATES])),
        "bias_hn": _t(cell["hn"]["bias"]),
    }


def gru_cell_to_jax(sd: dict, prefix: str) -> dict:
    """MaskedGRULayer entries `<prefix>.{weight_ih,...}` -> flax GRUCell params."""
    w_ih = np.split(_np(sd[f"{prefix}.weight_ih"]), 3)
    b_ih = np.split(_np(sd[f"{prefix}.bias_ih"]), 3)
    w_hh = np.split(_np(sd[f"{prefix}.weight_hh"]), 3)
    cell = {}
    for i, g in enumerate(_GATES):
        cell[f"i{g}"] = {"kernel": w_ih[i].T.copy(), "bias": b_ih[i].copy()}
        cell[f"h{g}"] = {"kernel": w_hh[i].T.copy()}
    cell["hn"]["bias"] = _np(sd[f"{prefix}.bias_hn"]).copy()
    return cell


def rnn_classifier_from_jax(params: dict) -> dict:
    """flax RNNClassifier params (nested dicts of arrays, with or without
    the outer {"params": ...}) -> the port's RNNClassifier state_dict."""
    if "params" in params:
        params = params["params"]
    stack = params["GRUStack_0"]
    n = len(stack)
    if sorted(stack) != sorted(f"gru_{i}" for i in range(n)):
        raise ValueError(f"unexpected GRU stack layout: {sorted(stack)}")
    sd = {}
    for i in range(n):
        for name, val in gru_cell_from_jax(stack[f"gru_{i}"]["cell"]).items():
            sd[f"gru.layers.{i}.{name}"] = val
    reg = params["regression"]
    sd["regression.weight"] = _t(np.asarray(reg["kernel"]).T)
    sd["regression.bias"] = _t(reg["bias"])
    return sd


def rnn_classifier_to_jax(sd: dict) -> dict:
    """The port's RNNClassifier state_dict -> the flax tree
    {"params": {"GRUStack_0": ..., "regression": ...}} of numpy arrays."""
    n = len({k.split(".")[2] for k in sd if k.startswith("gru.layers.")})
    stack = {f"gru_{i}": {"cell": gru_cell_to_jax(sd, f"gru.layers.{i}")} for i in range(n)}
    reg = {"kernel": _np(sd["regression.weight"]).T.copy(),
           "bias": _np(sd["regression.bias"]).copy()}
    return {"params": {"GRUStack_0": stack, "regression": reg}}


def _flatten(tree, prefix=()):
    """Nested dicts -> {path tuple: numpy array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


class _Leaves:
    """The leaves of a flax tree, each taken at most once."""

    def __init__(self, params):
        if "params" in params:
            params = params["params"]
        self.left = _flatten(params)

    def take(self, *path):
        return self.left.pop(tuple(path))

    def subtree(self, *path):
        n = len(path)
        return {k[n:]: self.take(*k) for k in list(self.left) if k[:n] == tuple(path)}

    def done(self):
        if self.left:
            raise ValueError("flax leaves not carried over: "
                             + ", ".join("/".join(k) for k in sorted(self.left)))


def _dense(leaves, path, sd, name):
    sd[f"{name}.weight"] = _t(leaves.take(*path, "kernel").T)
    sd[f"{name}.bias"] = _t(leaves.take(*path, "bias"))


# TransformerASR: each flax leaf is one state_dict entry under one of these
# layout maps, (flax -> port, port -> flax); `h`, the attention's head
# count, is read only on the way to flax.
_KINDS = {
    "same": (lambda a, h: a, lambda w, h: w),
    "dense": (lambda a, h: a.T, lambda w, h: w.T),  # [in, out] <-> (out, in)
    # conv kernels HWIO (3, 3, in, out) <-> (out, in, 3, 3)
    "conv": (lambda a, h: a.transpose(3, 2, 0, 1), lambda w, h: w.transpose(2, 3, 1, 0)),
    # DenseGeneral q/k/v kernels (D, H, hd) <-> a Linear over the flat H * hd
    "heads_in": (lambda a, h: a.reshape(a.shape[0], -1).T,
                 lambda w, h: w.T.reshape(w.shape[1], h, -1)),
    "heads_bias": (lambda a, h: a.reshape(-1), lambda w, h: w.reshape(h, -1)),
    # the out kernel (H, hd, D) <-> a Linear from the flat H * hd
    "heads_out": (lambda a, h: a.reshape(-1, a.shape[-1]).T,
                  lambda w, h: w.T.reshape(h, -1, w.shape[0])),
    # a depthwise Conv kernel (k, 1, D) <-> a grouped Conv1d's (D, 1, k)
    "depthwise": (lambda a, h: a.transpose(2, 1, 0), lambda w, h: w.transpose(2, 1, 0)),
}


def _asr_layout(n_enc: int, n_dec: int, conformer: bool = False) -> list:
    """(flax path, state_dict name, kind) for every TransformerASR leaf;
    `conformer` picks the encoder block's layout."""
    rows = []

    def dense(path, name):
        rows.append(((*path, "kernel"), f"{name}.weight", "dense"))
        rows.append(((*path, "bias"), f"{name}.bias", "same"))

    def norm(path, name):
        rows.append(((*path, "scale"), f"{name}.weight", "same"))
        rows.append(((*path, "bias"), f"{name}.bias", "same"))

    def attention(path, name):
        for p in ("query", "key", "value"):
            rows.append(((*path, p, "kernel"), f"{name}.{p}.weight", "heads_in"))
            rows.append(((*path, p, "bias"), f"{name}.{p}.bias", "heads_bias"))
        rows.append(((*path, "out", "kernel"), f"{name}.out.weight", "heads_out"))
        rows.append(((*path, "out", "bias"), f"{name}.out.bias", "same"))

    def block(path, name, cross):
        # _MHABlock: flax numbers its submodules in creation order
        norms = ["norm_self", "norm_src", "norm_ff"] if cross else ["norm_self", "norm_ff"]
        for i, n in enumerate(norms):
            norm((*path, f"LayerNorm_{i}"), f"{name}.{n}")
        for i, n in enumerate(["self_attn", "src_attn"] if cross else ["self_attn"]):
            attention((*path, f"MultiHeadDotProductAttention_{i}"), f"{name}.{n}")
        dense((*path, "Dense_0"), f"{name}.ff_in")
        dense((*path, "Dense_1"), f"{name}.ff_out")

    def conformer_block(path, name):
        # _ConformerBlock names its submodules explicitly
        for part in ("ffn1", "ffn2"):
            norm((*path, f"{part}_norm"), f"{name}.{part}_norm")
            dense((*path, f"{part}_in"), f"{name}.{part}_in")
            dense((*path, f"{part}_out"), f"{name}.{part}_out")
        norm((*path, "mhsa_norm"), f"{name}.mhsa_norm")
        attention((*path, "mhsa"), f"{name}.mhsa")
        norm((*path, "conv_norm"), f"{name}.conv_norm")
        dense((*path, "conv_pointwise_in"), f"{name}.conv_pointwise_in")
        rows.append(((*path, "conv_depthwise", "kernel"), f"{name}.conv_depthwise.weight",
                     "depthwise"))
        rows.append(((*path, "conv_depthwise", "bias"), f"{name}.conv_depthwise.bias", "same"))
        norm((*path, "conv_mid_norm"), f"{name}.conv_mid_norm")
        dense((*path, "conv_pointwise_out"), f"{name}.conv_pointwise_out")
        norm((*path, "final_norm"), f"{name}.final_norm")

    for i in (0, 1):
        path = ("encoder", "embed", f"Conv_{i}")
        rows.append(((*path, "kernel"), f"encoder.embed.conv{i}.weight", "conv"))
        rows.append(((*path, "bias"), f"encoder.embed.conv{i}.bias", "same"))
    dense(("encoder", "embed", "Dense_0"), "encoder.embed.out")
    for i in range(n_enc):
        if conformer:
            conformer_block(("encoder", f"layer_{i}"), f"encoder.layers.{i}")
        else:
            block(("encoder", f"layer_{i}"), f"encoder.layers.{i}", cross=False)
    norm(("encoder", "after_norm"), "encoder.after_norm")
    rows.append((("decoder", "embed", "embedding"), "decoder.embed.weight", "same"))
    for i in range(n_dec):
        block(("decoder", f"layer_{i}"), f"decoder.layers.{i}", cross=True)
    norm(("decoder", "after_norm"), "decoder.after_norm")
    dense(("decoder", "output"), "decoder.output")
    dense(("ctc_head",), "ctc_head")
    return rows


def _count_layers(names, *path):
    return sum(1 for n in {k[len(path)] for k in names if k[: len(path)] == path}
               if n.startswith("layer_"))


def transformer_asr_from_jax(params: dict) -> dict:
    """flax TransformerASR params (with or without the outer {"params":
    ...}; either encoder type) -> the port's TransformerASR state_dict."""
    leaves = _Leaves(params)
    names = list(leaves.left)
    conformer = any(k[:3] == ("encoder", "layer_0", "mhsa") for k in names)
    sd = {}
    for path, name, kind in _asr_layout(_count_layers(names, "encoder"),
                                        _count_layers(names, "decoder"), conformer):
        sd[name] = _t(_KINDS[kind][0](leaves.take(*path), None))
    leaves.done()
    return sd


def transformer_asr_to_jax(sd: dict, aheads: int) -> dict:
    """The port's TransformerASR state_dict (or a dict keyed like it, of
    either encoder type) -> the flax tree {"params": ...} of numpy arrays;
    `aheads` splits the attention's flat q/k/v/out axes into (heads,
    head_dim)."""
    n_enc = len({k.split(".")[2] for k in sd if k.startswith("encoder.layers.")})
    n_dec = len({k.split(".")[2] for k in sd if k.startswith("decoder.layers.")})
    layout = _asr_layout(n_enc, n_dec, conformer="encoder.layers.0.mhsa.query.weight" in sd)
    if set(sd) != {name for _, name, _ in layout}:
        raise ValueError("state_dict keys do not match the TransformerASR layout: "
                         f"{sorted(set(sd) ^ {name for _, name, _ in layout})}")
    flat = {path: np.ascontiguousarray(_KINDS[kind][1](_np(sd[name]), aheads))
            for path, name, kind in layout}
    return {"params": _nest(flat)}


_GRU_CELL_LEAVES = {(f"i{g}", leaf) for g in "rzn" for leaf in ("kernel", "bias")} | {
    ("hr", "kernel"), ("hz", "kernel"), ("hn", "kernel"), ("hn", "bias")}


_LSTM_GATES = ("i", "f", "g", "o")
_LSTM_CELL_LEAVES = {(f"i{g}", "kernel") for g in _LSTM_GATES} | {
    (f"h{g}", leaf) for g in _LSTM_GATES for leaf in ("kernel", "bias")}


def lstm_cell_from_jax(cell: dict) -> dict:
    """flax OptimizedLSTMCell params -> MaskedLSTMLayer state_dict entries."""
    return {
        "weight_ih": _t(np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T
                                        for g in _LSTM_GATES])),
        "weight_hh": _t(np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T
                                        for g in _LSTM_GATES])),
        "bias_hh": _t(np.concatenate([np.asarray(cell[f"h{g}"]["bias"])
                                      for g in _LSTM_GATES])),
    }


def lstm_cell_to_jax(sd: dict, prefix: str) -> dict:
    """MaskedLSTMLayer entries `<prefix>.{weight_ih,...}` -> flax
    OptimizedLSTMCell params."""
    w_ih = np.split(_np(sd[f"{prefix}.weight_ih"]), 4)
    w_hh = np.split(_np(sd[f"{prefix}.weight_hh"]), 4)
    b_hh = np.split(_np(sd[f"{prefix}.bias_hh"]), 4)
    cell = {}
    for i, g in enumerate(_LSTM_GATES):
        cell[f"i{g}"] = {"kernel": w_ih[i].T.copy()}
        cell[f"h{g}"] = {"kernel": w_hh[i].T.copy(), "bias": b_hh[i].copy()}
    return cell


def _cell_subtree(leaves, path, want, what):
    cell = {}
    for (gate, leaf), val in leaves.subtree(*path).items():
        cell.setdefault(gate, {})[leaf] = val
    if {(g, leaf) for g in cell for leaf in cell[g]} != want:
        raise ValueError(f"unexpected {what} cell layout in {'/'.join(path)}: {cell.keys()}")
    return cell


def rnnlm_from_jax(params: dict) -> dict:
    """flax RNNLM params (GRU or LSTM cell) -> the port's RNNLM state_dict."""
    leaves = _Leaves(params)
    sd = {"embed.weight": _t(leaves.take("embed", "embedding"))}
    lstm = sorted({k[0] for k in leaves.left if k[0].startswith("rnn_")})
    for i in range(len(lstm)):
        cell = _cell_subtree(leaves, (f"rnn_{i}", "cell"), _LSTM_CELL_LEAVES, "LSTM")
        for name, val in lstm_cell_from_jax(cell).items():
            sd[f"rnn.layers.{i}.{name}"] = val
    for i in range(len({k[1] for k in leaves.left if k[0] == "rnn"})):
        cell = _cell_subtree(leaves, ("rnn", f"gru_{i}", "cell"), _GRU_CELL_LEAVES, "GRU")
        for name, val in gru_cell_from_jax(cell).items():
            sd[f"rnn.layers.{i}.{name}"] = val
    _dense(leaves, ("output",), sd, "output")
    leaves.done()
    return sd


def rnnlm_to_jax(sd: dict) -> dict:
    """The port's RNNLM state_dict (or a dict keyed like it) -> the flax
    tree {"params": {"embed", "rnn" (GRU) or "rnn_{i}" (LSTM), "output"}}
    of numpy arrays."""
    n = len({k.split(".")[2] for k in sd if k.startswith("rnn.layers.")})
    if "rnn.layers.0.bias_hh" in sd:  # an LSTM
        rnn = {f"rnn_{i}": {"cell": lstm_cell_to_jax(sd, f"rnn.layers.{i}")} for i in range(n)}
    else:
        rnn = {"rnn": {f"gru_{i}": {"cell": gru_cell_to_jax(sd, f"rnn.layers.{i}")}
                       for i in range(n)}}
    return {"params": {
        "embed": {"embedding": _np(sd["embed.weight"]).copy()},
        **rnn,
        "output": {"kernel": _np(sd["output.weight"]).T.copy(),
                   "bias": _np(sd["output.bias"]).copy()},
    }}


# ------------------------------------------------------------ optimizer state


def adam_state_to_jax(state: dict, params_to_jax, *, clip: bool,
                      inject: bool = True) -> dict:
    """train/optim.py::ClipAdam's state -> the tree flax's `to_state_dict`
    makes of the matching optax state; `params_to_jax` maps a dict keyed
    like the parameters (the moments) to the flax tree.

    optax.adam(lr) is chain(scale_by_adam, scale_by_learning_rate): with a
    schedule the second holds the schedule's count, with a fixed rate it
    holds nothing; clipping adds an empty first link. A fixed rate is, by
    default, the JAX trainer's `inject_hyperparams` form, which wraps the
    chain with its own count and the learning rate; `inject=False` gives
    plain optax.adam(lr) (train_lm): {"0": {"count", "mu", "nu"}, "1": {}}.
    So, for clip + schedule (train_e2e):
    {"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {"count"}}}.
    """
    count = np.asarray(state["count"], np.int32)
    adam = {"count": count, "mu": params_to_jax(state["mu"]),
            "nu": params_to_jax(state["nu"])}
    fixed = "learning_rate" in state
    chain = {"0": adam, "1": {} if fixed else {"count": count}}
    if clip:
        chain = {"0": {}, "1": chain}
    if not (fixed and inject):
        return chain
    return {"count": count,
            "hyperparams": {"learning_rate": np.asarray(state["learning_rate"], np.float32)},
            "hyperparams_states": {}, "inner_state": chain}


def adam_state_from_jax(tree: dict, params_from_jax, *, clip: bool) -> dict:
    """Inverse of adam_state_to_jax: the optax state tree -> ClipAdam's
    state, with the moments as CPU tensors keyed like the parameters. A
    plain optax.adam(lr) tree holds no learning rate: the caller adds it."""
    fixed = "hyperparams" in tree
    chain = tree["inner_state"] if fixed else tree
    if clip:
        chain = chain["1"]
    adam = chain["0"]
    state = {"count": int(adam["count"]), "mu": params_from_jax(adam["mu"]),
             "nu": params_from_jax(adam["nu"])}
    if fixed:
        state["learning_rate"] = float(np.float32(tree["hyperparams"]["learning_rate"]))
    return state
