"""Carry weights over from the JAX package as numpy arrays.

`rnn_classifier_from_jax` maps the flax parameter tree of
speech_recognition_tools_tpu.models.RNNClassifier onto the state_dict of
models/recurrent.py::RNNClassifier. It is the inverse of
speech_recognition_tools_tpu/io/torch_import.py::gru_cell_from_torch for
this model. Flax names the tree GRUStack_0/gru_{i}/cell/{ir,iz,in,hr,hz,hn}
plus `regression`; its Dense kernels are [in, out], the r and z biases sit
on the input path (hr and hz have none) and hn keeps its bias inside the
`r *` term, exactly where the port's bias_hn sits.

`transformer_asr_from_jax` and `rnnlm_from_jax` do the same for
models/transformer_asr.py::TransformerASR and models/rnnlm.py::RNNLM, and
raise if any leaf of the flax tree is left unused.
"""

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def gru_cell_from_jax(cell: dict) -> dict:
    """flax GRUCell params -> MaskedGRULayer state_dict entries."""
    gates = ("r", "z", "n")
    return {
        "weight_ih": _t(np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T
                                        for g in gates])),
        "bias_ih": _t(np.concatenate([np.asarray(cell[f"i{g}"]["bias"])
                                      for g in gates])),
        "weight_hh": _t(np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T
                                        for g in gates])),
        "bias_hn": _t(cell["hn"]["bias"]),
    }


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


def _layer_norm(leaves, path, sd, name):
    sd[f"{name}.weight"] = _t(leaves.take(*path, "scale"))
    sd[f"{name}.bias"] = _t(leaves.take(*path, "bias"))


def _attention(leaves, path, sd, name):
    """MultiHeadDotProductAttention: q/k/v kernels (D, H, hd) and biases
    (H, hd), out kernel (H, hd, D) -> Linears over the flat H * hd axis."""
    for p in ("query", "key", "value"):
        k = leaves.take(*path, p, "kernel")
        sd[f"{name}.{p}.weight"] = _t(k.reshape(k.shape[0], -1).T)
        sd[f"{name}.{p}.bias"] = _t(leaves.take(*path, p, "bias").reshape(-1))
    k = leaves.take(*path, "out", "kernel")
    sd[f"{name}.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    sd[f"{name}.out.bias"] = _t(leaves.take(*path, "out", "bias"))


def _block(leaves, path, sd, name, cross):
    """_MHABlock: flax numbers its submodules in creation order."""
    norms = ["norm_self", "norm_src", "norm_ff"] if cross else ["norm_self", "norm_ff"]
    for i, n in enumerate(norms):
        _layer_norm(leaves, (*path, f"LayerNorm_{i}"), sd, f"{name}.{n}")
    attns = ["self_attn", "src_attn"] if cross else ["self_attn"]
    for i, n in enumerate(attns):
        _attention(leaves, (*path, f"MultiHeadDotProductAttention_{i}"), sd, f"{name}.{n}")
    _dense(leaves, (*path, "Dense_0"), sd, f"{name}.ff_in")
    _dense(leaves, (*path, "Dense_1"), sd, f"{name}.ff_out")


def _count_layers(leaves, *path):
    names = {k[len(path)] for k in leaves.left if k[: len(path)] == path}
    return sum(1 for n in names if n.startswith("layer_"))


def transformer_asr_from_jax(params: dict) -> dict:
    """flax TransformerASR params (with or without the outer {"params":
    ...}; transformer encoder) -> the port's TransformerASR state_dict."""
    leaves = _Leaves(params)
    sd = {}
    for i in (0, 1):  # conv kernels (3, 3, in, out) HWIO -> (out, in, 3, 3)
        path = ("encoder", "embed", f"Conv_{i}")
        sd[f"encoder.embed.conv{i}.weight"] = _t(
            leaves.take(*path, "kernel").transpose(3, 2, 0, 1))
        sd[f"encoder.embed.conv{i}.bias"] = _t(leaves.take(*path, "bias"))
    _dense(leaves, ("encoder", "embed", "Dense_0"), sd, "encoder.embed.out")
    for i in range(_count_layers(leaves, "encoder")):
        _block(leaves, ("encoder", f"layer_{i}"), sd, f"encoder.layers.{i}", cross=False)
    _layer_norm(leaves, ("encoder", "after_norm"), sd, "encoder.after_norm")
    sd["decoder.embed.weight"] = _t(leaves.take("decoder", "embed", "embedding"))
    for i in range(_count_layers(leaves, "decoder")):
        _block(leaves, ("decoder", f"layer_{i}"), sd, f"decoder.layers.{i}", cross=True)
    _layer_norm(leaves, ("decoder", "after_norm"), sd, "decoder.after_norm")
    _dense(leaves, ("decoder", "output"), sd, "decoder.output")
    _dense(leaves, ("ctc_head",), sd, "ctc_head")
    leaves.done()
    return sd


_GRU_CELL_LEAVES = {(f"i{g}", leaf) for g in "rzn" for leaf in ("kernel", "bias")} | {
    ("hr", "kernel"), ("hz", "kernel"), ("hn", "kernel"), ("hn", "bias")}


def rnnlm_from_jax(params: dict) -> dict:
    """flax RNNLM params (GRU cell) -> the port's RNNLM state_dict."""
    leaves = _Leaves(params)
    sd = {"embed.weight": _t(leaves.take("embed", "embedding"))}
    for i in range(len({k[1] for k in leaves.left if k[0] == "rnn"})):
        cell = {}
        for (gate, leaf), val in leaves.subtree("rnn", f"gru_{i}", "cell").items():
            cell.setdefault(gate, {})[leaf] = val
        if {(g, leaf) for g in cell for leaf in cell[g]} != _GRU_CELL_LEAVES:
            raise ValueError(f"unexpected GRU cell layout in rnn/gru_{i}: {cell.keys()}")
        for name, val in gru_cell_from_jax(cell).items():
            sd[f"rnn.layers.{i}.{name}"] = val
    _dense(leaves, ("output",), sd, "output")
    leaves.done()
    return sd
