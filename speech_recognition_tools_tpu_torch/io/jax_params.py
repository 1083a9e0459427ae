"""Carry weights over from the JAX package as numpy arrays.

`rnn_classifier_from_jax` maps the flax parameter tree of
speech_recognition_tools_tpu.models.RNNClassifier onto the state_dict of
models/recurrent.py::RNNClassifier. It is the inverse of
speech_recognition_tools_tpu/io/torch_import.py::gru_cell_from_torch for
this model. Flax names the tree GRUStack_0/gru_{i}/cell/{ir,iz,in,hr,hz,hn}
plus `regression`; its Dense kernels are [in, out], the r and z biases sit
on the input path (hr and hz have none) and hn keeps its bias inside the
`r *` term, exactly where the port's bias_hn sits.
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
