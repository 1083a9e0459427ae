"""Self-describing checkpoints, in the JAX package's on-disk layout.

Port of speech_recognition_tools_tpu/train/checkpoint.py. A checkpoint is
a directory `<dir>/<tag>/` with

  config.json   - model class name, hyperparameters and train history
  state.msgpack - {"params": ..., "opt_state"?: ...} as flax writes it

The trees are flax's: nested dicts of arrays named as the flax modules
name them (io/jax_params.py converts a port model's state_dict and its
optimizer state to and from them). io/flax_msgpack.py writes the bytes
`flax.serialization.to_bytes` writes, so either package restores a
checkpoint the other saved.
"""

import json
import os
from typing import Any

import numpy as np

from speech_recognition_tools_tpu_torch.io.flax_msgpack import packb, unpackb


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {str(k): _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(
    directory: str,
    tag: str,
    params: Any,
    config: dict,
    opt_state: Any = None,
    extra: dict | None = None,
):
    """Write `params` (and `opt_state`), flax-layout trees of numpy arrays
    (io/jax_params.py's converters make them), under <directory>/<tag>/.
    Returns the checkpoint path."""
    path = os.path.join(directory, tag)
    os.makedirs(path, exist_ok=True)
    payload = {"params": _to_numpy(params)}
    if opt_state is not None:
        payload["opt_state"] = _to_numpy(opt_state)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(packb(payload))
    meta = dict(config)
    if extra:
        meta["extra"] = extra
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def _check_like(got, want, path="") -> None:
    """Raise ValueError unless `got` has the keys and leaf shapes of `want`."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(map(str, want)):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"checkpoint tree at {path or '/'}: keys {have} "
                             f"!= the template's {sorted(map(str, want))}")
        for k, v in want.items():
            _check_like(got[str(k)], v, f"{path}/{k}")
    elif tuple(np.shape(got)) != tuple(want.shape):
        raise ValueError(f"checkpoint leaf {path}: shape {np.shape(got)} "
                         f"!= the template's {tuple(want.shape)}")


def load_checkpoint(path: str, template: Any = None):
    """Returns (payload, config). Without `template`, the payload is the
    stored tree of numpy arrays. With one (a dict of trees), only its keys
    are returned, each checked against the template's keys and leaf
    shapes; a key the checkpoint lacks raises KeyError, as in the JAX
    package."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = unpackb(f.read())
    if template is None:
        return raw, config
    payload = {}
    for k, v in template.items():
        _check_like(raw[k], v, k)
        payload[k] = raw[k]
    return payload, config


def latest_checkpoint(directory: str) -> str | None:
    """Newest checkpoint dir by mtime (babysitter-restart discovery)."""
    if not os.path.isdir(directory):
        return None
    entries = [
        os.path.join(directory, d)
        for d in os.listdir(directory)
        if os.path.isdir(os.path.join(directory, d))
        and os.path.exists(os.path.join(directory, d, "state.msgpack"))
    ]
    if not entries:
        return None
    return max(entries, key=os.path.getmtime)
