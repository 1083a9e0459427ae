"""Training-example ("egs") building and batched loading (host code).

Copy of speech_recognition_tools_tpu/io/egs.py::EgsConfig, build_egs,
load_egs and iter_egs_batches (the JAX package's io/__init__ imports jax,
so the port keeps its own). Utterances are stored unclipped in flat npz
shards (keys, lengths, values and optional frame labels) beside an
egs.config JSON that records the feature transform (CMVN stats, context);
the loader sorts utterances by length (a stable sort) and pads each batch
to its longest utterance rounded up to a bucket multiple. The format is the
JAX package's, so an egs directory built by either package loads in the
other.
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class EgsConfig:
    feat_dim: int
    num_targets: int | None = None
    cmvn_mean: list | None = None
    cmvn_std: list | None = None
    context: int | None = None
    max_seq_len: int | None = None
    extra: dict = field(default_factory=dict)

    def to_json(self):
        return json.dumps(self.__dict__, default=str, indent=2)

    @classmethod
    def from_json(cls, text):
        d = json.loads(text)
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        return cls(**known)


def build_egs(
    feats_iter,
    out_dir: str,
    labels: dict | None = None,
    *,
    cmvn: tuple | None = None,
    context: int | None = None,
    max_seq_len: int | None = None,
    shard_size: int = 512,
    num_targets: int | None = None,
    semisup: bool = False,
):
    """Build an egs directory from an iterator of (utt, feat_matrix).

    Args:
      feats_iter: yields (utt, (T, D) array).
      labels: optional {utt: (T,) int array}; utterances without labels are
        skipped when labels is given unless semisup=True, which fills label
        0 for them.
      cmvn: optional (mean, std) applied on the fly (recorded in config).
      context: optional splicing context (recorded; applied by the loader).
      max_seq_len: optional truncation (None = keep).
    """
    os.makedirs(out_dir, exist_ok=True)
    shard, shard_id = [], 0
    feat_dim = None
    num_utts = 0

    def flush(shard, shard_id):
        if not shard:
            return
        keys = [k for k, *_ in shard]
        lens = np.asarray([f.shape[0] for _, f, _ in shard], np.int32)
        values = np.concatenate([f for _, f, _ in shard], axis=0)
        labs = (
            np.concatenate([l for _, _, l in shard])
            if shard[0][2] is not None
            else None
        )
        path = os.path.join(out_dir, f"egs.{shard_id}.npz")
        payload = dict(keys=np.asarray(keys), lengths=lens, values=values)
        if labs is not None:
            payload["labels"] = labs
        np.savez(path, **payload)

    for utt, feat in feats_iter:
        feat = np.asarray(feat, np.float32)
        lab = None
        if labels is not None:
            if utt not in labels:
                if not semisup:
                    continue
                lab = np.zeros(feat.shape[0], np.int32)
            else:
                lab = np.asarray(labels[utt], np.int32)
            m = min(len(lab), feat.shape[0])
            feat, lab = feat[:m], lab[:m]
        if cmvn is not None:
            mean, std = cmvn
            feat = (feat - np.asarray(mean)) / np.where(
                np.asarray(std) == 0, 1.0, np.asarray(std)
            )
        if max_seq_len is not None and feat.shape[0] > max_seq_len:
            feat = feat[:max_seq_len]
            if lab is not None:
                lab = lab[:max_seq_len]
        feat_dim = feat.shape[1]
        shard.append((utt, feat, lab))
        num_utts += 1
        if len(shard) >= shard_size:
            flush(shard, shard_id)
            shard, shard_id = [], shard_id + 1
    flush(shard, shard_id)

    cfg = EgsConfig(
        feat_dim=int(feat_dim) if feat_dim else 0,
        num_targets=num_targets,
        cmvn_mean=list(map(float, cmvn[0])) if cmvn is not None else None,
        cmvn_std=list(map(float, cmvn[1])) if cmvn is not None else None,
        context=context,
        max_seq_len=max_seq_len,
        extra={"num_utts": num_utts},
    )
    with open(os.path.join(out_dir, "egs.config"), "w") as f:
        f.write(cfg.to_json())
    return out_dir


def load_egs(egs_dir: str):
    """Load all utterances: returns (config, list of (utt, feats, labels))."""
    with open(os.path.join(egs_dir, "egs.config")) as f:
        cfg = EgsConfig.from_json(f.read())
    utts = []
    shards = sorted(
        f for f in os.listdir(egs_dir) if f.startswith("egs.") and f.endswith(".npz")
    )
    for shard in shards:
        z = np.load(os.path.join(egs_dir, shard), allow_pickle=False)
        keys, lens, values = z["keys"], z["lengths"], z["values"]
        labs = z["labels"] if "labels" in z else None
        off = 0
        for k, n in zip(keys, lens):
            f = values[off : off + n]
            l = labs[off : off + n] if labs is not None else None
            utts.append((str(k), f, l))
            off += n
    return cfg, utts


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def iter_egs_batches(
    egs_dir_or_utts,
    batch_size: int,
    *,
    bucket_multiple: int = 32,
    shuffle_seed: int | None = None,
    drop_labels: bool = False,
):
    """Yield padded batches bucketed by length.

    Utterances are sorted by length (so batch-mates are similar), grouped
    into batches, each padded to the batch max rounded up to
    `bucket_multiple`.

    Yields dict(feats (B,T,D) f32, labels (B,T) i32 or absent,
    lengths (B,) i32, keys list).
    """
    if isinstance(egs_dir_or_utts, str):
        _, utts = load_egs(egs_dir_or_utts)
    else:
        utts = list(egs_dir_or_utts)
    order = np.argsort([u[1].shape[0] for u in utts], kind="stable")
    utts = [utts[i] for i in order]
    batches = [utts[i : i + batch_size] for i in range(0, len(utts), batch_size)]
    if shuffle_seed is not None:
        rs = np.random.RandomState(shuffle_seed)
        rs.shuffle(batches)
    for group in batches:
        B = len(group)
        tmax = _round_up(max(f.shape[0] for _, f, _ in group), bucket_multiple)
        D = group[0][1].shape[1]
        feats = np.zeros((B, tmax, D), np.float32)
        lengths = np.zeros(B, np.int32)
        has_labels = group[0][2] is not None and not drop_labels
        labels = np.zeros((B, tmax), np.int32) if has_labels else None
        keys = []
        for i, (k, f, l) in enumerate(group):
            feats[i, : f.shape[0]] = f
            lengths[i] = f.shape[0]
            if has_labels:
                labels[i, : len(l)] = l
            keys.append(k)
        out = dict(feats=feats, lengths=lengths, keys=keys)
        if has_labels:
            out["labels"] = labels
        yield out
