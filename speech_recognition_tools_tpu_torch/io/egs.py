"""Training-example ("egs") building and batched loading (host code).

Copy of speech_recognition_tools_tpu/io/egs.py::EgsConfig, build_egs,
load_egs, iter_egs_batches, and the multi-stream and frame-level loaders
load_egs_multi, iter_egs_batches_multi, build_frame_egs and
iter_frame_batches (the JAX package's io/__init__ imports jax, so the port
keeps its own). Utterances are stored unclipped in flat npz
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


def load_egs_multi(egs_dirs):
    """Load matched utterances from several parallel egs dirs.

    Reference behaviour (datasets.py:42 nnetDataset3Seq): the same utterance
    id is read from each of the parallel egs dirs (one per feature stream);
    lengths and labels come from the first dir. Utterances missing from any
    stream are dropped; streams are cut to the shortest common length.

    Returns (list_of_configs, list of (utt, [stream feats...], labels)).
    """
    cfgs, per_dir = [], []
    for d in egs_dirs:
        cfg, utts = load_egs(d)
        cfgs.append(cfg)
        per_dir.append({k: (f, l) for k, f, l in utts})
    merged = []
    for k, (f0, lab) in per_dir[0].items():
        if not all(k in m for m in per_dir[1:]):
            continue
        streams = [f0] + [m[k][0] for m in per_dir[1:]]
        T = min(s.shape[0] for s in streams)
        streams = [s[:T] for s in streams]
        merged.append((k, streams, lab[:T] if lab is not None else None))
    return cfgs, merged


def iter_egs_batches_multi(
    egs_dirs_or_utts,
    batch_size: int,
    *,
    bucket_multiple: int = 32,
    shuffle_seed: int | None = None,
):
    """Multi-stream variant of iter_egs_batches (reference
    train_multimod_nnet.py / nnetDataset3Seq): yields
    dict(feats=[(B,T,Dk) per stream], labels (B,T) i32 or absent,
    lengths (B,) i32, keys list), bucketed by length like the
    single-stream loader."""
    if (
        isinstance(egs_dirs_or_utts, (list, tuple))
        and egs_dirs_or_utts
        and isinstance(egs_dirs_or_utts[0], str)
        and os.path.isdir(egs_dirs_or_utts[0])
    ):
        _, utts = load_egs_multi(egs_dirs_or_utts)
    else:
        utts = list(egs_dirs_or_utts)
    order = np.argsort([u[1][0].shape[0] for u in utts], kind="stable")
    utts = [utts[i] for i in order]
    batches = [utts[i : i + batch_size] for i in range(0, len(utts), batch_size)]
    if shuffle_seed is not None:
        rs = np.random.RandomState(shuffle_seed)
        rs.shuffle(batches)
    for group in batches:
        B = len(group)
        nstreams = len(group[0][1])
        tmax = _round_up(
            max(s[1][0].shape[0] for s in group), bucket_multiple
        )
        feats = [
            np.zeros((B, tmax, group[0][1][j].shape[1]), np.float32)
            for j in range(nstreams)
        ]
        lengths = np.zeros(B, np.int32)
        has_labels = group[0][2] is not None
        labels = np.zeros((B, tmax), np.int32) if has_labels else None
        keys = []
        for i, (k, streams, l) in enumerate(group):
            for j, s in enumerate(streams):
                feats[j][i, : s.shape[0]] = s
            lengths[i] = streams[0].shape[0]
            if has_labels:
                labels[i, : len(l)] = l
            keys.append(k)
        out = dict(feats=feats, lengths=lengths, keys=keys)
        if has_labels:
            out["labels"] = labels
        yield out


def build_frame_egs(
    feats_iter,
    out_dir: str,
    labels: dict,
    *,
    context: int = 4,
    cmvn: tuple | None = None,
    shard_size: int = 65536,
    shuffle_seed: int = 0,
    num_targets: int | None = None,
):
    """Frame-level shuffled egs for feedforward training.

    Reference behaviour (data_prep_feedforward.py:50-66 + dump_uttwise
    loop): shuffle the scp, splice every frame with +/-context neighbours,
    pool (frame, label) pairs across utterances and dump shuffled
    fixed-size chunks so minibatches are i.i.d. over frames, not
    utterances. Here the global frame pool is permuted once with a seeded
    RNG and stored in flat npz shards.
    """
    os.makedirs(out_dir, exist_ok=True)
    all_feats, all_labs = [], []
    feat_dim = None
    for utt, feat in feats_iter:
        if utt not in labels:
            continue
        feat = np.asarray(feat, np.float32)
        lab = np.asarray(labels[utt], np.int32)
        m = min(len(lab), feat.shape[0])
        feat, lab = feat[:m], lab[:m]
        if cmvn is not None:
            mean, std = cmvn
            feat = (feat - np.asarray(mean)) / np.where(
                np.asarray(std) == 0, 1.0, np.asarray(std)
            )
        if context:
            pad = np.pad(feat, ((context, context), (0, 0)), mode="edge")
            idx = np.arange(m)[:, None] + np.arange(2 * context + 1)[None, :]
            feat = pad[idx].reshape(m, -1)
        feat_dim = feat.shape[1]
        all_feats.append(feat)
        all_labs.append(lab)
    frames = np.concatenate(all_feats, axis=0)
    labs = np.concatenate(all_labs, axis=0)
    perm = np.random.RandomState(shuffle_seed).permutation(len(frames))
    frames, labs = frames[perm], labs[perm]
    for shard_id, off in enumerate(range(0, len(frames), shard_size)):
        np.savez(
            os.path.join(out_dir, f"frame_egs.{shard_id}.npz"),
            feats=frames[off : off + shard_size],
            labels=labs[off : off + shard_size],
        )
    cfg = EgsConfig(
        feat_dim=int(feat_dim or 0),
        num_targets=num_targets,
        context=context,
        cmvn_mean=list(map(float, cmvn[0])) if cmvn is not None else None,
        cmvn_std=list(map(float, cmvn[1])) if cmvn is not None else None,
        extra={"frame_level": True, "num_frames": int(len(frames))},
    )
    with open(os.path.join(out_dir, "egs.config"), "w") as f:
        f.write(cfg.to_json())
    return out_dir


def iter_frame_batches(egs_dir: str, batch_size: int, *, shuffle_seed=None):
    """Yield dict(feats (B, D'), labels (B,)) minibatches from a
    build_frame_egs dir. Frames were globally shuffled at build time; an
    optional per-epoch reshuffle permutes within each shard."""
    shards = sorted(
        f
        for f in os.listdir(egs_dir)
        if f.startswith("frame_egs.") and f.endswith(".npz")
    )
    rs = (
        np.random.RandomState(shuffle_seed) if shuffle_seed is not None else None
    )
    for shard in shards:
        z = np.load(os.path.join(egs_dir, shard), allow_pickle=False)
        feats, labs = z["feats"], z["labels"]
        if rs is not None:
            perm = rs.permutation(len(feats))
            feats, labs = feats[perm], labs[perm]
        # the ragged tail batch is dropped, as in the JAX loader
        for off in range(0, len(feats) - batch_size + 1, batch_size):
            yield dict(
                feats=feats[off : off + batch_size],
                labels=labs[off : off + batch_size],
            )
