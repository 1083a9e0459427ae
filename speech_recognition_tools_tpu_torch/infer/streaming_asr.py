"""Online (streaming) speech recognition.

Port of speech_recognition_tools_tpu/infer/streaming_asr.py. A
`StreamingRecognizer` takes feature frames as they arrive (e.g. from
dsp/streaming.py::StreamingFdlp), runs the encoder chunk by chunk with
cached left context, and emits incremental greedy-CTC partials and a final
result; `StreamBatcher` serves many streams with one batched step a round;
`OnlineASRPipeline` runs raw audio to tokens.

Exactness contract: a model whose config has `attn_chunk > 0` and
`attn_left_chunks >= 0` gives the same encoder output offline
(`TransformerASR.encode`, chunk-masked) and streamed here, because

  * `Conv2dSubsampling` is VALID, so subsampled frame j depends only on
    input frames 4j..4j+6: the step feeds each chunk's 4 * chunk + 3 input
    frames and gets exactly the offline frames;
  * under the chunk mask, layer l at chunk c attends only to chunks
    [c - left, c] of layer l-1, whose values were final when those chunks
    were current, so a per-layer cache of the last left * chunk block
    inputs (a conformer block's post-ffn1 rows) reproduces the offline
    attention;
  * a conformer's depthwise conv is causal when attn_chunk > 0, so a
    per-layer cache of the last conv_kernel - 1 rows of its input (after
    the GLU) reproduces it; a fresh stream's zero tail is the offline
    conv's zero left pad.

The step reuses the offline model's modules (the encoder's `embed`, each
block's norms, attention, FFNs and conv module, `after_norm`,
`ctc_head`), so it needs no weights of its own. Its caches stay on the
device as a dict of tensors; a round sends x, the positional rows, n_valid and update to the
device and brings the CTC rows back (and the encoder rows when memory is
stored), nothing per stream. A fully masked key row (an idle or fresh
stream) gets finfo.min logits everywhere, hence a uniform softmax and no
NaN, as in flax.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.models.transformer_asr import posenc_host, scalar_as


def _total_subsampled(n_frames: int) -> int:
    """Encoder frames of a finished stream of n raw feature frames (the
    VALID Conv2dSubsampling length)."""
    return ((n_frames - 1) // 2 - 1) // 2 if n_frames >= 7 else 0


def _blank_run_update(blank_id: int, run: int, ctc) -> int:
    """The trailing run of blank-argmax frames after appending this chunk's
    CTC rows: the endpointing signal, in subsampled frames."""
    ids = np.argmax(np.asarray(ctc), axis=-1)
    nonblank = np.nonzero(ids != blank_id)[0]
    if len(nonblank) == 0:
        return run + len(ids)
    return len(ids) - int(nonblank[-1]) - 1


def _greedy_extend(blank_id: int, hyp: list, last_id: int,
                   ctc_rows: np.ndarray, times: list | None = None,
                   pos0: int = 0, confs: list | None = None) -> int:
    """Incremental greedy-CTC collapse: append the new non-blank,
    non-repeated argmax ids to `hyp` and return the new last id. `times`
    gets each appended token's emitting subsampled frame (pos0 + row, the
    first frame of its collapsed run), `confs` its CTC softmax posterior at
    that frame (computed in float64)."""
    ids = np.argmax(ctc_rows, axis=-1)
    if confs is not None and len(ids):
        rows = np.asarray(ctc_rows, np.float64)
        mx = rows.max(axis=-1)
        lse = mx + np.log(np.exp(rows - mx[:, None]).sum(axis=-1))
        probs = np.exp(rows[np.arange(len(ids)), ids] - lse)
    for i, t in enumerate(ids):
        if t != blank_id and t != last_id:
            hyp.append(int(t))
            if times is not None:
                times.append(pos0 + i)
            if confs is not None:
                confs.append(float(probs[i]))
        last_id = int(t)
    return last_id


def _check_frames(frames) -> np.ndarray:
    frames = np.asarray(frames, np.float32)
    if frames.ndim != 2:
        raise ValueError(f"push expects (T, D) features; got {frames.shape}")
    return frames


def _posenc_rows(pos0: int, n: int, dim: int) -> np.ndarray:
    """Rows [pos0, pos0+n) of the sinusoidal table, made on the host per
    chunk, so a stream has no position cap; the offline model's own table
    function, so streamed and offline positions are the same bytes."""
    return posenc_host(n, dim, pos0=pos0)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _stream_block(layer, x_new, kv_raw, kv_mask):
    """An encoder MHABlock computing only the new chunk's queries against
    LayerNorm([cached block inputs | chunk])."""
    q = layer.norm_self(x_new)
    kvn = layer.norm_self(kv_raw)
    x = x_new + layer.self_attn(q, kvn, kv_mask)
    h = F.relu(layer.ff_in(layer.norm_ff(x)))
    return x + layer.ff_out(h)


def _stream_conformer_block(layer, x_new, attn_cache, conv_tail, kv_mask, valid_new):
    """A ConformerBlock (causal conv) on the new chunk only: attention of
    its queries against mhsa_norm([cached post-ffn1 rows | post-ffn1
    chunk]), and a VALID depthwise conv over [cached conv-input tail |
    the chunk's conv input]. Returns (block output, the attention rows
    [cache | chunk], the conv input rows [tail | chunk]); the caches keep
    the last rows of the two."""
    x = x_new + 0.5 * layer.ffn1(x_new)
    kv = torch.cat([attn_cache, x], dim=1)
    x = x + layer.mhsa(layer.mhsa_norm(x), layer.mhsa_norm(kv), kv_mask)
    conv = torch.cat([conv_tail, layer.conv_glu(x, valid_new)], dim=1)
    x = x + layer.conv_out(conv)
    x = x + 0.5 * layer.ffn2(x)
    return layer.final_norm(x), kv, conv


def make_stream_step(model):
    """The per-chunk encoder step, batched over streams, and its cache
    constructor: (step, init_caches).

    step(x_slice, pe_rows, n_valid, update, caches) ->
        (enc_new, ctc_new, new_caches)

      x_slice  (B, 4*chunk+3, D) raw feature slices (zero-padded tail OK);
               each row is an independent stream's next chunk
      pe_rows  (B, chunk, adim) positional rows per stream
      n_valid  (B,) valid subsampled frames per row (chunk except at a
               stream's end, 0 for an idle row)
      update   (B,) bool, rows whose caches advance this round; the commit
               happens inside the step (torch.where per row), so no cache
               is gathered or scattered per stream
      caches   {"layer_i": {"kv": (B, L, adim), "kv_valid": (B,)}}, L =
               attn_left_chunks * attn_chunk, and for a conformer
               "conv": (B, conv_kernel - 1, adim), all on the model's device

    Every argument is a tensor on the model's device.
    """
    c = model.cfg
    if c.attn_chunk <= 0:
        raise ValueError(
            "streaming needs a chunked-attention model (cfg.attn_chunk > 0;"
            " train with train_e2e --attn_chunk)"
        )
    if c.attn_left_chunks < 0:
        raise ValueError(
            "streaming needs bounded left context (cfg.attn_left_chunks"
            " >= 0); unbounded caches cannot be static-shaped"
        )
    chunk = c.attn_chunk
    L = c.attn_left_chunks * chunk
    enc = model.encoder
    conformer = enc.conformer
    tail = c.conv_kernel - 1
    dev = _model_device(model)
    cdt = c.cdtype or torch.float32
    scale = float(np.sqrt(c.adim))
    if c.cdtype is not None:
        scale = scalar_as(scale, c.cdtype)
    cached = torch.arange(L, device=dev)[None, :]
    new = torch.arange(chunk, device=dev)[None, :]

    @torch.no_grad()
    def step(x_slice, pe_rows, n_valid, update, caches):
        B, T, _ = x_slice.shape
        h, _ = enc.embed(x_slice, torch.full((B,), T, device=dev))
        # the host's float32 positional rows cast to the compute dtype, as
        # the offline _embed_scale casts its table: the offline frames
        h = h * scale + pe_rows.to(h.dtype)  # (B, chunk, adim)
        valid_new = new < n_valid[:, None]
        up_row = update[:, None, None]
        new_caches = {}
        for i, layer in enumerate(enc.layers):
            cache = caches[f"layer_{i}"]
            kv_valid = cache["kv_valid"]
            # keys [L cached | chunk new]: cached key j is valid iff
            # j >= L - kv_valid, new keys by n_valid; the whole chunk
            # attends within itself (the offline chunk-mask rule)
            key_mask = torch.cat([cached >= (L - kv_valid)[:, None], valid_new], dim=1)
            kv_mask = key_mask[:, None, None, :]
            nc = {}
            if conformer:
                out, kv, conv = _stream_conformer_block(
                    layer, h, cache["kv"], cache["conv"], kv_mask, valid_new)
                nc["conv"] = torch.where(up_row, conv[:, conv.shape[1] - tail:], cache["conv"])
            else:
                kv = torch.cat([cache["kv"], h], dim=1)
                out = _stream_block(layer, h, kv, kv_mask)
            nc["kv"] = torch.where(up_row, kv[:, -L:], cache["kv"]) if L else cache["kv"]
            nc["kv_valid"] = torch.where(update, (kv_valid + chunk).clamp_max(L), kv_valid)
            new_caches[f"layer_{i}"] = nc
            h = out
        h = enc.after_norm(h)
        return h, model.ctc_head(h.to(model.ctc_head.weight.dtype)), new_caches

    def init_caches(batch: int = 1):
        # the caches hold block activations, so they are in the compute dtype
        caches = {}
        for i in range(c.elayers):
            entry = {"kv": torch.zeros((batch, L, c.adim), dtype=cdt, device=dev),
                     "kv_valid": torch.zeros((batch,), dtype=torch.int32, device=dev)}
            if conformer:
                entry["conv"] = torch.zeros((batch, tail, c.adim), dtype=cdt, device=dev)
            caches[f"layer_{i}"] = entry
        return caches

    return step, init_caches


def _reset_rows(caches, mask):
    """Zero the cache rows selected by the (B,) bool mask: a fresh stream
    taking a slot sees an empty history (kv_valid 0; kv zeroed too) and a
    conformer's zero conv tail, the offline causal conv's left pad."""
    def z(a):
        m = mask.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, torch.zeros_like(a), a)

    return {name: {k: z(v) for k, v in layer.items()} for name, layer in caches.items()}


def _get_row(caches, row: int):
    """One cache row as a batch-1 tree on the host (eviction save)."""
    return {name: {k: v[row : row + 1].cpu() for k, v in layer.items()}
            for name, layer in caches.items()}


def _set_row(caches, row: int, row_tree):
    """Write a batch-1 tree back into cache row `row` (eviction restore)."""
    out = {}
    for name, layer in caches.items():
        out[name] = {}
        for k, v in layer.items():
            v = v.clone()
            v[row : row + 1] = row_tree[name][k].to(device=v.device, dtype=v.dtype)
            out[name][k] = v
    return out


class _StreamState:
    """Host bookkeeping for one stream inside a StreamBatcher."""

    def __init__(self, cfg):
        self.slot = None  # cache row in the batcher's device tree, or None
        self.saved = None  # host copy of the cache row while evicted
        self.buf = None
        self.buf_start = 0
        self.n_buf = 0
        self.n_consumed = 0
        self.pos = 0
        self.hyp: list[int] = []
        self.last_id = cfg.blank_id
        self.mem: list[np.ndarray] = []
        self.ctc: list[np.ndarray] = []
        self.finished = False
        self.blank_run = 0  # trailing blank-argmax frames (endpointing)
        self.times: list[int] = []  # emitting frame of each token in hyp
        self.confs: list[float] = []  # CTC posterior of each token in hyp


class StreamBatcher:
    """Many concurrent streams on one device.

    Each scheduling round stacks the next ready chunk of every stream that
    has one into one fixed-shape batched step, idle rows padding it to
    `max_streams`, and scatters the CTC rows back into independent
    greedy-CTC hypotheses; the results equal single-stream recognition.
    The caches live in one device-resident batched tree, one row per live
    stream (`_StreamState.slot`); streams beyond `max_streams` still work:
    a slot-less ready stream evicts a non-ready one, whose row is saved on
    the host and restored when it next gets a slot (the slow path).

        sb = StreamBatcher(model, max_streams=8)
        a = sb.open(); b = sb.open()
        sb.push(a, feats_a); sb.push(b, feats_b)   # buffer and schedule
        hyp_a = sb.finish(a)                        # flush one stream

    The model (eval mode) sets the device. A batcher is not thread-safe:
    cli/serve.py serialises it with a lock.
    """

    def __init__(self, model, max_streams: int = 8, store_memory: bool = False,
                 defer_s: float = 0.0):
        self.cfg = model.cfg
        self.device = _model_device(model)
        self.step, self._init_caches = make_stream_step(model)
        self.max_streams = max_streams
        self.store_memory = store_memory
        # dynamic batching: with defer_s > 0, push() holds a ready chunk
        # back (up to defer_s seconds) until every live stream has one, so
        # streams pushing independently coalesce into full rounds
        self.defer_s = float(defer_s)
        self._oldest_ready_t = None
        self._streams: dict[int, _StreamState] = {}
        # finished streams move here until release(sid), so drain()'s cost
        # stays bounded by the live streams
        self._finished: dict[int, _StreamState] = {}
        self._next_id = 0
        self.caches = self._init_caches(max_streams)
        self._slot_sid: list = [None] * max_streams  # row -> sid
        self._feat_dim = None
        self.rounds = 0  # batched steps run (each one device round trip)

    def open(self) -> int:
        sid = self._next_id
        self._next_id += 1
        self._streams[sid] = _StreamState(self.cfg)
        slot = self._free_slot()
        if slot is not None:
            self._take_slot(sid, slot)
        return sid

    def release(self, sid: int) -> None:
        """Forget a finished stream's results."""
        self._finished.pop(sid, None)

    def abort(self, sid: int) -> None:
        """Drop a stream now: no tail flush, results discarded, slot freed."""
        if self._finished.pop(sid, None) is not None:
            return
        st = self._streams.pop(sid, None)
        if st is not None and st.slot is not None:
            self._slot_sid[st.slot] = None

    @property
    def chunk(self):
        return self.cfg.attn_chunk

    # -- slot management -------------------------------------------------

    def _free_slot(self):
        try:
            return self._slot_sid.index(None)
        except ValueError:
            return None

    def _take_slot(self, sid: int, slot: int):
        st = self._streams[sid]
        self._slot_sid[slot] = sid
        st.slot = slot
        if st.saved is not None:  # evicted earlier: restore its row
            self.caches = _set_row(self.caches, slot, st.saved)
            st.saved = None
        else:  # fresh stream: zero the row (stale cache of a past owner)
            mask = torch.zeros((self.max_streams,), dtype=torch.bool)
            mask[slot] = True
            self.caches = _reset_rows(self.caches, mask.to(self.device))

    def _drop_slot(self, sid: int, save: bool):
        st = self._streams[sid]
        if st.slot is None:
            return
        if save:
            st.saved = _get_row(self.caches, st.slot)
        self._slot_sid[st.slot] = None
        st.slot = None

    def _ensure_slot(self, sid: int):
        """Give `sid` a cache row, evicting a non-ready slotted stream when
        the tree is full."""
        st = self._streams[sid]
        if st.slot is not None:
            return
        slot = self._free_slot()
        if slot is None:
            victims = [s for s in self._slot_sid if s is not None and s != sid]
            not_ready = [s for s in victims if not self._ready(self._streams[s])]
            self._drop_slot((not_ready or victims)[0], save=True)
            slot = self._free_slot()
        self._take_slot(sid, slot)

    # -- scheduling ------------------------------------------------------

    def _ready(self, st: _StreamState) -> bool:
        return st.n_buf >= st.n_consumed + 4 * self.chunk + 3

    def _slice(self, st: _StreamState, length):
        lo = st.n_consumed - st.buf_start
        sl = st.buf[lo : lo + length]
        if sl.shape[0] < length:
            sl = np.pad(sl, ((0, length - sl.shape[0]), (0, 0)))
        return sl

    def _run_round(self, jobs):
        """jobs: [(sid, n_valid)], each sid holding a slot. Runs ONE batched
        step; idle rows ride along with n_valid 0 and update False."""
        B = self.max_streams
        assert jobs and len(jobs) <= B
        chunk, adim = self.chunk, self.cfg.adim
        x = np.zeros((B, 4 * chunk + 3, self._feat_dim), np.float32)
        pe = np.zeros((B, chunk, adim), np.float32)
        nv = np.zeros((B,), np.int64)
        up = np.zeros((B,), bool)
        rows = []
        for sid, n_valid in jobs:
            st = self._streams[sid]
            r = st.slot
            x[r] = self._slice(st, 4 * chunk + 3)
            pe[r] = _posenc_rows(st.pos, chunk, adim)
            nv[r] = n_valid
            up[r] = n_valid == chunk  # a partial tail does not advance caches
            rows.append((sid, r, n_valid))
        dev = self.device
        h, ctc, self.caches = self.step(
            torch.as_tensor(x).to(dev), torch.as_tensor(pe).to(dev),
            torch.as_tensor(nv).to(dev), torch.as_tensor(up).to(dev), self.caches)
        self.rounds += 1
        ctc = ctc.cpu().numpy()
        if self.store_memory:
            # bfloat16 rows widen exactly to float32 (numpy has no bfloat16)
            h = (h.float() if h.dtype == torch.bfloat16 else h).cpu().numpy()
        for sid, r, n_valid in rows:
            st = self._streams[sid]
            row_ctc = ctc[r, :n_valid]
            if self.store_memory:
                st.mem.append(h[r, :n_valid])
                st.ctc.append(row_ctc)
            st.pos += int(n_valid)
            st.n_consumed += 4 * chunk
            st.last_id = _greedy_extend(
                self.cfg.blank_id, st.hyp, st.last_id, row_ctc,
                st.times, st.pos - int(n_valid), confs=st.confs,
            )
            st.blank_run = _blank_run_update(self.cfg.blank_id, st.blank_run, row_ctc)
            # trim consumed frames: buffers stay bounded
            take = min(st.n_consumed - st.buf_start, st.buf.shape[0])
            if take > 0:
                st.buf = st.buf[take:]
                st.buf_start += take

    def push(self, sid: int, frames) -> list[int]:
        """Buffer frames for stream `sid` and run scheduling rounds while
        any stream has a completed chunk ready."""
        st = self._streams[sid]
        assert not st.finished, "stream already finished"
        frames = _check_frames(frames)
        if st.buf is not None and frames.shape[1] != st.buf.shape[1]:
            raise ValueError(
                f"stream {sid}: feature dim changed "
                f"{st.buf.shape[1]} -> {frames.shape[1]}"
            )
        # all streams share one batched round buffer: a mismatched dim
        # fails THIS push, not a later round mid-flight
        if self._feat_dim is not None and frames.shape[1] != self._feat_dim:
            raise ValueError(
                f"stream {sid}: feature dim {frames.shape[1]} != the "
                f"batcher's established dim {self._feat_dim}"
            )
        st.buf = frames if st.buf is None else np.concatenate([st.buf, frames])
        st.n_buf += frames.shape[0]
        if self._feat_dim is None:
            self._feat_dim = int(st.buf.shape[1])
        self._maybe_drain()
        return list(st.hyp)

    def _maybe_drain(self):
        """The dynamic-batching gate: drain now, unless deferral is on and
        waiting (at most defer_s) could put more streams into the round."""
        if self.defer_s <= 0:
            self.drain()
            return
        live = [st for st in self._streams.values() if not st.finished]
        n_ready = sum(1 for st in live if self._ready(st))
        if n_ready == 0:
            self._oldest_ready_t = None
            return
        if self._oldest_ready_t is None:
            self._oldest_ready_t = time.time()
        if (n_ready >= min(len(live), self.max_streams)
                or time.time() - self._oldest_ready_t >= self.defer_s):
            self.drain()
            self._oldest_ready_t = None

    def drain(self):
        """Process every ready chunk of every live stream, up to
        max_streams chunks a round. Ready slot-less streams take slots
        (evicting non-ready holders) between rounds."""
        while True:
            ready = [sid for sid, st in self._streams.items()
                     if not st.finished and self._ready(st)]
            if not ready:
                return
            for sid in ready:
                if self._streams[sid].slot is not None:
                    continue
                slot = self._free_slot()
                if slot is not None:
                    self._take_slot(sid, slot)
                    continue
                # full: evict only non-ready holders (ready holders run this
                # round and may stop being ready, freeing rows)
                holders = [s for s in self._slot_sid if s is not None]
                not_ready = [s for s in holders if not self._ready(self._streams[s])]
                if not_ready:
                    self._drop_slot(not_ready[0], save=True)
                    self._take_slot(sid, self._free_slot())
            self._run_round([(sid, self.chunk) for sid in ready
                             if self._streams[sid].slot is not None])

    def _flush_tail(self, sid: int):
        """Drain the queued rounds, then run stream `sid`'s buffered tail
        through partial rounds (n_valid <= chunk) until every subsampled
        frame is consumed; shared by finish() and restart()."""
        st = self._streams[sid]
        self.drain()
        total_sub = _total_subsampled(st.n_buf)
        if total_sub - st.pos > 0:
            self._ensure_slot(sid)
        while total_sub - st.pos > 0:
            self._run_round([(sid, min(total_sub - st.pos, self.chunk))])

    def finish(self, sid: int) -> list[int]:
        """Flush stream `sid` (its partial tail rides a round with n_valid <
        chunk and does not advance its cache), free its row and move it to
        the finished set (drop it with release())."""
        if sid in self._finished:
            return list(self._finished[sid].hyp)
        st = self._streams[sid]
        self._flush_tail(sid)
        st.finished = True
        st.memory = (np.concatenate(st.mem, axis=0) if st.mem
                     else np.zeros((0, self.cfg.adim), np.float32))
        st.ctc_logits = (np.concatenate(st.ctc, axis=0) if st.ctc
                         else np.zeros((0, self.cfg.vocab_size), np.float32))
        st.buf = None
        self._drop_slot(sid, save=False)
        st.saved = None
        self._finished[sid] = self._streams.pop(sid)
        return list(st.hyp)

    def restart(self, sid: int) -> tuple[list[int], list[int], list[float]]:
        """Finalise stream `sid`'s current utterance in place and reset its
        row for continued audio (endpointing). The tail flush can still
        emit tokens, so (tokens, times, confs) are read after it; the few
        raw frames below one subsampling step that a flush cannot consume
        are trailing silence at a detected endpoint and are dropped."""
        st = self._streams[sid]
        self._flush_tail(sid)
        slot = st.slot
        if slot is not None:
            self._slot_sid[slot] = None
        self._streams[sid] = _StreamState(self.cfg)
        if slot is not None:
            self._take_slot(sid, slot)  # fresh state: zeroes the row
        return list(st.hyp), list(st.times), list(st.confs)

    def state(self, sid: int) -> _StreamState:
        return self._streams.get(sid) or self._finished[sid]


class StreamingRecognizer:
    """Online recognizer of one stream: push feature frames, read greedy-CTC
    partials, `finish()` for the final tokens. A facade over a one-row
    StreamBatcher, so the chunk arithmetic exists once.

    After `finish()`, `memory`, `enc_len` and `ctc_logits` hold the whole
    streamed encoder output (the offline chunked `encode`'s), for a final
    joint beam (`rescored_partial`, recog_e2e --streaming). With
    `store_memory=False` nothing grows with the stream's length."""

    def __init__(self, model, vocab=None, store_memory=True):
        self.cfg = model.cfg
        self.vocab = vocab
        self.store_memory = store_memory
        self._sb = StreamBatcher(model, max_streams=1, store_memory=store_memory)
        self._sid = None
        self.reset()

    def reset(self):
        if self._sid is not None:
            self._sb.abort(self._sid)
        self._sid = self._sb.open()
        self.memory = None
        self.ctc_logits = None
        self.enc_len = 0

    @property
    def _st(self):
        return self._sb.state(self._sid)

    @property
    def _hyp(self):
        return self._st.hyp

    @property
    def times(self):
        """Emitting subsampled frame of each token (x4 feature frames)."""
        return self._st.times

    @property
    def blank_run(self):
        """Trailing blank-argmax frames (the endpointing signal)."""
        return self._st.blank_run

    @property
    def confs(self):
        """CTC posterior of each token at its emitting frame."""
        return self._st.confs

    @property
    def chunk(self):
        return self.cfg.attn_chunk

    def push(self, frames) -> list[int]:
        """Feed (T, D) feature frames; runs every completed chunk and
        returns the current partial hypothesis."""
        assert not self._st.finished, "reset() before reusing a recognizer"
        return self._sb.push(self._sid, frames)

    def finish(self) -> list[int]:
        """Flush the last partial chunk; returns the final greedy tokens and
        freezes memory / enc_len / ctc_logits."""
        hyp = self._sb.finish(self._sid)
        st = self._st
        self.memory = st.memory
        self.ctc_logits = st.ctc_logits
        self.enc_len = st.pos
        return hyp

    def text(self, tokens=None) -> str:
        from speech_recognition_tools_tpu_torch.io.text import decode_tokens

        if self.vocab is None:
            raise ValueError("no vocab attached")
        return decode_tokens(tokens if tokens is not None else list(self._hyp), self.vocab)

    def rescored_partial(self, model, **beam_kwargs):
        """Joint CTC/attention beam search (decode/beam_jit.py's, with
        `beam_kwargs` such as beam_size, max_len, ctc_weight, lm) over the
        encoder frames streamed so far; after finish() it is the final
        joint decode. Needs store_memory=True."""
        from speech_recognition_tools_tpu_torch.decode.beam_jit import (
            beam_search_encoded,
            tokens_to_list,
        )

        if not self.store_memory:
            raise ValueError("rescored partials need store_memory=True")
        st = self._st
        if not st.mem or sum(m.shape[0] for m in st.mem) == 0:
            return []
        dev = _model_device(model)
        mem = torch.as_tensor(np.concatenate(st.mem, axis=0)[None]).to(dev)
        ctc = torch.as_tensor(np.concatenate(st.ctc, axis=0)[None]).to(dev)
        toks, scores = beam_search_encoded(
            model, mem, torch.tensor([mem.shape[1]], device=dev), ctc, **beam_kwargs)
        return tokens_to_list(toks[0], scores[0], model.cfg.eos_id)


def read_serving_manifest(model_dir):
    """`<model_dir>/serving.json` (or None): the front-end geometry the
    model was trained on and its CMVN, as recipes/run_corpus.py writes it:
    {"frontend": {...}, "cmvn": "cmvn.npz" | null,
     "cmvn_mode": "global" | "per_utt" | "none"}."""
    path = os.path.join(model_dir, "serving.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def fdlp_config_from_frontend(fe):
    """A corpus config's `frontend` section as an FdlpConfig; only the fdlp
    front-end streams, so any other type raises."""
    import dataclasses

    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig

    typ = fe.get("type", "fdlp")
    if typ != "fdlp":
        raise ValueError(
            f"streaming featgen exists only for the fdlp frontend; this "
            f"model was trained on '{typ}' features and cannot be served "
            f"online"
        )
    fields = {f.name for f in dataclasses.fields(FdlpConfig)}
    kw = {k: v for k, v in fe.items() if k in fields}
    if isinstance(kw.get("lifter_config"), list):
        kw["lifter_config"] = tuple(kw["lifter_config"])
    return FdlpConfig(**kw)


def load_manifest_cmvn(model_dir, manifest):
    """The manifest's CMVN stats as (mean, std) float32 arrays, None for a
    CMVN-free model; per-utterance CMVN cannot be computed incrementally
    and raises."""
    mode = manifest.get("cmvn_mode", "global" if manifest.get("cmvn") else "none")
    if mode == "per_utt":
        raise ValueError(
            "model was trained with per-utterance CMVN, which cannot be "
            "computed incrementally; retrain with egs.cmvn='global' to "
            "serve online, or pass explicit global stats to override"
        )
    rel = manifest.get("cmvn")
    if not rel:
        return None
    blob = np.load(os.path.join(model_dir, rel))
    return np.asarray(blob["mean"], np.float32), np.asarray(blob["std"], np.float32)


def apply_cmvn(feats, mean=None, std=None):
    """Global CMVN of a (T, D) numpy block (no-op on empty input or absent
    stats): the one normalisation of OnlineASRPipeline and srt-serve."""
    if feats.shape[0] == 0:
        return feats
    if mean is not None:
        feats = feats - mean[None, :]
    if std is not None:
        feats = feats / std[None, :]
    return feats


def endpoint_due(endpoint_blanks: int, blank_run: int, hyp) -> bool:
    """The endpoint predicate (a long enough trailing blank run in a
    non-empty utterance), shared by OnlineASRPipeline and srt-serve."""
    return endpoint_blanks > 0 and bool(hyp) and blank_run >= endpoint_blanks


class OnlineASRPipeline:
    """Raw audio samples in, tokens out: StreamingFdlp (K1 on a card) ->
    global CMVN -> StreamingRecognizer, with optional endpointing. The
    featgen runs on the model's device."""

    @classmethod
    def from_model_dir(cls, model_dir, ckpt="final_avg", block_frames: int = 8,
                       int8: bool = False, device="cuda", **kwargs):
        """The pipeline of a model directory alone: checkpoint and vocab
        through recog_e2e._load, front-end and global CMVN from its
        serving.json (FdlpConfig() defaults and no CMVN without one)."""
        if int8:
            raise NotImplementedError("int8 encoder weights (infer/quantize.py) are not yet ported "
                                      "(ROADMAP Queue 1 item 3: int8 serving)")
        from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load

        model, _cfg, vocab = _load(model_dir, ckpt, device=device)
        manifest = read_serving_manifest(model_dir)
        fdlp_cfg, mean, std = None, None, None
        if manifest is not None:
            fdlp_cfg = fdlp_config_from_frontend(manifest.get("frontend", {}))
            cmvn = load_manifest_cmvn(model_dir, manifest)
            if cmvn is not None:
                mean, std = cmvn
        return cls(model, fdlp_cfg=fdlp_cfg, vocab=vocab, cmvn_mean=mean, cmvn_std=std,
                   block_frames=block_frames, **kwargs)

    def __init__(self, model, fdlp_cfg=None, vocab=None, cmvn_mean=None, cmvn_std=None,
                 block_frames: int = 8, endpoint_blanks: int = 0,
                 store_memory: bool = True):
        from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig
        from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp

        self.fdlp_cfg = fdlp_cfg or FdlpConfig()
        dev = _model_device(model)
        self._mk_featgen = lambda: StreamingFdlp(self.fdlp_cfg, block_frames=block_frames,
                                                 device=dev)
        self.recognizer = StreamingRecognizer(model, vocab=vocab, store_memory=store_memory)
        self.cmvn_mean = np.asarray(cmvn_mean, np.float32) if cmvn_mean is not None else None
        self.cmvn_std = np.asarray(cmvn_std, np.float32) if cmvn_std is not None else None
        # endpointing: finalise the utterance once the trailing blank run
        # reaches this many subsampled frames (0 = off); the featgen runs
        # on across the boundary, only the recognizer restarts
        self.endpoint_blanks = int(endpoint_blanks)
        self.reset()

    def reset(self):
        self.featgen = self._mk_featgen()
        self.recognizer.reset()
        self.segments: list[list[int]] = []
        # per segment: token emit times (subsampled frames, relative to the
        # segment) and confidences, parallel to self.segments
        self.segment_times: list[list[int]] = []
        self.segment_confs: list[list[float]] = []
        self.frames_fed = 0  # feature frames fed to the current segment
        # absolute feature frame at which each finished segment started:
        # seconds = segment_start_frames[k] / frate + times[k][i] * 4 / frate
        self.segment_start_frames: list[int] = []
        self.total_frames_fed = 0
        self._cur_seg_start = 0

    def _maybe_endpoint(self):
        """At a detected endpoint: flush the recognizer, record the segment
        and restart the recognizer on the running featgen."""
        if endpoint_due(self.endpoint_blanks, self.recognizer.blank_run,
                        self.recognizer._hyp):
            self.segments.append(self.recognizer.finish())
            self.segment_times.append(list(self.recognizer.times))
            self.segment_confs.append(list(self.recognizer.confs))
            self.segment_start_frames.append(self._cur_seg_start)
            self.recognizer.reset()
            self.frames_fed = 0
            self._cur_seg_start = self.total_frames_fed
            return True
        return False

    def _norm(self, feats):
        return apply_cmvn(feats, self.cmvn_mean, self.cmvn_std)

    def push(self, samples) -> list[int]:
        """Feed raw audio; returns the current partial tokens (of the
        current utterance when endpointing is on)."""
        feats = self.featgen.process(samples)
        if feats.shape[0]:
            self.frames_fed += feats.shape[0]
            self.total_frames_fed += feats.shape[0]
            hyp = self.recognizer.push(self._norm(feats))
        else:
            hyp = self.recognizer.push(np.zeros((0, feats.shape[1]), np.float32))
        if self._maybe_endpoint():
            return []
        return hyp

    def finish(self) -> list[int]:
        """Flush featgen and encoder; returns the last utterance's greedy
        tokens (earlier ones are in self.segments with endpointing on)."""
        feats = self.featgen.finish()
        if feats.shape[0]:
            self.frames_fed += feats.shape[0]
            self.total_frames_fed += feats.shape[0]
            self.recognizer.push(self._norm(feats))
        hyp = self.recognizer.finish()
        if self.endpoint_blanks > 0 and hyp:
            self.segments.append(hyp)
            self.segment_times.append(list(self.recognizer.times))
            self.segment_confs.append(list(self.recognizer.confs))
            self.segment_start_frames.append(self._cur_seg_start)
        return hyp

    def text(self) -> str:
        return self.recognizer.text()
