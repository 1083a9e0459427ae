"""Online ASR serving daemon.

Port of speech_recognition_tools_tpu/cli/serve.py. A TCP server around the
streaming stack (infer/streaming_asr.py): each connection is one audio
stream; concurrent connections share ONE StreamBatcher, so every
scheduling round runs a single padded batched encoder step for all active
streams. Featgen (StreamingFdlp, K1 on the card) runs per connection,
outside the batcher's lock.

Wire protocol (newline-delimited JSON over TCP, one connection = one
audio stream):
  client -> {"config": {"endpoint_blanks": N}}   optional, first message:
                                         server-side endpointing — after
                                         N consecutive blank subsampled
                                         frames (x40 ms at 100 Hz) the
                                         current utterance is finalized
                                         mid-stream and recognition
                                         restarts (continuous mode)
  client -> {"pcm": [float, ...]}        raw samples (any chunking)
  client -> {"eof": true}                flush and finish
  server -> {"ok": true}                 config acknowledgement
  server -> {"partial": "<text so far>"} after every client chunk; when
                                         an endpoint fired it also
                                         carries "endpoint": {"final":
                                         "<text>", "tokens": [...],
                                         "times": [...], "confs": [...]}
  server -> {"final": "<text>", "tokens": [...], "times": [...],
             "confs": [...], "frames": N}
  ("times": per-token emit timestamps in seconds from the utterance
   start — the first CTC frame of each collapsed token run;
   "confs": per-token confidence — the CTC softmax posterior of the
   token at its emitting frame, in (0, 1])
  server -> {"error": "<message>"}       on a malformed message; the
                                         connection then closes (the
                                         stream's integrity is unknown)

Run:  python -m speech_recognition_tools_tpu_torch.cli.serve model_dir --port 8973
      [--fdlp flags] [--device cpu]
The model directory's config.json gives its encoder (transformer, or
conformer with its conv_kernel). `--int8` raises NotImplementedError.
"""

import argparse
import json
import socketserver
import threading


def get_parser():
    p = argparse.ArgumentParser("Online ASR TCP server")
    p.add_argument("model_dir", help="train_e2e output (chunked-attention "
                                     "model: --attn_chunk > 0)")
    p.add_argument("--ckpt", default="final_avg")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8973)
    p.add_argument("--max_streams", type=int, default=8,
                   help="StreamBatcher batch rows (concurrent streams "
                        "beyond this still work; their chunks queue)")
    p.add_argument("--int8", action="store_true", help="not yet ported")
    p.add_argument("--defer_ms", type=float, default=30.0,
                   help="dynamic batching: hold a ready chunk up to this "
                        "long so concurrent connections coalesce into one "
                        "full batched round (0 = schedule every push now)")
    # frontend flags default to None so an explicit flag overrides the
    # model dir's serving.json field by field
    p.add_argument("--srate", type=int, default=None)
    p.add_argument("--nfilters", type=int, default=None,
                   help="FDLP mel bands (default: the manifest's, else "
                        "the model's feature dim)")
    p.add_argument("--fduration", type=float, default=None)
    p.add_argument("--order", type=int, default=None)
    p.add_argument("--coeff_num", type=int, default=None)
    p.add_argument("--cmvn", help="npz file with `mean`/`std` arrays "
                                  "(global CMVN the model was trained "
                                  "with); default: the model dir's "
                                  "serving.json manifest; omit only for "
                                  "CMVN-free models")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


class _ASRService:
    """Shared state: one batcher and a featgen per connection. A lock
    serialises the batcher's scheduling rounds (the batching across
    streams happens inside a round). The semantics this service shares
    with OnlineASRPipeline (CMVN, the endpoint predicate) live in
    infer/streaming_asr.py."""

    def __init__(self, model, vocab, fdlp_cfg, max_streams, cmvn=None, defer_s=0.0):
        from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp
        from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
            StreamBatcher,
            apply_cmvn,
            endpoint_due,
        )

        self._apply_cmvn, self._endpoint_due = apply_cmvn, endpoint_due
        self.batcher = StreamBatcher(model, max_streams=max_streams, store_memory=False,
                                     defer_s=defer_s)
        self.vocab = vocab
        self.fdlp_cfg = fdlp_cfg
        self.cmvn = cmvn  # (mean, std) or None
        dev = self.batcher.device
        self._mk_featgen = lambda: StreamingFdlp(fdlp_cfg, device=dev)
        # one subsampled frame = 4 feature frames at the frontend rate
        self._sub_dt = 4.0 / float(getattr(fdlp_cfg, "frate", 100.0))
        self.lock = threading.Lock()
        self._stop = threading.Event()
        if defer_s > 0:
            # deferral is push-driven; if every client pauses, a held
            # chunk would wait for the next push: this ticker bounds the
            # wait at ~defer_s on an idle wire
            def tick():
                while not self._stop.wait(max(defer_s / 2, 0.005)):
                    with self.lock:
                        self.batcher._maybe_drain()

            threading.Thread(target=tick, daemon=True).start()

    def close(self):
        """Stop the ticker thread."""
        self._stop.set()

    def times_s(self, frame_times):
        """Subsampled emit-frame indices -> seconds from utterance start."""
        return [round(t * self._sub_dt, 3) for t in frame_times]

    def open(self):
        with self.lock:
            sid = self.batcher.open()
        return sid, self._mk_featgen()

    def _feats(self, featgen, samples=None):
        feats = featgen.finish() if samples is None else featgen.process(samples)
        if self.cmvn is not None:
            feats = self._apply_cmvn(feats, *self.cmvn)
        return feats

    def push_audio(self, sid, featgen, samples, endpoint_blanks=0):
        """Returns (partial_hyp, endpoint_hyp_or_None). With endpointing
        on, a long enough trailing blank run finalises the utterance in
        place (StreamBatcher.restart) and the connection goes on as a
        fresh utterance."""
        feats = self._feats(featgen, samples)
        endpoint = None
        with self.lock:
            if feats.shape[0]:
                hyp = self.batcher.push(sid, feats)
            else:
                hyp = list(self.batcher.state(sid).hyp)
            st = self.batcher.state(sid)
            if self._endpoint_due(endpoint_blanks, st.blank_run, st.hyp):
                toks, times, confs = self.batcher.restart(sid)
                endpoint = {"tokens": toks, "times": self.times_s(times),
                            "confs": [round(c, 4) for c in confs]}
                hyp = []
        return hyp, endpoint

    def finish(self, sid, featgen):
        feats = self._feats(featgen)
        with self.lock:
            if feats.shape[0]:
                self.batcher.push(sid, feats)
            hyp = self.batcher.finish(sid)
            st = self.batcher.state(sid)
            frames, times = st.pos, self.times_s(st.times)
            confs = [round(c, 4) for c in st.confs]
        return hyp, frames, times, confs

    def release(self, sid):
        with self.lock:
            self.batcher.release(sid)

    def text(self, tokens):
        from speech_recognition_tools_tpu_torch.io.text import decode_tokens

        return decode_tokens(tokens, self.vocab)


class _Handler(socketserver.StreamRequestHandler):
    def _send(self, obj):
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()

    def handle(self):
        svc: _ASRService = self.server.service  # type: ignore[attr-defined]
        sid, featgen = svc.open()
        finished = False
        endpoint_blanks = 0
        try:
            for raw in self.rfile:
                try:
                    msg = json.loads(raw)
                    if not isinstance(msg, dict):
                        raise ValueError(
                            f"message must be a JSON object, got {type(msg).__name__}")
                    if "config" in msg:
                        endpoint_blanks = int(msg["config"].get("endpoint_blanks", 0))
                        self._send({"ok": True})
                        continue
                    if msg.get("eof"):
                        hyp, frames, times, confs = svc.finish(sid, featgen)
                        self._send({"final": svc.text(hyp), "tokens": hyp, "times": times,
                                    "confs": confs, "frames": int(frames)})
                        finished = True
                        break
                    import numpy as np

                    pcm = np.asarray(msg["pcm"], np.float32)
                    if pcm.ndim != 1:
                        raise ValueError(f"pcm must be 1-D, got {pcm.shape}")
                    hyp, endpoint = svc.push_audio(sid, featgen, pcm, endpoint_blanks)
                    resp = {"partial": svc.text(hyp)}
                    if endpoint is not None:
                        resp["endpoint"] = {"final": svc.text(endpoint["tokens"]), **endpoint}
                    self._send(resp)
                except (ValueError, KeyError, TypeError) as e:
                    # one response per message: report the bad frame, then
                    # close (the stream's integrity is unknown)
                    self._send({"error": f"{type(e).__name__}: {e}"})
                    break
        finally:
            if not finished:
                # drop a half-finished stream so its batcher slot is freed
                try:
                    svc.finish(sid, featgen)
                except Exception:
                    pass
            svc.release(sid)


class ASRServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service):
        super().__init__(addr, _Handler)
        self.service = service

    def server_close(self):
        super().server_close()
        self.service.close()


def resolve_frontend(model_dir, overrides=None, ckpt="final_avg"):
    """The serving FdlpConfig of a model dir, the one place the precedence
    lives: `serving.json`'s front-end geometry, overridden field by field
    by explicit `overrides`; without a manifest, the production FDLP
    geometry (e2e/wsj/run_fdlp_e1.sh) + overrides, nfilters defaulting to
    the checkpoint config's feature_dim. A manifest that cannot stream
    (melspec/mfcc) raises, unless the overrides replace the whole
    front-end (nfilters given): then it is ignored with a warning."""
    import dataclasses
    import os
    import sys

    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
        fdlp_config_from_frontend,
        read_serving_manifest,
    )

    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    manifest = read_serving_manifest(model_dir)
    if manifest is not None:
        try:
            base = fdlp_config_from_frontend(manifest.get("frontend", {}))
            return dataclasses.replace(base, **overrides)
        except ValueError:
            if "nfilters" not in overrides:
                raise
            print("WARNING: serving.json frontend is not streamable; "
                  "using the explicit frontend flags instead", file=sys.stderr)
    fallback = dict(srate=16000, fduration=1.5, order=150, coeff_num=100)
    if "nfilters" not in overrides:
        nf = None
        cfg_path = os.path.join(model_dir, ckpt, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                nf = json.load(f).get("feature_dim")
        if nf is None:
            raise ValueError(
                "checkpoint config carries no feature_dim; pass "
                "--nfilters matching the model's input dimension"
            )
        overrides["nfilters"] = int(nf)
    return FdlpConfig(**{**fallback, **overrides})


def make_server(model_dir, ckpt="final_avg", host="127.0.0.1", port=0, max_streams=8,
                fdlp_cfg=None, cmvn=None, int8=False, defer_s=0.0, device="cuda"):
    """(server, bound_port); serve_forever() on the caller's thread.
    cmvn: optional (mean, std). Without fdlp_cfg / cmvn, the model dir's
    `serving.json` supplies them (resolve_frontend). On a card the kernels
    are built here, before the first connection."""
    if int8:
        raise NotImplementedError("int8 encoder weights (infer/quantize.py) are not yet ported "
                                  "(ROADMAP Queue 1 item 3: int8 serving)")
    from speech_recognition_tools_tpu_torch.cli.recog_e2e import _load
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import (
        load_manifest_cmvn,
        read_serving_manifest,
    )

    model, _cfg, vocab = _load(model_dir, ckpt, device=device)
    if next(model.parameters()).device.type == "cuda":
        from speech_recognition_tools_tpu_torch import kernels

        kernels.load()
    if fdlp_cfg is None:
        fdlp_cfg = resolve_frontend(model_dir, ckpt=ckpt)
    if cmvn is None:
        manifest = read_serving_manifest(model_dir)
        if manifest is not None:
            cmvn = load_manifest_cmvn(model_dir, manifest)
    service = _ASRService(model, vocab, fdlp_cfg, max_streams, cmvn=cmvn, defer_s=defer_s)
    server = ASRServer((host, port), service)
    return server, server.server_address[1]


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.int8:
        raise NotImplementedError("--int8 (infer/quantize.py) is not yet ported "
                                  "(ROADMAP Queue 1 item 3: int8 serving)")
    overrides = {k: getattr(args, k)
                 for k in ("srate", "nfilters", "fduration", "order", "coeff_num")}
    try:
        fdlp_cfg = resolve_frontend(args.model_dir, overrides, ckpt=args.ckpt)
    except ValueError as e:
        raise SystemExit(str(e))
    cmvn = None
    if args.cmvn:
        import numpy as np

        blob = np.load(args.cmvn)
        cmvn = (np.asarray(blob["mean"], np.float32), np.asarray(blob["std"], np.float32))
    server, port = make_server(
        args.model_dir, args.ckpt, args.host, args.port, args.max_streams, fdlp_cfg,
        cmvn=cmvn, defer_s=args.defer_ms / 1000.0, device=args.device,
    )
    print(f"serving on {args.host}:{port} (max {args.max_streams} batched streams)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
