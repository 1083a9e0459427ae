"""Long-form transcription: wav(s) in, text (and timestamps) out.

Port of speech_recognition_tools_tpu/cli/transcribe.py:

    python -m speech_recognition_tools_tpu_torch.cli.transcribe MODEL_DIR [WAV ...] \\
        [--scp wav.scp] [--json segs.json] [--device cpu]

Streaming FDLP featgen (K1 on the card) -> global CMVN -> chunked-attention
encoder -> greedy CTC, with optional endpointed segmentation, through
infer/streaming_asr.py::OnlineASRPipeline in bounded memory
(store_memory=False). The model dir describes itself through its
serving.json (front-end geometry and CMVN) and config.json (the encoder:
transformer, or conformer with its conv_kernel).

Output: Kaldi-style `utt text` lines (--out, default stdout) and an
optional JSON of per-utterance segments:
`{"utt": {"text": ..., "segments": [{"start": s, "end": s, "text": ...,
"conf": ..., "tokens": [...], "times": [...]}]}}`, times in seconds from
the start of the recording. `--int8` quantizes the encoder's weights
(infer/quantize.py).
"""

import argparse
import json
import os
import sys

import numpy as np


def transcribe_utterance(pipe, sig, feed_seconds: float = 10.0):
    """Stream one recording through the pipeline; returns (text, segments)
    with absolute times: token times are recognizer-relative subsampled
    frames (4 feature frames each), and each endpointed segment records the
    absolute feature frame its recognizer started at."""
    pipe.reset()
    srate = pipe.fdlp_cfg.srate
    step = max(1, int(round(feed_seconds * srate)))
    sig = np.asarray(sig, np.float32)
    for off in range(0, len(sig), step):
        pipe.push(sig[off : off + step])
    last = pipe.finish()

    frame_dt = 1.0 / float(pipe.fdlp_cfg.frate)
    sub_dt = 4.0 * frame_dt  # one subsampled frame = 4 feature frames
    if pipe.endpoint_blanks > 0:
        raw = zip(pipe.segments, pipe.segment_times, pipe.segment_confs,
                  pipe.segment_start_frames)
    elif last:
        raw = [(last, list(pipe.recognizer.times), list(pipe.recognizer.confs), 0)]
    else:
        raw = []
    segments = []
    for toks, times, confs, start_frame in raw:
        t0 = start_frame * frame_dt
        segments.append({
            "start": round(t0 + (times[0] * sub_dt if times else 0.0), 3),
            "end": round(t0 + ((times[-1] + 1) * sub_dt if times else 0.0), 3),
            "text": pipe.recognizer.text(toks),
            "conf": round(float(np.mean(confs)), 4) if confs else None,
            "tokens": [int(t) for t in toks],
            "times": [round(t0 + t * sub_dt, 3) for t in times],
        })
    text = " ".join(s["text"] for s in segments).strip()
    return text, segments


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Transcribe wav files with a trained e2e model "
                    "(streaming chain, bounded memory, timestamps)")
    p.add_argument("model_dir", help="train_e2e / run_corpus output directory")
    p.add_argument("wavs", nargs="*", help="wav paths (utt id = file basename)")
    p.add_argument("--scp", help="Kaldi wav.scp (utt  path-or-'cmd |')")
    p.add_argument("--out", default="-",
                   help="transcript file, 'utt text' per line (- = stdout)")
    p.add_argument("--json", dest="json_out", help="write per-utterance segments JSON here")
    p.add_argument("--ckpt", default="final_avg")
    p.add_argument("--endpoint_blanks", type=int, default=0,
                   help="segment on N consecutive blank subsampled frames "
                        "(0 = one segment per file)")
    p.add_argument("--feed_seconds", type=float, default=10.0,
                   help="host feed granularity in seconds (memory bound; "
                        "does not change results)")
    p.add_argument("--block_frames", type=int, default=8,
                   help="featgen block size in analysis windows")
    p.add_argument("--int8", action="store_true", help="int8-quantize the encoder weights")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from speech_recognition_tools_tpu_torch.infer.streaming_asr import OnlineASRPipeline
    from speech_recognition_tools_tpu_torch.io.scp import read_scp
    from speech_recognition_tools_tpu_torch.io.wav import read_wav_scp_entry
    from speech_recognition_tools_tpu_torch.utils.profiling import ThroughputMeter

    entries = list(read_scp(args.scp)) if args.scp else []
    entries += [(os.path.splitext(os.path.basename(w))[0], w) for w in args.wavs]
    if not entries:
        p.error("no input: give WAV paths and/or --scp")
    seen, dups = set(), set()
    for utt, _ in entries:
        if utt in seen:
            dups.add(utt)
        seen.add(utt)
    if dups:
        p.error(f"duplicate utterance ids (basename clash or scp overlap): {sorted(dups)}")

    pipe = OnlineASRPipeline.from_model_dir(
        args.model_dir, ckpt=args.ckpt, block_frames=args.block_frames, int8=args.int8,
        endpoint_blanks=args.endpoint_blanks, store_memory=False, device=args.device,
    )
    srate = pipe.fdlp_cfg.srate
    meter = ThroughputMeter()
    out_f = sys.stdout if args.out == "-" else open(args.out, "w")
    results = {}
    try:
        for utt, value in entries:
            try:
                _, sig = read_wav_scp_entry(value, expected_srate=srate)
            except Exception as e:  # reference behaviour: skip and warn
                print(f"WARNING: skipping {utt}: {e}", file=sys.stderr)
                continue
            text, segments = transcribe_utterance(pipe, sig, feed_seconds=args.feed_seconds)
            meter.update(items=1, audio_seconds=len(sig) / srate)
            print(f"{utt} {text}".rstrip(), file=out_f)
            out_f.flush()
            if args.json_out:  # only then keep per-utterance detail
                results[utt] = {"text": text, "segments": segments}
    finally:
        if out_f is not sys.stdout:
            out_f.close()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    print(meter.summary(), file=sys.stderr)


if __name__ == "__main__":
    main()
