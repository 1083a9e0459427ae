"""Shared CLI machinery: scp -> padded wav batches -> featgen -> ark.

Port of speech_recognition_tools_tpu/cli/common.py for the featgen CLIs
(FDLP, MFCC, mel): `load_signals` (wav and segments scp), `run_batched`
(length-bucketed batches, feeding a ThroughputMeter), `finish`, and the
shared `--profile_dir` flag (`add_profiling_arg`, `profiled_extraction`).
The noise / reverb augmentation and data parallelism are not yet ported:
`check_unported` raises on their flags.
"""

import sys

import numpy as np

from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp
from speech_recognition_tools_tpu_torch.io.scp import read_scp, read_segments
from speech_recognition_tools_tpu_torch.io.wav import read_wav_scp_entry


AUGMENT_ITEM = ("ROADMAP Queue 1 item 4: enhancement, augmentation, evaluation and "
                "alignment (dsp/augment.py, dsp/simulate.py)")
PARALLEL_ITEM = "ROADMAP Queue 1 item 5: the parallel paths"


def check_unported(args):
    """Raise NotImplementedError, naming the ROADMAP item, for a featgen
    flag whose module is not yet ported: --add_noise other than none /
    clean, --add_reverb other than clean, --data_parallel. (`clean` adds
    nothing in the JAX CLIs either.)"""
    if getattr(args, "add_noise", None) not in (None, "none", "clean"):
        raise NotImplementedError(f"--add_noise {args.add_noise} is not yet ported "
                                  f"({AUGMENT_ITEM})")
    if getattr(args, "add_reverb", None) not in (None, "clean"):
        raise NotImplementedError(f"--add_reverb {args.add_reverb} is not yet ported "
                                  f"({AUGMENT_ITEM})")
    if getattr(args, "data_parallel", False):
        raise NotImplementedError(f"--data_parallel is not yet ported ({PARALLEL_ITEM})")


def load_signals(args, srate):
    """[(utt, float64 samples)] from a wav scp, or from a Kaldi segments
    file with --scp_type segment and --wav_scp. Unreadable entries are
    skipped with a message, like the reference CLIs."""
    raw = []
    if getattr(args, "scp_type", "wav") == "segment":
        wav_scp = getattr(args, "wav_scp", None)
        if not wav_scp:
            raise ValueError("--scp_type segment requires --wav_scp")
        recordings = dict(read_scp(wav_scp))
        cache_key, cache_sig = None, None
        for utt, rec, start, end in read_segments(args.scp):
            if rec != cache_key:
                try:
                    _, cache_sig = read_wav_scp_entry(recordings[rec],
                                                      expected_srate=srate)
                    cache_key = rec
                except (KeyError, OSError, ValueError):
                    print(f"{sys.argv[0]}: skipping unreadable recording {rec}")
                    cache_key, cache_sig = None, None
                    continue
            seg = cache_sig[int(start * srate) : int(end * srate)]
            if len(seg):
                raw.append((utt, seg))
        return raw
    for key, value in read_scp(args.scp):
        try:
            _, sig = read_wav_scp_entry(value, expected_srate=srate)
        except (OSError, ValueError):
            print(f"{sys.argv[0]}: skipping unreadable entry {key}")
            continue
        raw.append((key, sig))
    return raw


def run_batched(signals, batch_fn, batch_size=32, bucket_multiple=16000, meter=None,
                srate=None):
    """Bucket signals by length and run the featgen per batch.

    batch_fn(padded (B, Nmax) float32, lens (B,) int32) ->
    (feats (B, T, D), nframes (B,)). Returns {utt: (T_i, D) float32}.
    `meter` (a ThroughputMeter) counts each batch's utterances and, given
    `srate`, its audio seconds, after its features reached the host.
    """
    order = np.argsort([len(s) for _, s in signals], kind="stable")
    signals = [signals[i] for i in order]
    feats = {}
    for i in range(0, len(signals), batch_size):
        group = signals[i : i + batch_size]
        nmax = max(len(s) for _, s in group)
        nmax = ((nmax + bucket_multiple - 1) // bucket_multiple) * bucket_multiple
        batch = np.zeros((len(group), nmax), np.float32)
        lens = np.zeros(len(group), np.int32)
        for j, (_, s) in enumerate(group):
            batch[j, : len(s)] = s
            lens[j] = len(s)
        out, nframes = batch_fn(batch, lens)
        out = out.detach().cpu().numpy()
        nframes = nframes.detach().cpu().numpy()
        for j, (key, _) in enumerate(group):
            feats[key] = out[j, : int(nframes[j])]
        if meter is not None:
            meter.update(items=len(group),
                         audio_seconds=float(lens.sum()) / srate if srate else 0.0)
    return feats


def finish(args, feats, lens_attr="write_utt2num_frames", meter=None):
    """Write ark/scp (+ optional .len) like the reference CLIs."""
    write_ark_scp(feats, args.outfile)
    if getattr(args, lens_attr.replace("-", "_"), False):
        with open(args.outfile + ".len", "w") as f:
            for key, mat in feats.items():
                f.write(f"{key} {mat.shape[0]}\n")
    print(f"{sys.argv[0]}: wrote {len(feats)} utterances -> {args.outfile}.ark")
    if meter is not None:
        print(f"{sys.argv[0]}: {meter.summary()}")


def add_profiling_arg(parser):
    """The --profile_dir flag the featgen CLIs share."""
    parser.add_argument("--profile_dir",
                        help="capture a torch.profiler trace (Chrome trace JSON) of "
                             "the extraction into this dir")
    return parser


def profiled_extraction(args, device):
    """(context manager, ThroughputMeter) of a featgen CLI: the context
    traces the extraction on `device` into --profile_dir when given
    (utils/profiling.py::trace), else does nothing."""
    import contextlib

    from speech_recognition_tools_tpu_torch.utils.profiling import ThroughputMeter, trace

    profile_dir = getattr(args, "profile_dir", None)
    ctx = trace(profile_dir, device) if profile_dir else contextlib.nullcontext()
    return ctx, ThroughputMeter()
