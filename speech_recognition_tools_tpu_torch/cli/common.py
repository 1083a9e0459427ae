"""Shared CLI machinery: scp -> padded wav batches -> featgen -> ark.

Port of speech_recognition_tools_tpu/cli/common.py for the featgen CLIs
(FDLP, MFCC, mel, modulation spectrum): `load_signals` (wav and segments
scp, then the reference CLIs' host-side augmentation: --add_noise
'type,snr' | diff, --add_reverb small_room | medium_room | large_room),
`run_batched` (length-bucketed batches, feeding a ThroughputMeter),
`finish`, and the shared `--profile_dir` flag (`add_profiling_arg`,
`profiled_extraction`). With `data_parallel` in a world of several ranks
(parallel/launcher.py), each bucket batch is padded to a multiple of the
world size by repeating its shortest utterance, every rank extracts its
contiguous share of the rows (the FDLP's K1 runs on those rows), the
features are all-gathered, the padding rows dropped, and only rank 0
writes the ark: the same keys and layout as the one-process CLI's.

The augmentation is the JAX CLIs' numpy code, on the host: the noise
segment's offset comes from numpy's global np.random.rand(), so a caller
that seeds numpy gets the JAX CLI's offsets, and the reverb alignment is
numpy's direct convolve / correlate (an FFT convolution could move the
correlation's argmax at a tie). Noise is read from noises/<type>.wav and
RIRs from ./RIR/, relative to the working directory, as in the reference.
"""

import sys

import numpy as np

from speech_recognition_tools_tpu_torch.dsp.augment import DIFF_FIR
from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp
from speech_recognition_tools_tpu_torch.io.scp import read_scp, read_segments
from speech_recognition_tools_tpu_torch.io.wav import read_wav_scp_entry


# the reference CLIs' RIR wavs (computeFDLPSpectrogram.py), relative to the
# working directory; channel 1 is the one convolved
RIR_FILES = {
    "small_room": "./RIR/RIR_SmallRoom1_near_AnglA.wav",
    "medium_room": "./RIR/RIR_MediumRoom1_far_AnglA.wav",
    "large_room": "./RIR/RIR_LargeRoom1_far_AnglA.wav",
}


def _augmentation(args):
    """(noise samples or None, noise SNR, RIR or None) of the flags."""
    from scipy.io.wavfile import read as wav_read

    noise = noise_snr = rir = None
    add_noise = getattr(args, "add_noise", None)
    if add_noise not in (None, "none", "clean", "diff"):
        noise_info = add_noise.strip().split(",")
        _, noise = wav_read(f"noises/{noise_info[0]}.wav")
        noise_snr = float(noise_info[1])
    add_reverb = getattr(args, "add_reverb", None)
    if add_reverb not in (None, "clean"):
        _, rir = wav_read(RIR_FILES[add_reverb])
        rir = rir[:, 1] / 2.0**15
    return noise, noise_snr, rir


def augment(args, raw):
    """The JAX CLIs' host augmentation of [(utt, samples)], in order:
    --add_noise diff (the FIR, mode 'same') or 'type,snr' (a segment of
    noises/<type>.wav at an offset floor(np.random.rand() * (len(noise) -
    len(sig))), scaled to the SNR), then --add_reverb (the RIR's
    convolution, re-aligned at the cross-correlation peak). An int16
    noise wav keeps its dtype, so its energy np.mean(ns**2) wraps in int16
    and the gain is wrong or NaN, as in the JAX CLIs (ROADMAP Queue 3)."""
    import scipy.signal

    noise, noise_snr, rir = _augmentation(args)
    add_noise = getattr(args, "add_noise", None)
    out = []
    for key, sig in raw:
        if add_noise == "diff":
            sig = scipy.signal.convolve(sig, DIFF_FIR, mode="same")
        elif noise is not None:
            off = int(np.floor(np.random.rand() * (len(noise) - len(sig))))
            ns = noise[off : off + len(sig)]
            e_s = np.mean(sig**2)
            e_n = np.mean(ns**2)
            alp = np.sqrt(e_s / (e_n * 10 ** (noise_snr / 10)))
            sig = sig + alp * ns
        if rir is not None:
            full = np.convolve(sig, rir)
            xxc = np.correlate(sig, full, "valid")
            ind = len(xxc) - np.argmax(xxc)
            sig = full[ind : ind + len(sig)]
        out.append((key, sig))
    return out


def load_signals(args, srate):
    """[(utt, float64 samples)] from a wav scp, or from a Kaldi segments
    file with --scp_type segment and --wav_scp, augmented as the flags say
    (`augment`). Unreadable entries are skipped with a message, like the
    reference CLIs."""
    return augment(args, _read_signals(args, srate))


def _read_signals(args, srate):
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
                srate=None, data_parallel=False, device="cuda"):
    """Bucket signals by length and run the featgen per batch.

    batch_fn(padded (B, Nmax) float32, lens (B,) int32) ->
    (feats (B, T, D), nframes (B,)). Returns {utt: (T_i, D) float32}.
    `meter` (a ThroughputMeter) counts each batch's utterances and, given
    `srate`, its audio seconds, after its features reached the host.

    data_parallel: in a world of several ranks (initialize_runtime joins
    torchrun's, on `device`'s backend), each bucket batch is padded to a
    multiple of the world size by repeating the bucket's shortest
    utterance (the copies' outputs are discarded), each rank runs batch_fn
    on its contiguous block of rows, and the blocks are all-gathered; in a
    world of one it changes nothing.

    Spans: `featgen.pass` (counting the utterances) around the whole call,
    and per batch `featgen.pad`, `featgen.batch_fn`, `featgen.readback`
    (the wait for the device and the copy back) and `featgen.split`.
    """
    from speech_recognition_tools_tpu_torch.utils.profiling import span

    mesh = None
    if data_parallel:
        from speech_recognition_tools_tpu_torch.parallel.launcher import initialize_runtime
        from speech_recognition_tools_tpu_torch.parallel.mesh import make_mesh

        _, world, _ = initialize_runtime(device)
        if world > 1:
            mesh = make_mesh()
    with span("featgen.pass", n=len(signals)):
        order = np.argsort([len(s) for _, s in signals], kind="stable")
        signals = [signals[i] for i in order]
        feats = {}
        for i in range(0, len(signals), batch_size):
            with span("featgen.pad"):
                group = signals[i : i + batch_size]
                rows = len(group)
                if mesh is not None:
                    dpar = mesh.size("data")
                    rows = ((rows + dpar - 1) // dpar) * dpar
                nmax = max(len(s) for _, s in group)
                nmax = ((nmax + bucket_multiple - 1) // bucket_multiple) * bucket_multiple
                batch = np.zeros((rows, nmax), np.float32)
                lens = np.zeros(rows, np.int32)
                for j in range(rows):
                    # pad rows (discarded below) copy the bucket's shortest
                    # utterance: group is length-sorted
                    _, s = group[j if j < len(group) else 0]
                    batch[j, : len(s)] = s
                    lens[j] = len(s)
            with span("featgen.batch_fn"):
                if mesh is None:
                    out, nframes = batch_fn(batch, lens)
                else:
                    import torch

                    from speech_recognition_tools_tpu_torch.parallel import collectives
                    from speech_recognition_tools_tpu_torch.parallel.mesh import batch_sharding

                    mine = batch_sharding(mesh).rows(rows)
                    out, nframes = batch_fn(batch[mine], lens[mine])
                    grp = mesh.group("data")
                    out = torch.cat(collectives.all_gather_list(out.contiguous(), grp))
                    nframes = torch.cat(collectives.all_gather_list(nframes.contiguous(), grp))
            with span("featgen.readback"):
                out = out.detach().cpu().numpy()
                nframes = nframes.detach().cpu().numpy()
            with span("featgen.split"):
                for j, (key, _) in enumerate(group):
                    feats[key] = out[j, : int(nframes[j])]
                if meter is not None:
                    meter.update(items=len(group), audio_seconds=(
                        float(lens[: len(group)].sum()) / srate if srate else 0.0))
    return feats


def finish(args, feats, lens_attr="write_utt2num_frames", meter=None):
    """Write ark/scp (+ optional .len) like the reference CLIs; in a world
    of several ranks only rank 0 writes."""
    from speech_recognition_tools_tpu_torch.parallel.launcher import is_main

    if not is_main():
        return
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
