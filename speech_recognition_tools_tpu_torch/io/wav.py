"""Waveform loading: plain paths, shell-pipe scp entries, segments.

From speech_recognition_tools_tpu/io/wav.py: the reference CLIs' input
handling (computeFDLPSpectrogram.py:129-154: a plain path or a 'cmd |'
pipe run through the shell), the multichannel read the enhancement
pipeline needs (`keep_channels`), and the loader that pads utterances to
one (B, Nmax) batch.
"""

import io
import subprocess

import numpy as np
from scipy.io.wavfile import read as wav_read


def read_wav_scp_entry(value: str, expected_srate: int | None = None,
                       keep_channels: bool = False):
    """Read one scp value: a wav path or a shell pipe ending in '|'.

    Multichannel files are reduced to channel 0 (the featgen contract)
    unless keep_channels=True, which returns (samples, channels): the
    enhancement pipeline's multichannel-pipe path needs every channel.
    Returns (sample rate, float64 samples)."""
    if value.endswith("|"):
        proc = subprocess.run(value[:-1], shell=True, stdout=subprocess.PIPE)
        sr, signal = wav_read(io.BytesIO(proc.stdout))
    else:
        sr, signal = wav_read(value)
    if expected_srate is not None and sr != expected_srate:
        raise ValueError(f"sample rate {sr} != expected {expected_srate}")
    if signal.ndim > 1 and not keep_channels:
        signal = signal[:, 0]
    return sr, np.asarray(signal, np.float64)


def load_wav_batch(entries, srate: int, max_samples: int | None = None):
    """Load scp entries [(key, value)] into a zero-padded (B, Nmax) batch.

    Returns (signals float32 (B, Nmax), num_samples int32 (B,), keys).
    Entries whose read fails are skipped (the reference's skip_rest)."""
    keys, sigs = [], []
    for key, value in entries:
        try:
            _, sig = read_wav_scp_entry(value, expected_srate=srate)
        except (OSError, ValueError):
            continue
        keys.append(key)
        sigs.append(sig)
    if not sigs:
        return np.zeros((0, 0), np.float32), np.zeros(0, np.int32), []
    nmax = max_samples or max(len(s) for s in sigs)
    batch = np.zeros((len(sigs), nmax), np.float32)
    lens = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        m = min(len(s), nmax)
        batch[i, :m] = s[:m]
        lens[i] = m
    return batch, lens, keys


def extract_segment(signal: np.ndarray, srate: int, start: float, end: float):
    """The samples of a Kaldi segment [start, end) seconds."""
    return signal[int(start * srate) : int(end * srate)]
