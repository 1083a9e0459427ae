"""Waveform loading: plain paths and shell-pipe scp entries.

From speech_recognition_tools_tpu/io/wav.py: the reference CLIs' input
handling (computeFDLPSpectrogram.py:129-154: a plain path or a 'cmd |'
pipe run through the shell).
"""

import io
import subprocess

import numpy as np
from scipy.io.wavfile import read as wav_read


def read_wav_scp_entry(value: str, expected_srate: int | None = None):
    """Read one scp value: a wav path or a shell pipe ending in '|'.
    Multichannel files are reduced to channel 0 (the featgen contract).
    Returns (sample rate, float64 samples)."""
    if value.endswith("|"):
        proc = subprocess.run(value[:-1], shell=True, stdout=subprocess.PIPE)
        sr, signal = wav_read(io.BytesIO(proc.stdout))
    else:
        sr, signal = wav_read(value)
    if expected_srate is not None and sr != expected_srate:
        raise ValueError(f"sample rate {sr} != expected {expected_srate}")
    if signal.ndim > 1:
        signal = signal[:, 0]
    return sr, np.asarray(signal, np.float64)
