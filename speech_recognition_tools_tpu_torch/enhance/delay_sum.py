"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/enhance/delay_sum.py, kept in the port so that it
imports nothing of the JAX package.

Weighted delay-and-sum beamforming (BeamformIt equivalent).

The reference shells out to the BeamformIt binary for multichannel
delay-and-sum (e2e/reverb/local/run_beamform.sh:27). Native equivalent:
TDOAs from GCC-PHAT against a reference channel, per-channel quality
weights from pairwise cross-correlation, integer-delay alignment and
weighted sum. FFTs are powers of two; numpy on the host.
"""

import numpy as np


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def gcc_phat(sig, ref, max_delay: int, fs: int | None = None):
    """GCC-PHAT delay of `sig` relative to `ref` in samples."""
    n = _next_pow2(len(sig) + len(ref))
    S = np.fft.rfft(sig, n)
    R = np.fft.rfft(ref, n)
    cc = S * np.conj(R)
    cc = cc / np.maximum(np.abs(cc), 1e-12)
    r = np.fft.irfft(cc, n)
    r = np.concatenate([r[-max_delay:], r[: max_delay + 1]])
    return int(np.argmax(np.abs(r))) - max_delay


def delay_and_sum(signals, max_delay_ms: float = 20.0, fs: int = 16000,
                  ref_channel: int | None = None):
    """Beamform (D, N) multichannel audio to (N,).

    Channel weights follow BeamformIt's idea: channels that correlate
    better with the aligned mean get more weight.
    """
    signals = np.asarray(signals, np.float64)
    D, N = signals.shape
    if ref_channel is None:
        # highest-energy channel as reference
        ref_channel = int(np.argmax(np.sum(signals**2, axis=1)))
    ref = signals[ref_channel]
    max_delay = int(max_delay_ms * fs / 1000)
    delays = np.array(
        [gcc_phat(signals[d], ref, max_delay) for d in range(D)]
    )
    aligned = np.zeros_like(signals)
    for d in range(D):
        td = delays[d]
        if td > 0:
            aligned[d, : N - td] = signals[d, td:]
        elif td < 0:
            aligned[d, -td:] = signals[d, : N + td]
        else:
            aligned[d] = signals[d]
    # quality weights: correlation with the plain average
    avg = aligned.mean(axis=0)
    corr = np.array(
        [
            np.dot(aligned[d], avg)
            / (np.linalg.norm(aligned[d]) * np.linalg.norm(avg) + 1e-12)
            for d in range(D)
        ]
    )
    w = np.maximum(corr, 0)
    w = w / np.maximum(w.sum(), 1e-12)
    return (w[:, None] * aligned).sum(axis=0), delays, w
