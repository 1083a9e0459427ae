"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/eval/srmr.py, kept in the port so that it
imports nothing of the JAX package.

SRMR: speech-to-reverberation modulation energy ratio.

The metric the reference invokes through the SRMR toolbox
(e2e/reverb/local/REVERB_scores_source/.../SRMRtoolbox-ReverbChallenge,
compute_se_scores.sh). Algorithm (Falk, Zheng & Chan 2010): 23-channel
gammatone filterbank (125 Hz .. ~fs/2), Hilbert temporal envelopes,
modulation-band energies from 256 ms Hamming windows (64 ms shift) against
8 octave-spaced modulation filters centred 4..128 Hz; SRMR = energy in
modulation bands 1-4 / energy in bands 5-8.
"""

import numpy as np
import scipy.signal


def _erb_space(low, high, n):
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, n + 1)
    return -(ear_q * min_bw) + np.exp(
        i * (-np.log(high + ear_q * min_bw) + np.log(low + ear_q * min_bw)) / n
    ) * (high + ear_q * min_bw)


def _modulation_filters(fs_env):
    """8 octave-spaced second-order bandpass filters, centres 4..128 Hz."""
    centers = 4.0 * 2 ** np.arange(8)  # 4, 8, ..., 512 -> cap below nyquist
    filters = []
    for cf in centers:
        cf = min(cf, 0.4 * fs_env)
        q = 2.0
        b, a = scipy.signal.iirpeak(cf / (fs_env / 2), q)
        filters.append((b, a))
    return filters


def srmr(x, fs, n_cochlear=23, low_freq=125.0):
    """SRMR of a single-channel signal."""
    x = np.asarray(x, np.float64)
    x = x / (np.max(np.abs(x)) + 1e-12)
    cfs = _erb_space(low_freq, min(0.5 * fs * 0.9, 8000.0), n_cochlear)[::-1]
    win = int(0.256 * fs)
    shift = int(0.064 * fs)
    mod_energy = np.zeros((n_cochlear, 8))
    filters = _modulation_filters(fs)
    for c, cf in enumerate(cfs):
        b, a = scipy.signal.gammatone(cf, "iir", fs=fs)
        band = scipy.signal.lfilter(b, a, x)
        env = np.abs(scipy.signal.hilbert(band))
        for m, (bm, am) in enumerate(filters):
            e = scipy.signal.lfilter(bm, am, env)
            # framewise energy, averaged
            nfr = max(1, (len(e) - win) // shift + 1)
            idx = np.arange(win)[None, :] + np.arange(nfr)[:, None] * shift
            w = np.hamming(win)
            mod_energy[c, m] = np.mean(np.sum((e[idx] * w) ** 2, axis=1))
    num = np.sum(mod_energy[:, :4])
    den = np.sum(mod_energy[:, 4:])
    return float(num / max(den, 1e-12))
