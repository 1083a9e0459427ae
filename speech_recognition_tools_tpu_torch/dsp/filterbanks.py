"""Mel and cochlear (Bark-warped asymmetric-exponential) filterbanks.

Copy of speech_recognition_tools_tpu/dsp/filterbanks.py (held bit-exact by
the tests), which follows the reference constructors createFbank /
createFbankCochlear (featgen/features.py:172-219). Filterbanks are
data-independent constants computed once on the host in float64.
"""

import numpy as np


def mel_filterbank(
    nfilters: int, nfft: int, srate: float, warp_fact: float = 1.0
) -> np.ndarray:
    """Triangular mel filterbank with VTLN-style warp factor.

    The reference's peculiarities are preserved: the mel break frequency is
    1400 (not the usual 700/1127 pairing), band edges are *float* bin values
    bin = floor((nfft+1) * hz / srate) used with integer truncation for the
    support and float values for the slopes.
    """
    mel_max = 2595.0 * np.log10(1.0 + (srate / warp_fact) / 1400.0)
    fwarped = np.linspace(0.0, mel_max, nfilters + 2)
    nbins = int(np.floor(nfft / 2 + 1))
    hz_points = warp_fact * (700.0 * (10.0 ** (fwarped / 2595.0) - 1.0))
    bin_edges = np.floor((nfft + 1) * hz_points / srate)

    filts = np.zeros((nfilters, nbins))
    k = np.arange(nbins, dtype=np.float64)
    for m in range(1, nfilters + 1):
        f_lo, f_c, f_hi = bin_edges[m - 1], bin_edges[m], bin_edges[m + 1]
        lo, c, hi = int(f_lo), int(f_c), int(f_hi)
        rising = (k >= lo) & (k < c)
        falling = (k >= c) & (k < hi)
        with np.errstate(divide="ignore", invalid="ignore"):
            filts[m - 1] = np.where(rising, (k - f_lo) / (f_c - f_lo), filts[m - 1])
            filts[m - 1] = np.where(falling, (f_hi - k) / (f_hi - f_c), filts[m - 1])
    return filts


def _warp_bark(x, warp_fact=1.0):
    return 6.0 * np.arcsinh((x / warp_fact) / 600.0)


def cochlear_filterbank(
    nfilters: int,
    nfft: int,
    srate: float,
    om_w: float = 0.2,
    alp: float = 2.5,
    fixed: int = 1,
    bet: float = 2.5,
    warp_fact: float = 1.0,
) -> np.ndarray:
    """Bark-warped asymmetric-exponential cochlear filterbank.

    Each filter is flat (=1) within +-om_w/2 of its warped center frequency,
    rises as 10^(alp*(fw-fc+om_w/2)) below, and falls as
    10^(-bet*(fw-fc-om_w/2)) above; alp optionally decays with center
    frequency when fixed != 1.
    """
    f_max = srate / 2.0
    warped_max = _warp_bark(f_max, warp_fact)
    fwarped_cf = np.linspace(0.0, warped_max, nfilters)
    nbins = int(np.floor(nfft / 2 + 1))
    f_linear = np.linspace(0.0, f_max, nbins)
    f_warped = _warp_bark(f_linear, warp_fact)

    fc = fwarped_cf[:, None]  # (nfilters, 1)
    fw = f_warped[None, :]  # (1, nbins)
    if fixed == 1:
        alp_i = np.full((nfilters, 1), alp)
    else:
        alp_i = alp * np.exp(-0.1 * fc)
    d = fw - fc
    low = 10.0 ** (alp_i * (d + om_w / 2.0))
    high = 10.0 ** (-bet * (d - om_w / 2.0))
    filts = np.where(d <= -om_w / 2.0, low, np.where(d < om_w / 2.0, 1.0, high))
    return filts


def parse_fbank_type(fbank_type: str, nfilters: int, nfft: int, srate: float):
    """Parse the reference CLI convention 'mel,warp' or
    'cochlear,om_w,alp,fixed,bet,warp' into a filterbank matrix."""
    parts = fbank_type.strip().split(",")
    if parts[0] == "mel":
        if len(parts) < 2:
            raise ValueError("Mel filter bank not configured properly")
        return mel_filterbank(nfilters, nfft, srate, warp_fact=float(parts[1]))
    if parts[0] == "cochlear":
        if len(parts) < 6:
            raise ValueError("Cochlear filter bank not configured properly")
        return cochlear_filterbank(
            nfilters,
            nfft,
            srate,
            om_w=float(parts[1]),
            alp=float(parts[2]),
            fixed=int(parts[3]),
            bet=float(parts[4]),
            warp_fact=float(parts[5]),
        )
    raise ValueError("Invalid filter bank type; use mel or cochlear")
