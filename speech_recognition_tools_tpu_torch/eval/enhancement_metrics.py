"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/eval/enhancement_metrics.py, kept in the port so that it
imports nothing of the JAX package.

Speech-enhancement evaluation metrics.

Numpy ports of the REVERB challenge MATLAB suite the reference invokes
(e2e/reverb/local/REVERB_scores_source/.../evaltools/prog: cepsdist.m,
realceps.m, lpcllr.m, fwsegsnr.m, fft2melmx.m) plus STOI/eSTOI (Taal 2011 /
Jensen 2016) and projection SDR used by recipes/chime4/local/
stoi_estoi_sdr.m. All are host-side file-pair metrics (SURVEY.md §2.5).
Default parameters follow score_sim.m: frame 0.025 s, shift 0.01 s, hanning,
cepstrum/LPC order 24 (cd/llr), fwsegsnr 23 bands with 0.064 s frames... the
reference score_sim.m parameterisation is passed by callers.
"""

import numpy as np
from scipy.signal import resample_poly


def _frames_matlab(x, frame, shift, window):
    """MATLAB-style framing: num_frame = fix((N - frame + shift)/shift)."""
    num_frame = int((len(x) - frame + shift) // shift)
    idx = np.arange(frame)[:, None] + np.arange(num_frame)[None, :] * shift
    return x[idx] * window[:, None]


def _hanning_matlab(n):
    """MATLAB hanning(n): no zero endpoints."""
    return 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, n + 1) / (n + 1)))


def realceps(frames, flr=-100.0):
    """Real cepstrum per column (realceps.m)."""
    pt = 2 ** int(np.ceil(np.log2(frames.shape[0])))
    px = np.abs(np.fft.fft(frames, pt, axis=0))
    floor = px.max() * 10 ** (flr / 20)
    px = np.maximum(px, floor)
    return np.real(np.fft.ifft(np.log(px), axis=0))


def cepsdist(x, y, fs, frame=0.025, shift=0.01, order=24, cmn=True):
    """Cepstral distance in dB (cepsdist.m). Returns (mean, median)."""
    n = min(len(x), len(y))
    x, y = np.asarray(x[:n], np.float64), np.asarray(y[:n], np.float64)
    if not cmn:
        x = x / np.sqrt(np.sum(x**2))
        y = y / np.sqrt(np.sum(y**2))
    fr, sh = int(frame * fs), int(shift * fs)
    win = _hanning_matlab(fr)
    X = _frames_matlab(x, fr, sh, win)
    Y = _frames_matlab(y, fr, sh, win)
    cx = realceps(X)[: order + 1]
    cy = realceps(Y)[: order + 1]
    if cmn:
        cx = cx - cx.mean(axis=1, keepdims=True)
        cy = cy - cy.mean(axis=1, keepdims=True)
    err = (cx - cy) ** 2
    ds = 10 / np.log(10) * np.sqrt(2 * np.sum(err[1:], axis=0) + err[0])
    ds = np.clip(ds, 0, 10)
    return float(np.mean(ds)), float(np.median(ds))


def _levinson_np(r, order):
    """Levinson-Durbin like MATLAB levinson: returns monic A and error."""
    a = np.zeros(order + 1)
    a[0] = 1.0
    e = r[0]
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[i - 1 : 0 : -1])
        k = -acc / e
        a[1 : i + 1] = a[1 : i + 1] + k * a[i - 1 :: -1][: i]
        e *= 1 - k * k
    return a, e


def lpcllr(x, y, fs, frame=0.025, shift=0.01, lpcorder=24):
    """LPC log-likelihood ratio of x w.r.t. reference y (lpcllr.m)."""
    from scipy.linalg import toeplitz

    n = min(len(x), len(y))
    x, y = np.asarray(x[:n], np.float64), np.asarray(y[:n], np.float64)
    fr, sh = int(frame * fs), int(shift * fs)
    win = _hanning_matlab(fr)
    X = _frames_matlab(x, fr, sh, win)
    Y = _frames_matlab(y, fr, sh, win)
    pt = 2 ** int(np.ceil(np.log2(2 * fr - 1)))
    Rx = np.real(np.fft.ifft(np.abs(np.fft.fft(X, pt, axis=0)) ** 2, axis=0)) / fr
    Ry = np.real(np.fft.ifft(np.abs(np.fft.fft(Y, pt, axis=0)) ** 2, axis=0)) / fr
    num_frame = X.shape[1]
    ds = np.zeros(num_frame)
    for t in range(num_frame):
        ax, _ = _levinson_np(Rx[:, t], lpcorder)
        ay, _ = _levinson_np(Ry[:, t], lpcorder)
        R = toeplitz(Ry[: lpcorder + 1, t])
        num = ax @ R @ ax
        den = ay @ R @ ay
        ds[t] = np.log(num / den)
    ds = np.sort(ds)[: int(np.ceil(num_frame * 0.95))]
    ds = np.clip(ds, 0, 2)
    return float(np.mean(ds)), float(np.median(ds))


def _hz2mel_htk(f):
    return 2595.0 * np.log10(1 + np.asarray(f) / 700.0)


def _mel2hz_htk(z):
    return 700.0 * (10.0 ** (np.asarray(z) / 2595.0) - 1)


def fft2melmx_htk(nfft, sr, nfilts, minfrq=0.0, maxfrq=None, constamp=True):
    """HTK-mel triangular matrix (fft2melmx.m with htkmel=1, width=1)."""
    maxfrq = sr / 2 if maxfrq is None else maxfrq
    wts = np.zeros((nfilts, nfft))
    fftfrqs = np.arange(nfft) / nfft * sr
    minmel, maxmel = _hz2mel_htk(minfrq), _hz2mel_htk(maxfrq)
    binfrqs = _mel2hz_htk(
        minmel + np.arange(nfilts + 2) / (nfilts + 1) * (maxmel - minmel)
    )
    for i in range(nfilts):
        fs3 = binfrqs[i : i + 3]
        lo = (fftfrqs - fs3[0]) / (fs3[1] - fs3[0])
        hi = (fs3[2] - fftfrqs) / (fs3[2] - fs3[1])
        wts[i] = np.maximum(0, np.minimum(lo, hi))
    if not constamp:
        wts = np.diag(2.0 / (binfrqs[2 : nfilts + 2] - binfrqs[:nfilts])) @ wts
    wts[:, nfft // 2 + 1 :] = 0
    return wts


def fwsegsnr(x, y, fs, frame=0.025, shift=0.01, numband=23):
    """Frequency-weighted segmental SNR of x against reference y
    (fwsegsnr.m). Returns (mean, median) in dB."""
    x = np.asarray(x, np.float64) / np.sqrt(np.sum(np.asarray(x, np.float64) ** 2))
    y = np.asarray(y, np.float64) / np.sqrt(np.sum(np.asarray(y, np.float64) ** 2))
    fr, sh = int(frame * fs), int(shift * fs)
    win = _hanning_matlab(fr)
    fftpt = 2 ** int(np.ceil(np.log2(fr)))
    X = np.abs(np.fft.rfft(_frames_matlab(x, fr, sh, win), fftpt, axis=0))
    Y = np.abs(np.fft.rfft(_frames_matlab(y, fr, sh, win), fftpt, axis=0))
    melmat = fft2melmx_htk(fftpt, fs, numband)[:, : X.shape[0]]
    X, Y = melmat @ X, melmat @ Y
    W = Y**0.2
    E = X - Y
    # floor both band energies: synthetic signals can carry exact digital
    # silence, where log10(0) would poison the frame with NaN (real speech
    # never hits exact zero, so the floor is inert on the parity targets)
    ds = 10 * np.sum(
        W * np.log10(np.maximum(Y**2, 1e-30) / np.maximum(E**2, 1e-30)),
        axis=0,
    ) / np.maximum(np.sum(W, axis=0), 1e-30)
    ds = np.clip(ds, -10, 35)
    return float(np.mean(ds)), float(np.median(ds))


# --------------------------- STOI / eSTOI ---------------------------------

_STOI_FS = 10000
_STOI_FRAME = 256
_STOI_FFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150
_STOI_N = 30  # frames per intermediate segment
_STOI_BETA = -15.0
_STOI_DYN_RANGE = 40


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2 ** (-1.0 / 6)
    hi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        li = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, li:hi_i] = 1
    return obm


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    idx = np.arange(framelen)[None, :] + np.arange(n)[:, None] * hop
    energies = 20 * np.log10(
        np.linalg.norm(x[idx] * w, axis=1) + 1e-14
    )
    mask = energies > (np.max(energies) - dyn_range)
    xs, ys = [], []
    for i in range(n):
        if mask[i]:
            xs.append(x[idx[i]] * w)
            ys.append(y[idx[i]] * w)
    # overlap-add back
    if not xs:
        return x, y
    m = len(xs)
    xr = np.zeros((m - 1) * hop + framelen)
    yr = np.zeros_like(xr)
    for i in range(m):
        xr[i * hop : i * hop + framelen] += xs[i]
        yr[i * hop : i * hop + framelen] += ys[i]
    return xr, yr


def _stft_mag(x, framelen, hop, nfft):
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    idx = np.arange(framelen)[None, :] + np.arange(n)[:, None] * hop
    return np.abs(np.fft.rfft(x[idx] * w, nfft, axis=1)).T  # (bins, frames)


def stoi(x, y, fs, extended=False):
    """(e)STOI intelligibility of degraded y vs clean x (Taal et al. 2011;
    Jensen & Taal 2016 for extended=True)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if fs != _STOI_FS:
        x = resample_poly(x, _STOI_FS, fs)
        y = resample_poly(y, _STOI_FS, fs)
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_FRAME // 2)
    X = _stft_mag(x, _STOI_FRAME, _STOI_FRAME // 2, _STOI_FFT)
    Y = _stft_mag(y, _STOI_FRAME, _STOI_FRAME // 2, _STOI_FFT)
    obm = _thirdoct(_STOI_FS, _STOI_FFT, _STOI_NBANDS, _STOI_MINFREQ)
    Xb = np.sqrt(obm @ (X**2))  # (bands, frames)
    Yb = np.sqrt(obm @ (Y**2))
    T = Xb.shape[1]
    if T < _STOI_N:
        raise ValueError("signal too short for STOI")
    scores = []
    for m in range(_STOI_N, T + 1):
        Xseg = Xb[:, m - _STOI_N : m]
        Yseg = Yb[:, m - _STOI_N : m]
        if extended:
            Xn = (Xseg - Xseg.mean(axis=1, keepdims=True))
            Xn = Xn / (np.linalg.norm(Xn, axis=1, keepdims=True) + 1e-14)
            Xn = Xn - Xn.mean(axis=0, keepdims=True)
            Xn = Xn / (np.linalg.norm(Xn, axis=0, keepdims=True) + 1e-14)
            Yn = (Yseg - Yseg.mean(axis=1, keepdims=True))
            Yn = Yn / (np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-14)
            Yn = Yn - Yn.mean(axis=0, keepdims=True)
            Yn = Yn / (np.linalg.norm(Yn, axis=0, keepdims=True) + 1e-14)
            scores.append(np.sum(Xn * Yn) / Xn.shape[1])
        else:
            alpha = np.linalg.norm(Xseg, axis=1, keepdims=True) / (
                np.linalg.norm(Yseg, axis=1, keepdims=True) + 1e-14
            )
            Yp = np.minimum(Yseg * alpha, Xseg * (1 + 10 ** (-_STOI_BETA / 20)))
            xm = Xseg - Xseg.mean(axis=1, keepdims=True)
            ym = Yp - Yp.mean(axis=1, keepdims=True)
            corr = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-14
            )
            scores.append(np.mean(corr))
    return float(np.mean(scores))


def sdr(reference, estimate):
    """Projection SDR: target = <y,x>x/||x||^2, SDR = 10log10(||t||^2/||y-t||^2)."""
    x = np.asarray(reference, np.float64)
    y = np.asarray(estimate, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    t = (np.dot(y, x) / np.dot(x, x)) * x
    return float(10 * np.log10(np.sum(t**2) / np.maximum(np.sum((y - t) ** 2), 1e-30)))
