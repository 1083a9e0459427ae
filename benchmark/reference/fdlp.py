"""Plain reference of the FDLP spectrogram (fast mode), one utterance at a
time, written from the algorithm of the upstream computeFDLPSpectrogram.py
(getFrames, createFbank, computeLpcFast, computeModSpecFromLpc and its
overlap-add) as the configuration sets it. Imports nothing of the port.

  1. reflect-padded framing: windows of fduration s every 1 / lfr s,
     lfr = 1 / ((1 - overlap_fraction) fduration), Hamming-windowed;
  2. DCT-II of each window (scipy's unnormalised form, here through the
     FFT of the window and its mirror) / sqrt(2 srate fduration);
  3. per mel band (the reference's triangular bank with its 1400 Hz
     break, fbank[:, :-1]) the autocorrelation of the band's DCT at lags
     0 .. order + 1, one product per lag; the fast mode's ridge r0 *=
     1 + 1e-4 (what "fast" states, beside float32);
  4. Levinson-Durbin (the textbook recursion, |k| <= 1 - 16 eps), the
     reference's gain r0 + r1 + sum_k a_k r_{k+1} (max(E r0, 0) where it is
     not positive), the LPC cepstrum;
  5. the coefficients in coeff_range kept, log-envelope by the cosine sum
     over 2 fduration frate points, capped at 75 before exp (fast mode),
     times hanning(kk) / hamming(kk);
  6. overlap-add: window 0's second half at 0, window i at
     i hop - kk/2 with hop = round(0.75 fduration frate), cut to
     ceil(n frate / srate) frames; log of the sum floored at 1e-14.
"""

import math

import numpy as np
import torch

from benchmark.reference.precision import Precision


def mel_filterbank(nfilters: int, nfft: int, srate: float, warp: float = 1.0) -> np.ndarray:
    """The reference's triangular mel bank: mel = 2595 log10(1 + f / 1400)
    at the top, 700 in the inverse, float band edges floor((nfft + 1) f /
    srate), integer supports, float slopes."""
    mel_max = 2595.0 * np.log10(1.0 + (srate / warp) / 1400.0)
    hz = warp * (700.0 * (10.0 ** (np.linspace(0.0, mel_max, nfilters + 2) / 2595.0) - 1.0))
    edges = np.floor((nfft + 1) * hz / srate)
    nbins = int(np.floor(nfft / 2 + 1))
    k = np.arange(nbins, dtype=np.float64)
    out = np.zeros((nfilters, nbins))
    for m in range(nfilters):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (k >= int(lo)) & (k < int(c))
        down = (k >= int(c)) & (k < int(hi))
        with np.errstate(divide="ignore", invalid="ignore"):
            out[m] = np.where(up, (k - lo) / (c - lo), out[m])
            out[m] = np.where(down, (hi - k) / (hi - c), out[m])
    return out


def geometry(fe: dict) -> dict:
    srate, fdur = fe["srate"], fe["fduration"]
    flen = int(srate * fdur)
    lfr = 1.0 / ((1.0 - fe["overlap_fraction"]) * fdur)
    half_b = flen // 2 - 1 if flen % 2 == 0 else (flen - 1) // 2
    half_f = flen // 2 if flen % 2 == 0 else (flen - 1) // 2
    return dict(flen=flen, hop=int(srate / lfr), extend=half_b, sp=half_b + half_f,
                kk=int(np.round(fdur * fe["frate"])), kkb2=int(np.round(fdur * fe["frate"] / 2)),
                ola_hop=int(np.round(fdur * fe["frate"] * (1.0 - fe["overlap_fraction"]))),
                nfft_env=2 * int(fdur * fe["frate"]))


def frame_count(n: int, g: dict) -> int:
    return max(0, -(-(n + 2 * g["extend"] - g["sp"]) // g["hop"]))


def dct2(x: torch.Tensor) -> torch.Tensor:
    """y[k] = 2 sum_n x[n] cos(pi k (2n + 1) / 2N) = Re(exp(-i pi k / 2N)
    FFT([x, x reversed])[k])."""
    N = x.shape[-1]
    z = torch.fft.fft(torch.cat([x, x.flip(-1)], -1), dim=-1)[..., :N]
    k = torch.arange(N, device=x.device, dtype=torch.float64)
    tw = torch.exp(-1j * math.pi * k / (2 * N)).to(z.dtype)
    return torch.real(z * tw)


def levinson(r, order):
    """(rows, >= order + 1) lags -> predictor a (rows, order), error E."""
    eps = torch.finfo(r.dtype).eps
    kmax = 1.0 - 16.0 * eps
    r0 = torch.where(r[:, 0] == 0, torch.ones_like(r[:, 0]), r[:, 0])
    rn = r[:, 1:order + 1] / r0[:, None]
    a = r.new_zeros(r.shape[0], order)
    e = r.new_ones(r.shape[0])
    for i in range(order):
        acc = (a[:, :i] * rn[:, :i].flip(-1)).sum(-1) if i else 0.0
        k = torch.clamp(-(rn[:, i] + acc) / torch.clamp(e, min=torch.finfo(r.dtype).tiny),
                        -kmax, kmax)
        new = a.clone()
        new[:, :i] = a[:, :i] + k[:, None] * a[:, :i].flip(-1)
        new[:, i] = k
        a = new
        e = e * (1.0 - k * k)
    return a, e


def cepstrum(a, gg, lim):
    b = torch.cat([torch.ones_like(a[:, :1]), -a], -1)
    if b.shape[1] < lim + 1:
        b = torch.cat([b, b.new_zeros(b.shape[0], lim + 1 - b.shape[1])], -1)
    c = [torch.log(torch.sqrt(gg))]
    if lim > 1:
        c.append(b[:, 1])
    for n in range(2, lim):
        m = torch.arange(1, n, device=a.device, dtype=a.dtype)
        prev = torch.stack(c[1:n], -1)
        c.append(((m / n) * b[:, 1:n].flip(-1) * prev).sum(-1) + b[:, n])
    return torch.stack(c, -1)


def features(signal, fe: dict, P: Precision, device) -> torch.Tensor:
    """One utterance (n,) of int16-scale samples -> (ceil(n frate / srate),
    nfilters) log FDLP spectrogram."""
    g = geometry(fe)
    srate, fdur, nb, order = fe["srate"], fe["fduration"], fe["nfilters"], fe["order"]
    lim = fe["coeff_num"]
    x = np.asarray(signal, np.float64)
    n = len(x)
    xp = np.pad(x, (g["extend"], g["extend"]), mode="reflect")
    F = frame_count(n, g)
    frames = np.stack([xp[i * g["hop"]: i * g["hop"] + g["flen"]] for i in range(F)])
    frames = torch.as_tensor(frames * np.hamming(g["flen"]), device=device)
    spec = (dct2(frames) / math.sqrt(2 * int(srate * fdur))).to(P.dtype)

    fb = torch.as_tensor(mel_filterbank(nb, int(2 * fdur * srate), srate,
                                        float(fe["fbank_type"].split(",")[1]))[:, :-1],
                         device=device).to(P.dtype)
    N = spec.shape[1]
    lags = torch.stack([P.mm(spec[:, : N - k] * spec[:, k:], (fb[:, : N - k] * fb[:, k:]).T)
                        for k in range(order + 2)], -1)  # (F, nb, order + 2)
    lags[..., 0] = lags[..., 0] * (1.0 + 1e-4)
    r = lags.reshape(F * nb, order + 2)
    a, e = levinson(r, order)
    gg = r[:, 0] + r[:, 1] + (a * r[:, 2:order + 2]).sum(-1)
    gg = torch.where(gg > 0, gg, torch.clamp(torch.clamp(e * r[:, 0], min=0.0),
                                            min=torch.finfo(r.dtype).tiny))
    cep = cepstrum(a, gg, lim)
    lo, hi = (int(v) for v in fe["coeff_range"].split(","))
    idx = torch.arange(lim, device=device)
    cep = cep * ((idx >= lo) & (idx <= hi)).to(cep.dtype)
    kk, kkb2 = g["kk"], g["kkb2"]
    cos = torch.cos(2 * math.pi * torch.arange(lim, device=device, dtype=torch.float64)[:, None]
                    * torch.arange(kk, device=device, dtype=torch.float64)[None, :]
                    / g["nfft_env"]).to(P.dtype)
    env = torch.exp(torch.clamp(P.mm(cep, cos), max=75.0))
    env = env * torch.as_tensor(np.hanning(kk) / np.hamming(kk), device=device).to(P.dtype)
    env = env.reshape(F, nb, kk)

    T = -(-n * fe["frate"] // srate)
    out = env.new_zeros(nb, T + kk + F * g["ola_hop"])
    for i in range(F):
        if i == 0:
            out[:, : kk - kkb2] += env[0, :, kkb2:]
        else:
            start = i * g["ola_hop"] - kkb2
            out[:, start: start + kk] += env[i]
    return torch.log(torch.clamp(out[:, :T], min=1e-14)).T
