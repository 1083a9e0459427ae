"""WPE (weighted prediction error) dereverberation, host reference.

Host copy of speech_recognition_tools_tpu/enhance/wpe.py. The reference
wraps nara_wpe with taps=10, delay=3, iterations=5 over a 512/128 STFT
(e2e/reverb/local/run_wpe.py:29-49). This is an iterative MIMO-WPE: per
frequency bin, a multichannel linear prediction filter on delayed
observations, weighted by the inverse signal power, estimates the late
reverberation, which is subtracted; then the next iteration.

The per-bin (taps * D)^2 solves run in numpy float64 / complex128,
vectorised over bins; `wpe_dereverberate` frames with the port's STFT on
the CPU. The device version is enhance/onchip.py::wpe_onchip.
"""

import numpy as np


def _build_delayed(Y, taps, delay):
    """Stack delayed observations.

    Y: (F, D, T). Returns Ytilde: (F, taps*D, T) where
    Ytilde[f, k*D+d, t] = Y[f, d, t - delay - k].
    """
    F, D, T = Y.shape
    out = np.zeros((F, taps * D, T), Y.dtype)
    for k in range(taps):
        shift = delay + k
        if shift < T:
            out[:, k * D : (k + 1) * D, shift:] = Y[:, :, : T - shift]
    return out


def wpe(Y, taps: int = 10, delay: int = 3, iterations: int = 5, eps: float = 1e-10):
    """Iterative WPE on an STFT tensor.

    Args:
      Y: (F, D, T) complex STFT (bins, channels, frames).
    Returns: (F, D, T) dereverberated STFT.
    """
    F, D, T = Y.shape
    Yt = _build_delayed(Y, taps, delay)  # (F, K, T), K = taps*D
    X = Y.copy()
    for _ in range(iterations):
        power = np.maximum(np.mean(np.abs(X) ** 2, axis=1), eps)  # (F, T)
        w = 1.0 / power  # (F, T)
        # R = sum_t w_t ytilde_t ytilde_t^H   (F, K, K)
        R = np.einsum("fkt,flt,ft->fkl", Yt, Yt.conj(), w)
        # P = sum_t w_t ytilde_t y_t^H        (F, K, D)
        P = np.einsum("fkt,fdt,ft->fkd", Yt, Y.conj(), w)
        K = R.shape[1]
        R = R + eps * np.trace(R, axis1=1, axis2=2)[:, None, None] / K * np.eye(K)
        G = np.linalg.solve(R, P)  # (F, K, D) prediction filters
        X = Y - np.einsum("fkd,fkt->fdt", G.conj(), Yt)
    return X


def wpe_dereverberate(
    signals,
    size: int = 512,
    shift: int = 128,
    taps: int = 10,
    delay: int = 3,
    iterations: int = 5,
):
    """Dereverberate multichannel time signals (reference run_wpe.py flow):
    STFT (512/128) -> WPE -> iSTFT.

    signals: (D, samples). Returns (D, samples).
    """
    from speech_recognition_tools_tpu_torch.enhance.stft import istft, stft

    Y = stft(np.asarray(signals), size=size, shift=shift, device="cpu").numpy()  # (D, T, F)
    Yf = np.transpose(Y, (2, 0, 1))  # (F, D, T)
    Xf = wpe(Yf, taps=taps, delay=delay, iterations=iterations)
    X = np.ascontiguousarray(np.transpose(Xf, (1, 2, 0)))  # (D, T, F)
    out = istft(X, size=size, shift=shift, device="cpu").numpy()
    return out[..., : signals.shape[-1]]
