"""Multichannel corpus simulation: synthetic room impulse responses,
reverberant mixing at a target SNR, and a corpus writer.

Port of speech_recognition_tools_tpu/dsp/simulate.py. The REVERB / CHiME
recipes make multi-condition training data by convolving clean speech
with measured multichannel RIRs and adding recorded noise at a fixed SNR
(the reference's e2e/reverb/local/Generate_mcTrainData_cut.m: SNRdB=20,
24 RIR variants over small / medium / large rooms, one random pick per
utterance). Measured RIR wavs do not ship with the toolkit, so RIRs are
synthesised: a coherent direct path with geometric inter-channel delays
plus an exponentially decaying diffuse tail (decorrelated across channels)
set by T60. Convolution is a power-of-two rFFT product.

Randomness is explicit. Where the JAX package splits jax.random keys,
these functions take the draws themselves (`draws`, `offset`, `white`:
e.g. jax.random's own numbers, for parity) or draw them from a
torch.Generator; `simulate_corpus` draws everything from one
torch.Generator(seed), so its bits differ from the JAX corpus's.
"""

import os

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import resolve_device
from speech_recognition_tools_tpu_torch.enhance.stft import as_tensor


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def synth_rir(n_channels: int = 4, fs: int = 16000, t60: float = 0.4,
              rir_len: int | None = None, direct_delay: int = 40,
              mic_spacing_s: float = 2.9e-4, direct_to_reverb_db: float = 3.0, *,
              draws=None, generator: torch.Generator | None = None,
              dtype=torch.float32, device=None):
    """Synthesise a (C, L) multichannel RIR.

    Each channel gets a unit direct-path impulse at
    direct_delay + c * round(mic_spacing_s * fs) (a far-field source off
    the array axis), then a diffuse tail of Gaussian noise under an
    exp(-6.9077 t / T60) envelope, coherent over the first 50 ms (shared
    early reflections) and decorrelated after (the late field).

    draws: (shared (L,), diffuse (C, L)) standard normal draws, or None to
    draw them from `generator`."""
    dev = resolve_device(device or "cuda")
    if rir_len is None:
        rir_len = int(1.5 * t60 * fs)
    rir_len = max(rir_len, direct_delay + 8)
    if draws is None:
        draws = (torch.randn(rir_len, generator=generator, dtype=dtype),
                 torch.randn(n_channels, rir_len, generator=generator, dtype=dtype))
    shared = as_tensor(draws[0], dev).to(dtype)
    diffuse = as_tensor(draws[1], dev).to(dtype)
    t = torch.arange(rir_len, device=dev, dtype=dtype) / fs
    decay = torch.exp(-6.9077 * t / t60)  # ln(10^3): -60 dB at T60
    early = torch.clamp(1.0 - t / 0.05, 0.0, 1.0)
    tail = (early * shared[None, :] + (1.0 - early) * diffuse) * decay[None, :]
    mic_delay = int(round(mic_spacing_s * fs))
    arrivals = direct_delay + mic_delay * torch.arange(n_channels, device=dev)
    tail = tail * (torch.arange(rir_len, device=dev)[None, :] > arrivals[:, None])
    direct = torch.nn.functional.one_hot(arrivals, rir_len).to(dtype)
    tail_energy = torch.sqrt((tail**2).sum(1, keepdim=True))
    g = 10.0 ** (-direct_to_reverb_db / 20.0) / torch.clamp(tail_energy, min=1e-12)
    return direct + g * tail


def fft_convolve_full(sig, rir):
    """Full convolution along the last axis by a power-of-two rFFT:
    sig (..., N), rir (..., L) -> (..., N + L - 1); leading dims broadcast."""
    n = sig.shape[-1] + rir.shape[-1] - 1
    nfft = _next_pow2(max(n, 2))
    S = torch.fft.rfft(sig, nfft)
    H = torch.fft.rfft(rir, nfft)
    return torch.fft.irfft(S * H, nfft)[..., :n]


def simulate_utterance(clean, rirs, noise=None, snr_db: float = 20.0,
                       return_components: bool = False, *, offset=None, white=None,
                       generator: torch.Generator | None = None):
    """One clean (N,) utterance -> (C, N) reverberant noisy observation
    (Generate_mcTrainData_cut.m): the reverberant image conv(clean, rir_c)
    cut to N samples, plus noise scaled so that the *first channel* sits
    at snr_db, the same gain on every channel.

    noise: (C, >= N) multichannel, (M,) mono (the same segment on every
    channel), or None for white Gaussian noise. The segment's `offset`
    (an int in [0, max(M - N, 1))) or the white noise `white` (C, N) is
    drawn from `generator` when not given. Tensors stay on `rirs`'
    device."""
    rirs = as_tensor(rirs)
    clean = as_tensor(clean, rirs.device).to(rirs.dtype)
    C, n = rirs.shape[0], clean.shape[-1]
    wet = fft_convolve_full(clean[None, :], rirs)[:, :n]
    if noise is None:
        if white is None:
            white = torch.randn(C, n, generator=generator, dtype=wet.dtype)
        ns = as_tensor(white, wet.device).to(wet.dtype)
    else:
        noise = as_tensor(noise, wet.device).to(wet.dtype)
        if offset is None:
            offset = int(torch.randint(0, max(noise.shape[-1] - n, 1), (),
                                       generator=generator))
        off = min(int(offset), noise.shape[-1] - n)  # dynamic_slice's clamp
        ns = noise[..., off : off + n]
        ns = ns[None].expand(C, n) if ns.ndim == 1 else ns[:C]
    e_s = (wet[0] ** 2).mean()
    e_n = (ns[0] ** 2).mean()
    g = torch.sqrt(e_s / torch.clamp(e_n * 10.0 ** (snr_db / 10.0), min=1e-20))
    if return_components:
        # the parallel wet-speech and scaled-noise images: the CHiME
        # simulation's .Clean / .Noise artefacts that mask training reads
        return wet + g * ns, wet, g * ns
    return wet + g * ns


def simulate_corpus(clean_utts, out_dir: str, *, fs: int = 16000, n_channels: int = 4,
                    snr_db: float = 20.0, t60_choices=(0.25, 0.5, 0.7), noise=None,
                    seed: int = 0, device=None):
    """Simulate a multi-condition multichannel corpus.

    clean_utts: iterable of (utt_id, (N,) float array). Writes
    <out_dir>/<utt>_ch<k>.wav and wav_ch<k>.scp per channel, wav.scp
    (channel 0), the clean references <utt>_clean.wav and clean.scp, and
    the channel-0 wet and noise images with wet.scp and noise.scp: the JAX
    package's layout (the REVERB data prep's wav dir and per-condition
    scps), float32 wavs. Per utterance a T60 is drawn from t60_choices
    and a fresh RIR synthesised (Generate_mcTrainData_cut.m's random pick
    among its measured RIRs). Returns {utt: {"t60", "snr_db",
    "n_channels"}}."""
    from scipy.io.wavfile import write as wav_write

    dev = resolve_device(device or "cuda")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    if noise is not None:
        noise = torch.as_tensor(np.asarray(noise, np.float32), device=dev)
    scps = {c: [] for c in range(n_channels)}
    clean_scp, meta = [], {}
    for utt, sig in clean_utts:
        sig = np.asarray(sig, np.float32)
        t60 = float(np.asarray(t60_choices)[int(torch.randint(0, len(t60_choices), (),
                                                              generator=gen))])
        rirs = synth_rir(n_channels, fs, t60, generator=gen, device=dev)
        obs, wet, ns = simulate_utterance(torch.as_tensor(sig, device=dev), rirs, noise,
                                          snr_db, return_components=True, generator=gen)
        obs = obs.cpu().numpy()
        clean_path = os.path.join(out_dir, f"{utt}_clean.wav")
        wav_write(clean_path, fs, sig)
        clean_scp.append(f"{utt} {clean_path}")
        wav_write(os.path.join(out_dir, f"{utt}_wet.wav"), fs,
                  wet[0].cpu().numpy().astype(np.float32))
        wav_write(os.path.join(out_dir, f"{utt}_noise.wav"), fs,
                  ns[0].cpu().numpy().astype(np.float32))
        for c in range(n_channels):
            path = os.path.join(out_dir, f"{utt}_ch{c}.wav")
            wav_write(path, fs, obs[c].astype(np.float32))
            scps[c].append(f"{utt} {path}")
        meta[utt] = {"t60": t60, "snr_db": snr_db, "n_channels": n_channels}
    for c in range(n_channels):
        with open(os.path.join(out_dir, f"wav_ch{c}.scp"), "w") as f:
            f.write("\n".join(scps[c]) + "\n")
    with open(os.path.join(out_dir, "wav.scp"), "w") as f:
        f.write("\n".join(scps[0]) + "\n")
    with open(os.path.join(out_dir, "clean.scp"), "w") as f:
        f.write("\n".join(clean_scp) + "\n")
    for kind in ("wet", "noise"):
        with open(os.path.join(out_dir, f"{kind}.scp"), "w") as f:
            for line in clean_scp:
                utt, path = line.split(None, 1)
                f.write(f"{utt} {path.replace('_clean.wav', f'_{kind}.wav')}\n")
    return meta
