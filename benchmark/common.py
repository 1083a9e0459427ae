"""Seeded inputs and weights, and the H100's peaks.

`speechlike_signals`, `random_transcript` and `k1_work` are copies of
chip_smoke.py's `speechlike_batch`, `random_transcript` and `k1_work`
(the smoke script is not imported). Weights are drawn here, not by the
port: one draw on the device from a torch.Generator seeded with the run's
seed, split over the parameters, then copied into the program's modules.
The plain references read the same dict of weights.
"""

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def numpy_seed(seed: int) -> int:
    """A seed numpy's RandomState takes (below 2**32)."""
    return int(seed) % 2**32


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def lengths_grid(n: int, lo: float, hi: float, unit: float, seed: int) -> np.ndarray:
    """n lengths evenly spread over [lo, hi] (in units of `unit`), the same
    set for every seed, in an order drawn from the seed."""
    lens = np.round(np.linspace(lo, hi, n) / unit).astype(np.int64)
    return np.random.RandomState(numpy_seed(seed)).permutation(lens)


def draw_weights(module: torch.nn.Module, gen: torch.Generator, device) -> dict:
    """Seeded weights for every parameter of `module`, in one draw on the
    device: a matrix or kernel N(0, 1 / fan_in) (fan_in: all but its first
    axis), a vector 0.02 N(0, 1), a LayerNorm scale 1 + 0.02 N(0, 1), so
    that every leaf matters. Loads them into `module` and returns them
    (name -> tensor, the module's own dtype)."""
    scales = {id(m.weight) for m in module.modules() if type(m).__name__ == "LayerNorm"}
    named = list(module.named_parameters())
    total = sum(p.numel() for _, p in named)
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    with torch.no_grad():
        for name, p in named:
            d = draw[off : off + p.numel()].view(p.shape)
            off += p.numel()
            if p.dim() >= 2:
                w = d / float(np.sqrt(p[0].numel()))
            elif id(p) in scales:
                w = 1.0 + 0.02 * d
            else:
                w = 0.02 * d
            p.copy_(w.to(p.dtype))
            out[name] = p.detach().clone()
    return out


def speechlike_signals(rng, lens, srate=16000):
    """Utterances of the given sample counts: noise through two
    resonances, syllable-rate amplitude modulation, int16 scale (float64
    arrays)."""
    import scipy.signal

    out = []
    for n in lens:
        e = rng.randn(int(n))
        for f0 in rng.uniform(300, 3000, 2):
            a1 = 2 * 0.97 * np.cos(2 * np.pi * f0 / srate)
            e = scipy.signal.lfilter([1.0], [1.0, -a1, 0.97**2], e)
        t = np.arange(int(n)) / srate
        am = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
        out.append(np.round(e * am / np.abs(e).max() * 12000))
    return out


def random_transcript(rng, letters, n_chars, repeat_p=0.15):
    """n_chars of words over `letters`, with doubled letters at repeat_p."""
    out = []
    while len(out) < n_chars:
        if out and out[-1] != " " and rng.rand() < 0.2:
            out.append(" ")
        elif out and out[-1] != " " and rng.rand() < repeat_p:
            out.append(out[-1])
        else:
            out.append(letters[rng.randint(len(letters))])
    return "".join(out).strip().replace("  ", " ")


def k1_work(P, order, lim):
    """(flops, bytes) the K1 function needs, per row: normalisation p,
    Levinson 2p(p-1) (a dot and an update per step), gain 2p; cepstrum c_n
    for 2 <= n < lim as one FMA (2 flops) per term b[n-m] d_m with
    d_m = m c_m kept, over the terms whose b[n-m] is nonzero (n-m <= p),
    plus 3 per n (scale by 1/n and add b[n], form d_n). Bytes: each input
    lag read once (order+2 per row), each output written once."""
    flops = order + 2 * order * (order - 1) + 2 * order
    flops += sum(2 * min(n - 1, order) + 3 for n in range(2, lim))
    return P * flops, P * (order + 2 + lim) * 4


def k1_bound_s(P, order, lim):
    """The least time the H100 could take for K1 on P rows."""
    flops, nbytes = k1_work(P, order, lim)
    return max(flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S)

