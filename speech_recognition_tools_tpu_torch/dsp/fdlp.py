"""FDLP spectrogram for a batch of waveforms, fast (float32) and high
(float64) precision.

Port of speech_recognition_tools_tpu/dsp/fdlp.py (reference:
featgen/computeFDLPSpectrogram.py getFeats, :29-237):

  1. long analysis windows (fduration s) at the low frame rate
     lfr = 1/(overlap_fraction * fduration)                      [framing]
  2. DCT-II of each window / sqrt(2 * srate * fduration)         [dct]
  3. per mel/cochlear band: banded autocorrelation of the masked DCT,
     Levinson-Durbin LPC(order), LPC -> cepstrum(coeff_num)      [K1]
     then mask / lifter / gamma weights / odd-zero
  4. pole-model Hilbert envelope exp(cepstrum @ cos-DFT matrix)  [envelope]
  5. window-compensated overlap-add back to `frate` Hz frames    [ola]
  6. log(clip(., 1e-14))

The per-(frame x band) LPC problems are flattened into one problem axis;
on a CUDA float32 batch they go through the hand-written kernel K1
(ops/lpc_cepstra.py), elsewhere through the plain Levinson + cepstrum
loops.

precision="high" (alias "mixed") computes in float64 from the window
multiply on: the DCT, the lags (support-compacted,
ops/autocorr.py::banded_autocorr_compact, whenever the work type is
float64), the LPC stage (the blocked Schur/Szego solver by default: K1 is
float32-only in both packages, so in float64 this stage runs as torch ops
on either device, as the JAX package runs XLA scans there), the envelope
projection and its exp, and the final log. The overlap-add and the output
are of the I/O dtype.

Sequence parallelism (`fdlp_spectrogram_sharded`,
`fdlp_spectrogram_input_sharded`): the analysis frames split over a
mesh's 'time' axis, each rank running the chain above (K1 on its own
rows) for its block, the overlap-add stitched by a halo exchange.

Numerics kept from the JAX package: the f32-only white-noise ridge
r0 *= 1 + 1e-4 (the validated value), the envelope exponent cap (75 in
float32, 700 in float64), the clip at 1e-14 before the log, and output
lengths ceil(n * frate / srate).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.dsp.filterbanks import parse_fbank_type
from speech_recognition_tools_tpu_torch.ops.autocorr import (
    banded_autocorr,
    banded_autocorr_compact,
    banded_support_plan,
    banded_supports_separable,
)
from speech_recognition_tools_tpu_torch.ops.cepstrum import lpc_to_cepstrum
from speech_recognition_tools_tpu_torch.ops.dct import dct2
from speech_recognition_tools_tpu_torch.ops.framing import (
    frame_count,
    frame_params,
    frame_signal,
)
from speech_recognition_tools_tpu_torch.ops.levinson import lpc_from_autocorr
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
    lpc_cepstra,
    lpc_cepstra_reference,
)
from speech_recognition_tools_tpu_torch.ops.ola import ola_positions, overlap_add
from speech_recognition_tools_tpu_torch.ops.windows import WINDOWS
from speech_recognition_tools_tpu_torch.utils.profiling import span

HIGH_PRECISIONS = ("high", "mixed")


@dataclass(frozen=True)
class FdlpConfig:
    """Static FDLP configuration (CLI-flag parity with the reference)."""

    srate: int = 16000
    nfilters: int = 20
    coeff_num: int = 50
    coeff_range: str = "1,20"
    order: int = 50
    fduration: float = 0.5
    frate: int = 100
    overlap_fraction: float = 0.25  # input convention; used = 1 - this
    fbank_type: str = "mel,1"
    odd_mod_zero: bool = False
    gamma_weight: str = "None"  # 'scale,shape,pk'
    lifter_config: tuple | None = None
    window: str = "hamming"
    # 'fast' (the I/O dtype throughout) | 'high' (float64 from the window
    # multiply on; 'mixed' is an alias)
    precision: str = "fast"
    # LPC + cepstrum backend: 'auto' = K1 in float32 (its plain version on
    # the CPU) and 'blocked:15' in float64; 'fused' = K1; 'scan' (or
    # 'scan:unroll=N', the same computation) = the plain Levinson and
    # cepstrum loops; 'blocked[:B]' = the blocked Schur/Szego Levinson, B
    # steps a block (default 15), then the cepstrum loop
    lpc_backend: str = "auto"

    @property
    def overlap_used(self) -> float:
        return 1.0 - self.overlap_fraction

    @property
    def lfr(self) -> float:
        return 1.0 / (self.overlap_used * self.fduration)


@lru_cache(maxsize=32)
def _host_constants(cfg: FdlpConfig):
    """All data-independent constants, in float64 on the host."""
    fp = frame_params(cfg.srate, cfg.lfr, cfg.fduration)
    ndct = fp.flength_samples

    nfft_fb = int(2 * cfg.fduration * cfg.srate)
    fbank = parse_fbank_type(cfg.fbank_type, cfg.nfilters, nfft_fb, cfg.srate)
    fbank = fbank[:, :-1]  # reference uses fbank[j, 0:-1]
    if fbank.shape[1] != ndct:
        raise ValueError(f"filterbank width {fbank.shape[1]} != window {ndct}")

    win = WINDOWS[cfg.window](ndct)

    lowpass, highpass = (int(x) for x in cfg.coeff_range.split(","))
    idx = np.arange(cfg.coeff_num)
    mask = ((idx >= lowpass) & (idx <= highpass)).astype(np.float64)

    weights = mask.copy()
    if cfg.lifter_config is not None:
        weights = weights * np.asarray(cfg.lifter_config, dtype=np.float64)
    gw = cfg.gamma_weight.strip().split(",")
    if gw[0] != "None":
        import scipy.stats as stats

        scale, shape, pk_required = float(gw[0]), float(gw[1]), float(gw[2])
        x = np.linspace(0, cfg.order - 1, cfg.order)
        res = 2 * cfg.fduration
        pk_required = pk_required * res
        pk = (shape - 1) * scale
        loc = -pk + pk_required
        mod_wts = stats.gamma.pdf(x, a=shape, loc=loc, scale=scale) * 3 * scale
        weights = weights * mod_wts[: cfg.coeff_num]
    if cfg.odd_mod_zero:
        weights = weights * (1.0 - (idx % 2))

    kk = int(np.round(cfg.fduration * cfg.frate))
    kkb2 = int(np.round(cfg.fduration * cfg.frate / 2))
    hop = int(np.round(cfg.fduration * cfg.frate * cfg.overlap_used))
    nfft_env = 2 * int(cfg.fduration * cfg.frate)
    # Re(FFT(c, nfft_env))[k] = sum_n c[n] cos(2 pi k n / nfft_env), k < kk
    nidx = np.arange(cfg.coeff_num)[:, None]
    kidx = np.arange(kk)[None, :]
    cosmat = np.cos(2.0 * np.pi * nidx * kidx / nfft_env)
    env_win = np.hanning(kk) / WINDOWS[cfg.window](kk)

    return dict(fp=fp, fbank=fbank, win=win, weights=weights, kk=kk,
                kkb2=kkb2, hop=hop, cosmat=cosmat, env_win=env_win)


@lru_cache(maxsize=8)
def _device_constants(cfg: FdlpConfig, dtype: torch.dtype, device: torch.device):
    """The host constants as tensors of `dtype` on `device`."""
    c = _host_constants(cfg)
    return {k: torch.as_tensor(c[k], dtype=dtype, device=device)
            for k in ("fbank", "win", "weights", "cosmat", "env_win")}


@lru_cache(maxsize=32)
def _support_plan(cfg: FdlpConfig):
    return banded_support_plan(_host_constants(cfg)["fbank"], cfg.order + 2)


def _work_dtype(cfg: FdlpConfig, dtype: torch.dtype) -> torch.dtype:
    """float64 at high precision, else the I/O dtype."""
    return torch.float64 if cfg.precision in HIGH_PRECISIONS else dtype


def _resolve_backend(backend: str, dtype: torch.dtype) -> str:
    """What `backend` runs at work type `dtype`: 'fused', 'scan' or
    'blocked:B'."""
    if backend == "auto":
        return "blocked:15" if dtype == torch.float64 else "fused"
    if backend == "blocked":
        return "blocked:15"
    if backend == "scan" or backend.startswith("scan:unroll="):
        return "scan"
    if backend == "fused" or (backend.startswith("blocked:")
                              and backend.split(":", 1)[1].isdigit()):
        return backend
    raise ValueError(f"unknown lpc_backend {backend!r}")


def _lpc_cepstra(r, order, coeff_num, backend="auto"):
    """(P, nb, order+2) lags -> (P, nb, coeff_num) cepstra."""
    P, nb, L = r.shape
    flat = r.reshape(P * nb, L)
    backend = _resolve_backend(backend, r.dtype)
    if backend == "fused":
        cep = lpc_cepstra(flat, order, coeff_num)
    elif backend == "scan":
        cep = lpc_cepstra_reference(flat, order, coeff_num)
    else:
        block = int(backend.split(":", 1)[1])
        cep = lpc_to_cepstrum(*lpc_from_autocorr(flat, order, block=block), coeff_num)
    return cep.reshape(P, nb, coeff_num)


def _setup(cfg: FdlpConfig, dtype: torch.dtype, device):
    """(device, host constants, device constants of `dtype`) for a run of
    `cfg`."""
    if cfg.precision not in ("fast",) + HIGH_PRECISIONS:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    _resolve_backend(cfg.lpc_backend, dtype)
    dev = resolve_device(device)
    if dev.type == "cuda":
        configure_cuda()
    c = _host_constants(cfg)
    if not banded_supports_separable(c["fbank"], cfg.order + 2):
        raise ValueError("a filterbank band wraps the spectrum ends; "
                         "banded_autocorr would drop its circular wrap terms")
    return dev, c, _device_constants(cfg, dtype, dev)


def _window_lags(windows, cfg: FdlpConfig, k):
    """(P, flen) raw analysis windows -> (P, nb, order+2) lags of the work
    type: window, DCT-II / sqrt(2 srate fduration), banded autocorrelation
    (support-compacted in float64), and in float32 the white-noise ridge.
    `k` are the device constants of the I/O dtype."""
    work = _work_dtype(cfg, windows.dtype)
    kw = _device_constants(cfg, work, windows.device)
    cos_dct = dct2(windows.to(work) * kw["win"]) * (
        1.0 / np.sqrt(2 * int(cfg.srate * cfg.fduration)))
    if work == torch.float64:
        return banded_autocorr_compact(cos_dct, kw["fbank"], cfg.order + 2,
                                       _support_plan(cfg))
    r = banded_autocorr(cos_dct, k["fbank"], cfg.order + 2)
    if r.dtype == torch.float32:
        # f32 only: a tiny diagonal loading bounds the LPC pole radii on
        # near-periodic audio, whose order-150 predictors otherwise carry
        # coefficients f32 cannot cancel (NaN cepstra); 1e-4 is the value
        # validated on the JAX fast path
        r[..., 0] *= 1.0 + 1e-4
    return r


def window_envelopes(windows, cfg: FdlpConfig, k):
    """(P, flen) raw analysis windows -> (P, nb, kk) Hilbert envelopes of the
    I/O dtype: the lags, LPC cepstra (K1 on a CUDA float32 batch), the
    cepstral weights, exp(cepstra @ cos-DFT) with the exponent capped (all
    of the work type), and the envelope window. The batch path and
    dsp/streaming.py's streamer both run every analysis window through this
    one function. `k` is _device_constants(cfg, windows.dtype,
    windows.device)."""
    r = _window_lags(windows, cfg, k)
    kw = _device_constants(cfg, r.dtype, r.device)
    ceps = _lpc_cepstra(r, cfg.order, cfg.coeff_num, backend=cfg.lpc_backend)
    log_env = torch.einsum("pbc,ck->pbk", ceps * kw["weights"], kw["cosmat"])
    # a pole on a band harmonic can push the log-envelope past exp's range;
    # saturate so exp(.) summed over the OLA stays finite
    env_cap = 700.0 if r.dtype == torch.float64 else 75.0
    env = torch.exp(torch.clamp(log_env, max=env_cap)).to(windows.dtype)
    return env * k["env_win"]


def _frames(signals, num_samples, fp, dtype, dev):
    """Raw (unwindowed) analysis windows of a zero-padded batch:
    (frames (B * max_frames, flen), num_frames (B,), num_samples on `dev`).
    The move of the signals and their lengths to `dev` is the span
    `fdlp.h2d`, counting the bytes that arrive there."""
    with span("fdlp.h2d") as h2d:
        signals = torch.as_tensor(signals).to(device=dev, dtype=dtype)
        num_samples = torch.as_tensor(num_samples).to(device=dev, dtype=torch.int64)
        h2d.n = signals.nbytes + num_samples.nbytes
    max_frames = frame_count(signals.shape[1], fp)
    ones = torch.ones(fp.flength_samples, dtype=dtype, device=dev)
    frames, num_frames = frame_signal(signals, num_samples, fp, ones, max_frames)
    return frames.reshape(-1, fp.flength_samples), num_frames, num_samples


def fdlp_lags(signals, num_samples, cfg: FdlpConfig = FdlpConfig(), *,
              dtype: torch.dtype = torch.float32, device="cuda"):
    """The per-(utterance x frame x band) autocorrelation lags that the LPC
    stage of fdlp_spectrogram_batch solves (float64 at high precision),
    with the f32 ridge applied.

    Returns (lags (B * max_frames, nfilters, order + 2), num_frames (B,)).
    On CUDA it switches TF32 off process-wide (device.configure_cuda).
    """
    dev, c, k = _setup(cfg, dtype, device)
    frames, num_frames, _ = _frames(signals, num_samples, c["fp"], dtype, dev)
    return _window_lags(frames, cfg, k), num_frames


def window_lags(windows, cfg: FdlpConfig = FdlpConfig(), *,
                dtype: torch.dtype = torch.float32, device="cuda"):
    """The lags that window_envelopes solves for (P, flen) raw analysis
    windows (numpy or tensor), e.g. one block of dsp/streaming.py's
    streamer: (P, nfilters, order + 2)."""
    dev, _, k = _setup(cfg, dtype, device)
    return _window_lags(torch.as_tensor(windows).to(device=dev, dtype=dtype), cfg, k)


def fdlp_spectrogram_batch(
    signals,
    num_samples,
    cfg: FdlpConfig = FdlpConfig(),
    *,
    jitter=None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """FDLP spectrogram for a zero-padded batch of waveforms.

    Args:
      signals: (B, Nmax) waveforms (int16-scale floats; the reference does
        not normalise), numpy array or tensor.
      num_samples: (B,) true sample counts.
      cfg: configuration.
      jitter: optional (B, max_frames) integer array in {0, 1} enabling the
        reference's +-1-frame OLA jitter; None pins it to 0.
      dtype: I/O dtype (float32; float64 for CPU parity checks). At
        precision="high" the work type is float64 either way.
      device: "cuda" (default) or "cpu". On CUDA this switches TF32 off
        process-wide (device.configure_cuda).

    Returns:
      feats: (B, Tmax, nfilters) log FDLP spectrogram (rows past each
        utterance's length are garbage; mask with num_out_frames).
      num_out_frames: (B,) int64 true output frame counts.
    """
    dev, c, k = _setup(cfg, dtype, device)
    frames, num_frames, num_samples = _frames(signals, num_samples, c["fp"], dtype, dev)
    B = num_samples.shape[0]
    max_samples = signals.shape[1]
    max_frames = frames.shape[0] // B
    env = window_envelopes(frames, cfg, k).reshape(B, max_frames, -1, c["kk"])

    out_len = -torch.div(-num_samples * cfg.frate, cfg.srate, rounding_mode="floor")
    max_out = -(-max_samples * cfg.frate // cfg.srate)
    if jitter is None:
        pos, valid = ola_positions(max_frames, c["hop"], c["kk"], c["kkb2"], device=dev)
        feats = overlap_add(env, pos, valid, num_frames, out_len, max_out,
                            hop=c["hop"], kkb2=c["kkb2"])
    else:
        jitter = torch.as_tensor(jitter).to(device=dev, dtype=torch.int64)
        pos, valid = ola_positions(max_frames, c["hop"], c["kk"], c["kkb2"], jitter)
        feats = overlap_add(env, pos, valid, num_frames, out_len, max_out)
    feats = torch.clamp(feats, min=1e-14)
    feats = torch.log(feats.to(_work_dtype(cfg, dtype))).to(dtype)
    return feats.transpose(1, 2), out_len


# ------------------------------------------------------------ sequence parallel


def _ola_sharded(env, f0, num_frames, out_len, max_out, c, group, nt, jitter=None):
    """Overlap-add of this rank's frames [f0, f0 + Fl) of env (B, Fl, NB, kk)
    over a time axis of nt ranks (group): (B, NB, max_out) on every rank,
    zero past each utterance's length. Without jitter each rank adds its
    frames' hop-sized chunks into blocks [f0, f0 + Fl + n - 1), n =
    ceil(kk / hop), passes its last n - 1 blocks (the halo) to its right
    neighbour, which adds them to its first ones, and the owned blocks are
    all-gathered. With jitter the taps are scattered at their global
    positions and the partial outputs summed over the axis."""
    from speech_recognition_tools_tpu_torch.parallel import collectives

    B, Fl, NB, kk = env.shape
    hop, kkb2 = c["hop"], c["kkb2"]
    dev = env.device
    fidx = f0 + torch.arange(Fl, device=dev)
    ok = (fidx[None, :] < num_frames[:, None])[:, :, None] & (
        (fidx[:, None] > 0) | (torch.arange(kk, device=dev)[None, :] >= kkb2))[None]
    env = torch.where(ok[:, :, None, :], env, torch.zeros((), dtype=env.dtype, device=dev))
    tmask = torch.arange(max_out, device=dev)[None, :] < out_len[:, None]
    if jitter is not None:
        jit = torch.nn.functional.pad(jitter, (0, nt * Fl - jitter.shape[1]))
        pos, _ = ola_positions(nt * Fl, hop, kk, kkb2, jit)
        pos = pos[:, f0:f0 + Fl]
        keep = ok & (pos >= 0) & (pos < out_len[:, None, None])
        p = torch.where(keep, pos, max_out).reshape(B, 1, Fl * kk).expand(B, NB, Fl * kk)
        part = env.new_zeros((B, NB, max_out + 1))
        part.scatter_add_(2, p, env.permute(0, 2, 1, 3).reshape(B, NB, Fl * kk))
        return collectives.psum(part[..., :max_out], group) * tmask[:, None, :].to(env.dtype)
    n = -(-kk // hop)
    e = env.permute(0, 2, 1, 3)
    if n * hop - kk:
        e = torch.nn.functional.pad(e, (0, n * hop - kk))
    chunks = e.reshape(B, NB, Fl, n, hop)
    blocks = e.new_zeros((B, NB, Fl + n - 1, hop))
    for j in range(n):
        blocks[:, :, j:j + Fl] += chunks[:, :, :, j]
    i = f0 // Fl
    if n > 1:
        from_left, _ = collectives.halo_exchange(
            blocks.new_zeros((B, NB, n - 1, hop)), blocks[:, :, Fl:].contiguous(), group)
        blocks[:, :, :n - 1] += from_left
        if i < nt - 1:
            blocks[:, :, Fl:] = 0.0
    parts = collectives.all_gather_list(blocks, group)
    total = nt * Fl + n - 1
    out = e.new_zeros((B, NB, total, hop))
    for r, blk in enumerate(parts):
        out[:, :, r * Fl:r * Fl + Fl + n - 1] += blk
    out = out.reshape(B, NB, total * hop)
    if kkb2 + max_out > total * hop:
        out = torch.nn.functional.pad(out, (0, kkb2 + max_out - total * hop))
    return out[:, :, kkb2:kkb2 + max_out] * tmask[:, None, :].to(out.dtype)


def _sharded_rows(B: int, mesh, data_axis):
    """This data shard's rows of a B-row batch (padded to a multiple of the
    data axis by repeating the last row): (row index tensor, rows per
    shard)."""
    nd = mesh.size(data_axis) if data_axis else 1
    per = -(-B // nd)
    d = mesh.index(data_axis) if data_axis else 0
    return torch.arange(d * per, (d + 1) * per).clamp_max(B - 1), per


def _finish_sharded(feats_l, out_len, B, per, cfg, dtype, mesh, data_axis):
    """log of the stitched envelopes of this data shard, gathered over the
    data axis: ((B, T, nfilters), (B,))."""
    from speech_recognition_tools_tpu_torch.parallel import collectives

    feats_l = torch.clamp(feats_l, min=1e-14)
    feats_l = torch.log(feats_l.to(_work_dtype(cfg, dtype))).to(dtype).transpose(1, 2)
    if data_axis and mesh.size(data_axis) > 1:
        feats_l = torch.cat(collectives.all_gather_list(feats_l.contiguous(),
                                                        mesh.group(data_axis)), dim=0)
    return feats_l[:B], out_len


def fdlp_spectrogram_sharded(signals, num_samples, cfg: FdlpConfig, mesh, *,
                             time_axis: str = "time", data_axis: str | None = None,
                             jitter=None, dtype: torch.dtype = torch.float32, device="cuda"):
    """Sequence-parallel FDLP over a rank mesh (the JAX function's port).

    Every rank holds the whole batch (replicated input). The analysis
    frames are split over `time_axis`: rank i runs the DCT -> lags -> LPC
    cepstra (K1 on a CUDA float32 batch, on this rank's rows only) ->
    envelope chain for its contiguous block of ceil(F / nt) frames, and the
    overlap-add, which couples only ceil(kk / hop) - 1 neighbouring frames,
    is stitched by a halo exchange with the next rank. With `data_axis` the
    utterances are split over that axis too. Same contract as
    fdlp_spectrogram_batch; the output is on every rank."""
    dev, c, k = _setup(cfg, dtype, device)
    signals = torch.as_tensor(signals).to(device=dev, dtype=dtype)
    num_samples = torch.as_tensor(num_samples).to(device=dev, dtype=torch.int64)
    B, max_samples = signals.shape
    rows, per = _sharded_rows(B, mesh, data_axis)
    rows = rows.to(dev)
    sig, ns = signals[rows], num_samples[rows]
    fp = c["fp"]
    F = frame_count(max_samples, fp)
    nt = mesh.size(time_axis)
    Fl = -(-F // nt)
    f0 = mesh.index(time_axis) * Fl
    ones = torch.ones(fp.flength_samples, dtype=dtype, device=dev)
    frames, num_frames = frame_signal(sig, ns, fp, ones, Fl, first_frame=f0)
    env = window_envelopes(frames.reshape(-1, fp.flength_samples), cfg, k)
    env = env.reshape(per, Fl, -1, c["kk"])
    out_len = -torch.div(-num_samples * cfg.frate, cfg.srate, rounding_mode="floor")
    max_out = -(-max_samples * cfg.frate // cfg.srate)
    if jitter is not None:
        jitter = torch.as_tensor(jitter).to(device=dev, dtype=torch.int64)[rows]
    feats = _ola_sharded(env, f0, num_frames, out_len[rows], max_out, c,
                         mesh.group(time_axis), nt, jitter)
    return _finish_sharded(feats, out_len, B, per, cfg, dtype, mesh, data_axis)


def fdlp_spectrogram_input_sharded(block, num_samples, cfg: FdlpConfig, mesh, *,
                                   time_axis: str = "time", data_axis: str | None = None,
                                   dtype: torch.dtype = torch.float32, device="cuda"):
    """Sequence-parallel FDLP with the waveform itself sharded (the JAX
    function's port): `block` is this rank's (B_d, N / nt) block of samples
    -- its data shard's utterances (with `data_axis`; B_d = B / nd), the
    time axis splitting the samples -- and `num_samples` the (B,) lengths
    of the whole batch. Each rank exchanges at most flength samples with
    each neighbour (ops/framing.py::frame_signal_time_sharded), so no rank
    holds more than its block and two halos of the input; the rest is the
    frame-sharded chain. All utterances must be full length (num_samples ==
    N) and N must divide by the time-axis size."""
    from speech_recognition_tools_tpu_torch.ops.framing import frame_signal_time_sharded

    dev, c, k = _setup(cfg, dtype, device)
    block = torch.as_tensor(block).to(device=dev, dtype=dtype)
    ns = np.asarray(torch.as_tensor(num_samples).cpu())
    nt = mesh.size(time_axis)
    N = block.shape[1] * nt
    full = ("input-sharded featgen requires full-length utterances "
            "(num_samples == signals.shape[1]); use "
            "fdlp_spectrogram_sharded for ragged batches")
    if not (ns == ns.max()).all():
        raise ValueError(full)
    if ns.max() % nt:
        raise ValueError(f"N={int(ns.max())} not divisible by time-axis size {nt}")
    if ns.max() != N:
        raise ValueError(full)
    B = len(ns)
    per = block.shape[0]
    num_samples = torch.as_tensor(ns, dtype=torch.int64, device=dev)
    fp = c["fp"]
    F = frame_count(N, fp)
    frames = frame_signal_time_sharded(block, fp, F, mesh, time_axis)
    Fl = frames.shape[1]
    f0 = mesh.index(time_axis) * Fl
    env = window_envelopes(frames.reshape(-1, fp.flength_samples), cfg, k)
    env = env.reshape(per, Fl, -1, c["kk"])
    out_len = -torch.div(-num_samples * cfg.frate, cfg.srate, rounding_mode="floor")
    max_out = -(-N * cfg.frate // cfg.srate)
    num_frames = frame_count(num_samples[:per], fp)
    feats = _ola_sharded(env, f0, num_frames, out_len[:per], max_out, c,
                         mesh.group(time_axis), nt)
    return _finish_sharded(feats, out_len, B, per, cfg, dtype, mesh, data_axis)
