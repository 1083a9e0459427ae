"""Config-driven multichannel enhancement front-end: the corpus recipes'
stage 0 (recipes/run_corpus.py:470-513).

Port of speech_recognition_tools_tpu/enhance/pipeline.py, the native
analogue of the reference's enhancement chain (e2e/reverb/
run_fdlp_e1.sh:130-138: run_wpe.sh -> run_beamform.sh ->
compute_se_scores.sh; the GEV beamformer follows
recipes/chime4/local/nn-gev/beamform.py). Per utterance, on the device:
WPE (enhance/onchip.py::wpe_onchip over its STFT), then the beamformer's
STFT, its magnitudes for the mask net, the masks (quantile masks, or the
BLSTM mask net's), GEV or MVDR (+ BAN, + phase correction), and the iSTFT.
The JAX package jits this chain per utterance shape; here it is a plain
sequence of calls, its parts exposed (`maybe_wpe`, `beamform_stft`) so
that they can be timed one by one. One repair: the WPE stage runs in
float64 (`maybe_wpe`), where the JAX package's float32 one returns NaN at
the recipes' 10 taps.

Mask estimation: quantile masks by default; the BLSTM mask net when
`beamform.mask_model` is "blstm" and `maybe_mask_model` finds a trained
<exp>/mask_model, or trains one from the train set's parallel clean / noise
scps (clean_wav.scp + noise_wav.scp). Without either it falls back to
quantile masks with a log line, as the JAX package does: that is the
config's behaviour, not a device fallback.
"""

import os

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import resolve_device
from speech_recognition_tools_tpu_torch.io.wav import read_wav_scp_entry


def read_multichannel_scp(scp_path):
    """wav.scp where each value is one or more whitespace-separated wav
    entries (one per channel); a single entry pointing at a multichannel
    wav also works (its columns become the channels).

    Returns {utt: [entry, ...]} in file order."""
    out = {}
    with open(scp_path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            utt, rest = parts[0], parts[1] if len(parts) > 1 else ""
            out[utt] = [rest] if rest.endswith("|") else rest.split()  # a pipe is one entry
    return out


def load_channels(entries, srate=None, with_scale=False):
    """Load scp entries into a (channels, samples) float64 stack.

    with_scale=True also returns whether the source samples are float-scale
    IEEE audio ([-1, 1]), decided from the wav dtype and NOT from the
    amplitude, so that a near-silent int16 utterance is never taken for
    float audio (and then blown up to full scale). Shell pipes lose the
    container dtype in transit; they fall back to the amplitude rule
    (peak <= 1)."""
    from scipy.io.wavfile import read as wav_read

    sigs, float_kinds = [], []
    for e in entries:
        if e.endswith("|"):
            _, s = read_wav_scp_entry(e, expected_srate=srate, keep_channels=True)
            sigs.append(s.T if s.ndim > 1 else s[None])
            float_kinds.append(np.max(np.abs(s)) <= 1.0 + 1e-6)
            continue
        sr, s = wav_read(e)
        if srate is not None and sr != srate:
            raise ValueError(f"{e}: sample rate {sr} != {srate}")
        float_kinds.append(s.dtype.kind == "f")
        s = np.asarray(s, np.float64)
        sigs.append(s.T if s.ndim > 1 else s[None])
    n = min(s.shape[-1] for s in sigs)
    stack = np.concatenate([s[:, :n] for s in sigs], axis=0)
    if with_scale:
        return stack, all(float_kinds)
    return stack


def _bf_geometry(bf):
    return int(bf.get("size", 1024)), int(bf.get("shift", 256))


def maybe_wpe(x, enh_cfg):
    """(D, n) real tensor -> WPE-dereverberated (D, n) in x's dtype, or `x`
    itself when the config has no `wpe` section.

    The WPE runs in float64 / complex128 whatever x's precision, as the
    host reference enhance/wpe.py and nara_wpe do. The JAX package runs it
    in float32: at 10 taps (the recipes' setting; a 40 x 40 solve per bin
    at 4 channels, 80 x 80 at 8) its complex64 Cholesky fails from the
    second iteration on and every bin comes out NaN (ROADMAP Queue 3)."""
    from speech_recognition_tools_tpu_torch.enhance.onchip import wpe_onchip
    from speech_recognition_tools_tpu_torch.enhance.stft import istft, stft

    wpe = enh_cfg.get("wpe")
    if not wpe:
        return x
    n = x.shape[-1]
    size, shift = int(wpe.get("size", 512)), int(wpe.get("shift", 128))
    X = stft(x.double(), size=size, shift=shift)  # (D, T, F)
    Xf = wpe_onchip(X.permute(2, 0, 1), taps=int(wpe.get("taps", 10)),
                    delay=int(wpe.get("delay", 3)),
                    iterations=int(wpe.get("iterations", 5)))
    return istft(Xf.permute(1, 2, 0), size=size, shift=shift)[..., :n].to(x.dtype)


def beamform_stft(X, enh_cfg, sm=None, nm=None):
    """The beamformer on the (D, T, F) STFT of the (dereverberated)
    channels: external (T, F) speech / noise masks, or in-place quantile
    masks (median over channels) when sm is None. Returns the beamformed
    (F, T) STFT."""
    from speech_recognition_tools_tpu_torch.enhance.onchip import (
        gev_beamform_onchip,
        median,
        mvdr_beamform_onchip,
        quantile_mask_onchip,
    )

    bf = enh_cfg["beamform"]
    if sm is not None:
        spf, nzf = sm.T, nm.T  # (F, T)
    else:
        spf = median(quantile_mask_onchip(X).permute(2, 0, 1), 1)
        nzf = 1.0 - spf
    Xf = X.permute(2, 0, 1)  # (F, D, T)
    if bf.get("type", "gev") == "mvdr":
        return mvdr_beamform_onchip(Xf, spf, nzf)
    return gev_beamform_onchip(Xf, spf, nzf, ban=bool(bf.get("ban", True)),
                               phase_correct=bool(bf.get("phase_correct", True)))


def enhance_utterance(signals, enh_cfg, mask_fn=None, device=None, return_stft=False):
    """(channels, samples) -> (samples,) enhanced float32 numpy.

    mask_fn: optional callable, (C, T, F) magnitude tensor -> (speech
    (T, F), noise (T, F)) masks (e.g. a trained BLSTM through
    enhance.mask_model.estimate_masks); None selects quantile masks.
    return_stft=True returns the beamformed (F, T) STFT tensor before
    synthesis instead (its global phase is arbitrary)."""
    from speech_recognition_tools_tpu_torch.enhance.stft import istft, stft

    dev = resolve_device(device or "cuda")
    x = torch.as_tensor(np.asarray(signals, np.float32), device=dev)
    n = x.shape[-1]
    x = maybe_wpe(x, enh_cfg)
    bf = enh_cfg.get("beamform")
    if not bf:
        return x[0].cpu().numpy()
    size, shift = _bf_geometry(bf)
    X = stft(x, size=size, shift=shift)  # (D, T, F)
    sm = nm = None
    if mask_fn is not None:
        sm, nm = mask_fn(X.abs())
        sm = torch.as_tensor(sm, dtype=torch.float32, device=dev)
        nm = torch.as_tensor(nm, dtype=torch.float32, device=dev)
    Yf = beamform_stft(X, enh_cfg, sm, nm)
    if return_stft:
        return Yf
    return istft(Yf.T, size=size, shift=shift)[:n].cpu().numpy().astype(np.float32)


def maybe_mask_model(enh_cfg, exp_dir, train_dir=None, srate=16000, log=print,
                     device=None):
    """Resolve the configured mask model to a mask_fn (or None).

    beamform.mask_model == 'blstm': load <exp_dir>/mask_model if it exists
    (a checkpoint of either package); else train one from the train set's
    parallel clean / noise scps (clean_wav.scp + noise_wav.scp, the nn-gev
    simulated-data flow) and save it in the JAX package's layout; else fall
    back to quantile masks with a log line. The mask_fn returned carries
    its model as `mask_fn.model`."""
    bf = enh_cfg.get("beamform") or {}
    if bf.get("mask_model") != "blstm":
        return None
    from speech_recognition_tools_tpu_torch.enhance.mask_model import (
        BLSTMMaskEstimator,
        estimate_masks,
        train_mask_estimator,
    )
    from speech_recognition_tools_tpu_torch.enhance.stft import stft
    from speech_recognition_tools_tpu_torch.io.jax_params import (
        mask_model_from_jax,
        mask_model_to_jax,
    )
    from speech_recognition_tools_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    dev = resolve_device(device or "cuda")
    size, shift = _bf_geometry(bf)
    bins = size // 2 + 1
    hidden = int(bf.get("mask_hidden", 64))
    ckpt = os.path.join(exp_dir, "mask_model")

    if os.path.exists(os.path.join(ckpt, "state.msgpack")):
        model = BLSTMMaskEstimator(bins, hidden, device=dev)
        template = mask_model_to_jax(model, model.state_dict())
        payload, _ = load_checkpoint(ckpt, template={"params": template})
        model.load_state_dict(mask_model_from_jax(model, payload["params"]))
        log(f"mask model: loaded {ckpt}")
    else:
        clean_scp = train_dir and os.path.join(train_dir, "clean_wav.scp")
        noise_scp = train_dir and os.path.join(train_dir, "noise_wav.scp")
        if not (clean_scp and os.path.exists(clean_scp) and os.path.exists(noise_scp)):
            log("mask model 'blstm' configured but no trained model and no parallel "
                "clean_wav.scp/noise_wav.scp in the train set — falling back to "
                "quantile masks")
            return None
        cl, nz = read_multichannel_scp(clean_scp), read_multichannel_scp(noise_scp)
        examples = []
        for utt in cl:
            if utt not in nz:
                continue
            c = load_channels(cl[utt], srate)[0]
            n = load_channels(nz[utt], srate)[0]
            m = min(len(c), len(n))
            examples.append((stft(c[:m], size=size, shift=shift, device=dev),
                             stft(n[:m], size=size, shift=shift, device=dev)))
        if not examples:
            log("mask model: no overlapping clean/noise utts — falling back to quantile "
                "masks")
            return None
        model, sd, losses = train_mask_estimator(
            examples, bins, hidden=hidden, epochs=int(bf.get("mask_epochs", 8)),
            log_fn=log, device=dev)
        save_checkpoint(exp_dir, "mask_model", mask_model_to_jax(model, sd),
                        {"bins": bins, "hidden": hidden})
        log(f"mask model: trained on {len(examples)} pairs "
            f"(bce {losses[0]:.4f} -> {losses[-1]:.4f}) -> {ckpt}")
    model.eval()

    def mask_fn(mag_per_channel):
        return estimate_masks(model, mag_per_channel)

    mask_fn.model = model
    return mask_fn


def run_enhancement(scp_path, out_dir, enh_cfg, srate, mask_fn=None, log=print,
                    device=None):
    """Enhance every utterance of a multichannel wav.scp.

    Writes <out_dir>/<utt>.wav (16-bit) and <out_dir>/wav.scp and returns
    the new scp's path. Single-channel utterances pass through untouched
    (their entry copied into the scp), so that mixed corpora work."""
    from scipy.io.wavfile import write as wav_write

    os.makedirs(out_dir, exist_ok=True)
    scp = read_multichannel_scp(scp_path)
    lines = []
    for utt, entries in scp.items():
        sigs, float_scale = load_channels(entries, srate, with_scale=True)
        if sigs.shape[0] == 1:
            lines.append(f"{utt} {entries[0]}")
            continue
        y = enhance_utterance(sigs, enh_cfg, mask_fn=mask_fn, device=device)
        peak = np.max(np.abs(y)) + 1e-9
        if float_scale:
            # float-scale input ([-1, 1] IEEE wavs): the float -> int16
            # mapping, clip-guarded against beamformer gain, NOT normalised
            # to the output peak: a quiet utterance stays quiet
            scale = min(30000.0, 30000.0 / peak)
        else:
            scale = min(1.0, 30000.0 / peak)  # int-scale input: only attenuate
        path = os.path.join(out_dir, f"{utt}.wav")
        wav_write(path, srate, (y * scale).astype(np.int16))
        lines.append(f"{utt} {path}")
    out_scp = os.path.join(out_dir, "wav.scp")
    with open(out_scp, "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"enhanced {len(lines)} utts -> {out_scp}")
    return out_scp


def se_scores(enhanced_scp, clean_scp, metrics, srate, log=print):
    """Per-set speech-enhancement scores against the clean references (the
    compute_se_scores.sh analogue). Returns {metric: mean, or None when no
    utterance scored}. A metric that raises on an utterance is logged and
    skipped, as in the JAX package."""
    from speech_recognition_tools_tpu_torch.eval.enhancement_metrics import (
        cepsdist,
        fwsegsnr,
        lpcllr,
        sdr,
        stoi,
    )
    from speech_recognition_tools_tpu_torch.eval.srmr import srmr
    from speech_recognition_tools_tpu_torch.io.native import pesq

    enh = read_multichannel_scp(enhanced_scp)
    clean = read_multichannel_scp(clean_scp)
    acc = {m: [] for m in metrics}
    for utt, entries in enh.items():
        if utt not in clean:
            continue
        deg = load_channels(entries, srate)[0]
        ref = load_channels(clean[utt], srate)[0]
        n = min(len(ref), len(deg))
        ref, deg = ref[:n], deg[:n]
        for m in metrics:
            try:
                if m == "pesq":
                    v = pesq(ref, deg, srate)
                elif m == "stoi":
                    v = stoi(ref, deg, srate)
                elif m == "estoi":
                    v = stoi(ref, deg, srate, extended=True)
                elif m == "srmr":
                    v = srmr(deg, srate)
                elif m == "fwsegsnr":
                    v = fwsegsnr(deg, ref, srate)[0]
                elif m == "cepsdist":
                    v = cepsdist(deg, ref, srate)[0]
                elif m == "lpcllr":
                    v = lpcllr(deg, ref, srate)[0]
                elif m == "sdr":
                    v = sdr(ref, deg)
                else:
                    continue
            except Exception as e:  # noqa: BLE001 - the JAX package's per-metric rule
                log(f"se_scores: {m}({utt}) failed: {e}")
                continue
            acc[m].append(float(v))
    return {m: (float(np.mean(v)) if v else None) for m, v in acc.items()}
