"""Windowed overlap-add of per-frame pole-model envelopes.

Port of speech_recognition_tools_tpu/ops/ola.py. The OLA pointer logic is
the reference FDLP script's (computeFDLPSpectrogram.py:203-225):

  * frame 0 contributes the second half of its envelope, ms[kkb2:], at
    output position 0;
  * frame i >= 1 contributes its full kk-sample envelope at
    ptr_i = (hop - kkb2) + (i-1)*hop + cumulative jitter, where the
    reference adds randrange(2) per step;
  * contributions outside [0, T_b) are dropped.

Without jitter every frame sits at i*hop - kkb2, so the OLA is
ceil(kk/hop) shifted adds of hop-sized chunks. With jitter the positions
are data-dependent and the taps are scatter-added. The jitter is an
explicit integer array: the JAX package draws it with jax.random, whose
bits PyTorch cannot reproduce.
"""

import torch


def ola_positions(max_frames: int, hop: int, kk: int, kkb2: int,
                  jitter: torch.Tensor | None = None, device=None):
    """Output position of envelope tap k of frame i.

    Args:
      max_frames: frame bound F.
      hop, kk, kkb2: OLA hop, envelope length and half length.
      jitter: optional (..., F) integer per-step jitter in {0, 1} (added
        when advancing from frame u to u+1, u >= 1). None means 0.

    Returns:
      pos: (..., F, kk) int64 output index of each tap.
      valid: (F, kk) bool, False for the frame-0 taps k < kkb2.
    """
    if jitter is not None:
        device = jitter.device
    i = torch.arange(max_frames, device=device)
    k = torch.arange(kk, device=device)[None, :]
    if jitter is None:
        cum = torch.zeros(max_frames, dtype=torch.int64, device=device)
    else:
        j = torch.where(i >= 1, jitter.to(torch.int64), 0)
        cum = torch.cumsum(j, dim=-1) - j  # exclusive cumsum
    offset = torch.where(i == 0, -kkb2, (hop - kkb2) + (i - 1) * hop + cum)
    pos = offset[..., None] + k
    valid = torch.where(i[:, None] == 0, k >= kkb2, torch.ones_like(k, dtype=torch.bool))
    return pos, valid


def overlap_add(env, pos, valid, num_frames, out_len_valid, max_out_len: int,
                *, hop: int | None = None, kkb2: int | None = None):
    """Place envelopes at their OLA positions and sum.

    Args:
      env: (B, F, NB, kk) envelopes.
      pos: (F, kk) or (B, F, kk) tap positions (unused when hop is given).
      valid: (F, kk) tap validity.
      num_frames: (B,) valid frames per utterance.
      out_len_valid: (B,) true output length T_b.
      max_out_len: output bound T.
      hop, kkb2: when given, positions are the uniform stride
        i*hop + k - kkb2 and the shifted-add path runs; otherwise the taps
        are scatter-added at `pos`.

    Returns: (B, NB, T) accumulated envelopes, zero beyond T_b.
    """
    B, F, NB, kk = env.shape
    dev = env.device
    frame_ok = torch.arange(F, device=dev)[None, :] < num_frames[:, None]  # (B, F)
    mask = valid[None] & frame_ok[:, :, None]  # (B, F, kk)
    env = torch.where(mask[:, :, None, :], env, torch.zeros((), dtype=env.dtype, device=dev))
    tmask = torch.arange(max_out_len, device=dev)[None, :] < out_len_valid[:, None]
    if hop is not None:
        out = _overlap_add_strided(env, max_out_len, hop, kkb2)
        return out * tmask[:, None, :].to(out.dtype)
    if pos.ndim == 2:
        pos = pos.expand(B, F, kk)
    keep = mask & (pos >= 0) & (pos < out_len_valid[:, None, None])
    # taps that are dropped go to a spill column past the end
    p = torch.where(keep, pos, max_out_len).reshape(B, 1, F * kk).expand(B, NB, F * kk)
    vals = env.permute(0, 2, 1, 3).reshape(B, NB, F * kk)
    out = torch.zeros((B, NB, max_out_len + 1), dtype=env.dtype, device=dev)
    out.scatter_add_(2, p, vals)
    return out[..., :max_out_len]


def _overlap_add_strided(env, max_out_len, hop, kkb2):
    """Chunk j of frame i (taps [j*hop, (j+1)*hop)) lands at shifted block
    i + j; the shifted output is then sliced at kkb2, which drops the
    t < 0 taps."""
    B, F, NB, kk = env.shape
    nchunks = -(-kk // hop)
    env = env.permute(0, 2, 1, 3)  # (B, NB, F, kk)
    pad = nchunks * hop - kk
    if pad:
        env = torch.nn.functional.pad(env, (0, pad))
    chunks = env.reshape(B, NB, F, nchunks, hop)
    out = env.new_zeros((B, NB, F + nchunks - 1, hop))
    for j in range(nchunks):
        out[:, :, j : j + F] += chunks[:, :, :, j]
    total = (F + nchunks - 1) * hop
    out = out.reshape(B, NB, total)
    if kkb2 + max_out_len > total:
        out = torch.nn.functional.pad(out, (0, kkb2 + max_out_len - total))
    return out[:, :, kkb2 : kkb2 + max_out_len]
