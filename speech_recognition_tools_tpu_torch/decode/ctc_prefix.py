"""CTC prefix scoring for joint CTC/attention beam search.

Port of speech_recognition_tools_tpu/decode/ctc_prefix.py (_logaddexp,
ctc_prefix_scores, init_prefix_state), batched over utterances: the JAX
functions score the K beams of one utterance and beam_jit vmaps them over
the batch; here every tensor carries a leading utterance axis B and each
utterance its own valid frame count enc_len[b].

The prefix score (Watanabe et al. 2017, as in ESPnet's asr_recog) of
extending prefix g by token c is maintained with per-frame blank and
non-blank forward variables, scanned over the frames.

NEG_INF (-1e30) stands for log 0, and `_logaddexp` keeps the JAX
package's handling of it (a sum of two NEG_INF terms stays exactly
NEG_INF); torch.logaddexp is a different function there.

`ctc_prefix_scores` launches kernel K2 (csrc/ctc_prefix.cu, built for
sm_90a at first use by kernels.py) for CUDA float32 input: the whole
frame scan in one launch, one thread per (b, k, c) chain. For CPU input
it runs the plain version, `ctc_prefix_scores_reference`: the scan as a
Python loop over frames, batched over (B, K, V) and kept in the JAX
package's order. It never falls back from the kernel to the plain
version: CUDA input the kernel does not take raises.
"""

import threading

import torch

from speech_recognition_tools_tpu_torch import kernels

NEG_INF = -1e30
_count_lock = threading.Lock()  # serving threads search concurrently


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    dead = m <= NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    s = m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(dead, NEG_INF, s)


def _last_frame(enc_len: torch.Tensor, T: int) -> torch.Tensor:
    return (enc_len - 1).clamp(0, T - 1)


def ctc_prefix_scores_reference(logp, enc_len, prefix_lens, last_tokens, r_prev,
                                blank_id=0):
    """Score all single-token extensions of K prefixes of B utterances:
    the plain version of kernel K2, on any device.

    Args:
      logp: (B, T, V) CTC log-posteriors.
      enc_len: (B,) valid frame counts.
      prefix_lens: (B, K) prefix lengths (0 for the empty prefix).
      last_tokens: (B, K) last token of each prefix (-1 if empty).
      r_prev: (B, K, T, 2) forward variables of each prefix: [..., 0] =
        log p(prefix, ending in non-blank at t), [..., 1] = ending in blank.
      blank_id: CTC blank index.

    Returns:
      psi: (B, K, V) prefix scores (the output begins with g.c);
      full: (B, K, V) full-sequence scores (all valid frames give g.c);
      r_new: (B, K, V, T, 2) forward variables of each extension (a view;
        index the chosen (beam, token) to carry it into the next step).
    """
    B, T, V = logp.shape
    dev = logp.device
    r_nb_prev, r_b_prev = r_prev[..., 0], r_prev[..., 1]  # (B, K, T)
    phi_all = _logaddexp(r_nb_prev, r_b_prev)
    # for c == the prefix's last token only the blank-ending path extends
    same = torch.arange(V, device=dev) == last_tokens[..., None]  # (B, K, V)
    # phi at t-1, with a virtual frame -1 where phi = 0 for the empty prefix
    start = torch.where(prefix_lens == 0, 0.0, NEG_INF).to(logp.dtype)[..., None]
    phi_prev = torch.cat([start, phi_all[..., :-1]], dim=-1)  # (B, K, T)
    phi_b_prev = torch.cat([start, r_b_prev[..., :-1]], dim=-1)
    phi_pick = torch.where(same[None], phi_b_prev.permute(2, 0, 1)[..., None],
                           phi_prev.permute(2, 0, 1)[..., None])  # (T, B, K, V)
    valid = torch.arange(T, device=dev)[:, None] < enc_len[None, :]  # (T, B)
    lp = logp.transpose(0, 1)  # (T, B, V)
    # per frame, [non-blank, blank] increments: log p_t(c) and log p_t(blank)
    lp2 = torch.stack([lp, lp[..., blank_id:blank_id + 1].expand_as(lp)], 1)[:, :, :, None]
    keep = valid[:, None, :, None, None]  # (T, 1, B, 1, 1)

    # r[0] = non-blank, r[1] = blank forward variables of every extension
    r = torch.full((2, B, last_tokens.shape[1], V), NEG_INF, dtype=logp.dtype, device=dev)
    seq = []
    for t in range(T):
        new = _logaddexp(r[0:1], torch.stack([phi_pick[t], r[1]])) + lp2[t]
        r = torch.where(keep[t], new, r)
        seq.append(r)
    seq = torch.stack(seq)  # (T, 2, B, K, V)
    r_new = seq.permute(2, 3, 4, 0, 1)  # (B, K, V, T, 2)
    last = r_new[torch.arange(B, device=dev), :, :, _last_frame(enc_len, T)]  # (B, K, V, 2)
    full = _logaddexp(last[..., 0], last[..., 1])
    contrib = (phi_pick + lp[:, :, None, :]).masked_fill(~valid[:, :, None, None], NEG_INF)
    psi = torch.logsumexp(contrib, dim=0)
    return psi, full, r_new


def ctc_prefix_scores(logp, enc_len, prefix_lens, last_tokens, r_prev, blank_id=0):
    """ctc_prefix_scores_reference's function (same arguments, same
    returns): kernel K2 in one launch on the current stream for CUDA
    float32 `logp`, the plain version for CPU input.

    The kernel takes logp (B, T, V) contiguous, enc_len (B,) and
    prefix_lens, last_tokens (B, K) contiguous int64, and r_prev (B, K,
    T, 2) float32 whose (T, 2) rows are contiguous (an expanded beam axis,
    as init_prefix_state returns, is fine), all on logp's card. An int32
    enc_len (encode_ring passes the egs' int32 lengths through) is widened
    to int64 first, as the plain version takes any integer lengths.
    Anything else raises.
    """
    if logp.device.type == "cpu":
        return ctc_prefix_scores_reference(logp, enc_len, prefix_lens, last_tokens, r_prev,
                                           blank_id)
    if logp.device.type != "cuda":
        raise ValueError(f"ctc_prefix_scores runs on cuda or cpu tensors, not {logp.device}")
    if logp.dtype != torch.float32 or r_prev.dtype != torch.float32:
        raise TypeError(f"the ctc_prefix kernel takes float32 logp and r_prev, not "
                        f"{logp.dtype} and {r_prev.dtype}")
    if logp.ndim != 3 or min(logp.shape[1:]) < 1:
        raise ValueError(f"expected (B, T >= 1, V >= 1) logp, got {tuple(logp.shape)}")
    B, T, V = logp.shape
    K = last_tokens.shape[-1] if last_tokens.ndim == 2 else -1
    if enc_len.dtype == torch.int32:
        enc_len = enc_len.long()
    for name, x, shape in (("enc_len", enc_len, (B,)), ("prefix_lens", prefix_lens, (B, K)),
                           ("last_tokens", last_tokens, (B, K))):
        if tuple(x.shape) != shape or x.dtype != torch.int64:
            raise ValueError(f"the ctc_prefix kernel takes {name} as int64 {shape}, not "
                             f"{x.dtype} {tuple(x.shape)}")
    if tuple(r_prev.shape) != (B, K, T, 2):
        raise ValueError(f"expected r_prev of shape {(B, K, T, 2)}, got {tuple(r_prev.shape)}")
    for name, x in (("logp", logp), ("enc_len", enc_len), ("prefix_lens", prefix_lens),
                    ("last_tokens", last_tokens), ("r_prev", r_prev)):
        if x.device != logp.device:
            raise ValueError(f"{name} is on {x.device}, logp on {logp.device}")
        if x is not r_prev and not x.is_contiguous():
            raise ValueError(f"the ctc_prefix kernel needs a contiguous {name} "
                             f"(strides {x.stride()})")
    if r_prev.stride(3) != 1 or (T > 1 and r_prev.stride(2) != 2):
        raise ValueError("the ctc_prefix kernel needs r_prev's (T, 2) rows contiguous "
                         f"(strides {r_prev.stride()})")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} is not a token of {V}")
    psi = torch.empty((B, K, V), dtype=torch.float32, device=logp.device)
    full = torch.empty_like(psi)
    seq = torch.empty((T, 2, B, K, V), dtype=torch.float32, device=logp.device)
    r_new = seq.permute(2, 3, 4, 0, 1)  # (B, K, V, T, 2), as the plain version returns it
    if psi.numel() == 0:
        return psi, full, r_new
    lib = kernels.load("ctc_prefix")
    stream = torch.cuda.current_stream(logp.device).cuda_stream
    rc = lib.ctc_prefix_f32(
        logp.data_ptr(), enc_len.data_ptr(), prefix_lens.data_ptr(), last_tokens.data_ptr(),
        r_prev.data_ptr(), r_prev.stride(0), r_prev.stride(1), B, K, V, T, blank_id,
        psi.data_ptr(), full.data_ptr(), seq.data_ptr(), stream)
    if rc != 0:
        msg = lib.ctc_prefix_error_string(rc).decode()
        raise RuntimeError(f"ctc_prefix kernel launch failed: {msg} ({rc}) at (B, K, V, T) "
                           f"{(B, K, V, T)}")
    with _count_lock:
        ctc_prefix_scores.launches += 1
    return psi, full, r_new


ctc_prefix_scores.launches = 0


def count_launches(n: int) -> None:
    """Add `n` to ctc_prefix_scores.launches: a CUDA graph's replay launches
    the kernel its capture recorded (and counted) without calling the
    wrapper, so the caller counts each replay here and takes back the
    capture's count, which launched nothing."""
    with _count_lock:
        ctc_prefix_scores.launches += n


def init_prefix_state(logp, enc_len, beam_size, blank_id=0):
    """Forward variables (B, K, T, 2) of the empty prefix, replicated over
    the K beams (an expanded view)."""
    B, T, _ = logp.shape
    valid = torch.arange(T, device=logp.device)[None, :] < enc_len[:, None]
    b = torch.cumsum(logp[..., blank_id] * valid.to(logp.dtype), dim=1)
    b = torch.where(valid, b, b.gather(1, _last_frame(enc_len, T)[:, None]))
    r = torch.stack([torch.full_like(b, NEG_INF), b], dim=-1)  # (B, T, 2)
    return r[:, None].expand(B, beam_size, T, 2)
