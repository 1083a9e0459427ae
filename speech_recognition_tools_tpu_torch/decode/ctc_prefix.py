"""CTC prefix scoring for joint CTC/attention beam search.

Port of speech_recognition_tools_tpu/decode/ctc_prefix.py (_logaddexp,
ctc_prefix_scores, init_prefix_state), batched over utterances: the JAX
functions score the K beams of one utterance and beam_jit vmaps them over
the batch; here every tensor carries a leading utterance axis B and each
utterance its own valid frame count enc_len[b].

The prefix score (Watanabe et al. 2017, as in ESPnet's asr_recog) of
extending prefix g by token c is maintained with per-frame blank and
non-blank forward variables. The forward scan over frames is a loop over
time, batched over (B, K, V) and kept in the JAX package's order.

NEG_INF (-1e30) stands for log 0, and `_logaddexp` keeps the JAX
package's handling of it (a sum of two NEG_INF terms stays exactly
NEG_INF); torch.logaddexp is a different function there.
"""

import torch

NEG_INF = -1e30


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    dead = m <= NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    s = m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(dead, NEG_INF, s)


def _last_frame(enc_len: torch.Tensor, T: int) -> torch.Tensor:
    return (enc_len - 1).clamp(0, T - 1)


def ctc_prefix_scores(logp, enc_len, prefix_lens, last_tokens, r_prev, blank_id=0):
    """Score all single-token extensions of K prefixes of B utterances.

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


def init_prefix_state(logp, enc_len, beam_size, blank_id=0):
    """Forward variables (B, K, T, 2) of the empty prefix, replicated over
    the K beams (an expanded view)."""
    B, T, _ = logp.shape
    valid = torch.arange(T, device=logp.device)[None, :] < enc_len[:, None]
    b = torch.cumsum(logp[..., blank_id] * valid.to(logp.dtype), dim=1)
    b = torch.where(valid, b, b.gather(1, _last_frame(enc_len, T)[:, None]))
    r = torch.stack([torch.full_like(b, NEG_INF), b], dim=-1)  # (B, T, 2)
    return r[:, None].expand(B, beam_size, T, 2)
