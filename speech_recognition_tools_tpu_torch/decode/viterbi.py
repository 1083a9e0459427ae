"""Batched greedy and Viterbi decoding on the device.

Port of speech_recognition_tools_tpu/decode/viterbi.py. The JAX Viterbi is
a lax.scan over frames with a reverse lax.scan for the backtrack; here
both are loops over frames of batched torch ops on the input's device
(the back-pointers stay on it until the end). Max-product runs over a
dense (S, S) log-transition matrix — phone-loop / HMM-topology decoding;
WFST decoding is decode/wfst.py. Ties go to the lowest state index, as
jnp.argmax breaks them.
"""

import math

import numpy as np
import torch


def greedy_decode(loglikes, lengths=None):
    """Frame-wise argmax. loglikes (B, T, S) -> (B, T) int32, -1 past each
    utterance's length."""
    ids = torch.argmax(loglikes, dim=-1).to(torch.int32)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=ids.device)
        mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
        ids = torch.where(mask, ids, torch.full_like(ids, -1))
    return ids


def collapse_repeats(ids):
    """Host-side: collapse consecutive repeats, drop -1 padding."""
    out = []
    prev = None
    for i in np.asarray(torch.as_tensor(ids).cpu()):
        if i < 0:
            break
        if i != prev:
            out.append(int(i))
        prev = i
    return out


@torch.no_grad()
def viterbi_decode(loglikes, log_trans, log_init=None, lengths=None):
    """Batched Viterbi over a dense transition matrix.

    loglikes (B, T, S) emission log-likelihoods; log_trans (S, S) with
    log_trans[i, j] = log p(s_t = j | s_{t-1} = i); log_init (S,) initial
    log-probs (default uniform); lengths (B,) valid frame counts (default
    T). Past an utterance's length its scores stay frozen and its
    back-pointers are the identity, so its best final state is the one at
    length - 1, as in the JAX scan.

    Returns (path (B, T) int32, -1 past each length; score (B,)).
    """
    B, T, S = loglikes.shape
    dev = loglikes.device
    log_trans = torch.as_tensor(log_trans, dtype=loglikes.dtype, device=dev)
    if log_init is None:
        log_init = torch.full((S,), -math.log(S), dtype=loglikes.dtype, device=dev)
    log_init = torch.as_tensor(log_init, dtype=loglikes.dtype, device=dev)
    if lengths is None:
        lengths = torch.full((B,), T, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    ident = torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(B, S)

    delta = log_init[None, :] + loglikes[:, 0]
    backs = []
    for t in range(1, T):
        cand = delta[:, :, None] + log_trans[None, :, :]  # (B, S_prev, S)
        best, back = cand.max(dim=1)
        new = best + loglikes[:, t]
        keep = (t < lengths)[:, None]
        delta = torch.where(keep, new, delta)
        backs.append(torch.where(keep, back.to(torch.int32), ident))
    score, last = delta.max(dim=-1)
    states = [last.to(torch.int32)]
    for back in reversed(backs):
        states.append(back.gather(1, states[-1][:, None].long())[:, 0])
    path = torch.stack(states[::-1], dim=1)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    return torch.where(mask, path, torch.full_like(path, -1)), score
