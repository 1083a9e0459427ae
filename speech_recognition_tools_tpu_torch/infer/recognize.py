"""The e2e recognition slice as one call: waveforms -> texts.

What speech_recognition_tools_tpu/cli/recog_e2e.py does with --jit_decode
after feature generation (recog_e2e.py:313-328), with featgen in front:
FDLP (kernel K1 on a card) -> global CMVN -> TransformerASR.encode ->
batched joint CTC/attention beam search (optional RNNLM fusion) -> the
best token list of each utterance -> text.
"""

import torch

from speech_recognition_tools_tpu_torch.decode.beam_jit import (
    beam_search_batched,
    tokens_to_list,
)
from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_spectrogram_batch
from speech_recognition_tools_tpu_torch.io.text import decode_tokens
from speech_recognition_tools_tpu_torch.utils.cmvn import apply_cmvn


def recognize_batch(signals, lengths, fdlp_cfg: FdlpConfig, cmvn_mean, cmvn_std,
                    model, vocab, *, lm=None, beam_size=10, max_len=100,
                    ctc_weight=0.3, penalty=0.0, lm_weight=1.0, norm_var=True,
                    device="cuda"):
    """Transcribe a zero-padded batch of waveforms.

    signals (B, Nmax), lengths (B,) sample counts; cmvn_mean / cmvn_std
    (D,) global statistics; model a TransformerASR and lm an RNNLM (or
    None), both on `device`; vocab the char vocabulary (token -> id).
    `device` defaults to "cuda" and raises without a card. Returns one
    string per utterance.
    """
    feats, num_frames = fdlp_spectrogram_batch(signals, lengths, fdlp_cfg, device=device)
    mean = torch.as_tensor(cmvn_mean, dtype=feats.dtype, device=feats.device)
    std = torch.as_tensor(cmvn_std, dtype=feats.dtype, device=feats.device)
    feats = apply_cmvn(feats, mean, std, norm_var)
    tokens, scores = beam_search_batched(
        model, feats, num_frames, beam_size=beam_size, max_len=max_len,
        ctc_weight=ctc_weight, penalty=penalty, lm=lm, lm_weight=lm_weight,
        device=device)
    eos = model.cfg.eos_id
    return [decode_tokens(tokens_to_list(tokens[b], scores[b], eos), vocab)
            for b in range(tokens.shape[0])]
