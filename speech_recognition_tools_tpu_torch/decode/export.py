"""Log-likelihood export for external FST decoders.

Port of speech_recognition_tools_tpu/decode/export.py (parity with
decode_dnn.sh stage 0, :104-116): dump per-utterance
log p(c|x) - prior_weight * log p(c) matrices to a Kaldi ark/scp pair that
`latgen-faster-mapped`, or the native decoder (decode/wfst.py), consumes.
"""

import torch

from speech_recognition_tools_tpu_torch.infer.posteriors import genclassifier_outputs
from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp


@torch.no_grad()
def export_loglikes_ark(apply_fn, batches, out_base: str, log_prior=None,
                        prior_weight: float = 0.8):
    """Run the AM over batches and write loglikes to out_base.ark/.scp.

    batches: iterator of dict(feats, lengths, keys); apply_fn: (feats,
    lengths) -> logits (B, T, C), a tensor on any device.
    Returns (ark path, scp path).
    """
    feats_out = {}
    for batch in batches:
        logits = apply_fn(batch["feats"], batch["lengths"])
        ll = genclassifier_outputs(logits, log_prior, prior_weight).cpu().numpy()
        for i, key in enumerate(batch["keys"]):
            feats_out[key] = ll[i, : int(batch["lengths"][i])]
    return write_ark_scp(feats_out, out_base)
