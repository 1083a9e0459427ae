"""Frame-context splicing.

Port of speech_recognition_tools_tpu/utils/splice.py (reference:
featgen/features.py:157-169 spliceFeats). Each frame is concatenated with
`context` frames on either side, zero-padded at the ends. The reference's
loop stops at frame_num - context, so the last `context` output rows stay
zero; that quirk is kept.
"""

import torch


def splice_feats(feats: torch.Tensor, context: int, num_frames=None) -> torch.Tensor:
    """Splice (..., T, D) -> (..., T, D * (2 * context + 1)); the last
    `context` rows of each utterance are zero.

    With `num_frames` ((B,) for a (B, T, D) batch) each utterance ends at
    its own length, as the reference splices one utterance at a time:
    frames past it count as zero padding and its own last `context` rows
    are zero. Without it every utterance is T frames long.
    """
    context = int(context)
    T, D = feats.shape[-2:]
    t = torch.arange(T, device=feats.device)
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    if num_frames is None:
        end = torch.full((1,), T, device=feats.device)
    else:
        end = torch.as_tensor(num_frames).to(feats.device)[:, None]
        feats = torch.where((t < end)[..., None], feats, zero)
    padded = torch.nn.functional.pad(feats, (0, 0, context, context))
    idx = t[:, None] + torch.arange(2 * context + 1, device=feats.device)[None, :]
    out = padded[..., idx, :].reshape(*feats.shape[:-2], T, D * (2 * context + 1))
    return torch.where((t < end - context)[..., None], out, zero)
