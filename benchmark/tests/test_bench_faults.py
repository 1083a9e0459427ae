"""Each cell's check sees `correct` come out false when the timed path is
broken underneath it (the look for a card skipped): a token or an answer
altered where it is produced, or an impossible hypothesis scored as a
possible one; for training, a step that returns its state
unchanged and half of each batch left out with the mean taken over the
rest. (No cell runs across chips, so no exchange can be left out.)"""

import pytest
import torch

from benchmark.harness import load_module
from conftest import run_tiny

IMPOSSIBLE = load_module("traffic", "decode").IMPOSSIBLE


def _alter_search_token(ctx):
    from speech_recognition_tools_tpu_torch.decode import beam_jit

    real = beam_jit.beam_search_batched

    def altered(*a, **kw):
        toks, scores = real(*a, **kw)
        toks = toks.clone()
        toks[0, 0, 1] = (toks[0, 0, 1] + 1) % (ctx.config["am"]["vocab_size"] - 1)
        return toks, scores

    ctx.facts["undo"] = lambda: setattr(beam_jit, "beam_search_batched", real)
    beam_jit.beam_search_batched = altered


def _outgrow_frames(ctx):
    """Utterances of one encoder frame searched for up to 20 tokens: every
    prefix of two labels or more is impossible."""
    ctx.params.update(seconds_lo=0.07, seconds_hi=0.09, max_len=20)


def _revive_impossible_prefixes(ctx):
    """The CTC prefix scorer reads a prefix that the frames cannot hold as
    a certain one (log 1) instead of an impossible one."""
    from speech_recognition_tools_tpu_torch.decode import beam_jit

    _outgrow_frames(ctx)
    real = beam_jit.ctc_prefix_scores

    def revived(*a, **kw):
        psi, full, r_new = real(*a, **kw)
        return psi.masked_fill(psi <= IMPOSSIBLE, 0.0), full, r_new

    ctx.facts["undo"] = lambda: setattr(beam_jit, "ctc_prefix_scores", real)
    beam_jit.ctc_prefix_scores = revived


def _alter_features(ctx):
    from speech_recognition_tools_tpu_torch.dsp import fdlp

    real = fdlp.fdlp_spectrogram_batch

    def altered(*a, **kw):
        feats, n = real(*a, **kw)
        return feats + 0.5 * (torch.arange(feats.shape[1]) % 7 == 3)[None, :, None], n

    ctx.facts["undo"] = lambda: setattr(fdlp, "fdlp_spectrogram_batch", real)
    fdlp.fdlp_spectrogram_batch = altered


def _alter_served_token(ctx):
    from speech_recognition_tools_tpu_torch.infer.streaming_asr import StreamBatcher

    real = StreamBatcher.finish

    def altered(self, sid):
        hyp = real(self, sid)
        st = self.state(sid)
        if st.hyp:
            st.hyp[0] = 1 + st.hyp[0] % (self.cfg.vocab_size - 2)
        return list(st.hyp) if st.hyp else hyp

    ctx.facts["undo"] = lambda: setattr(StreamBatcher, "finish", real)
    StreamBatcher.finish = altered


def _unchanged_state(ctx):
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    real = ClipAdam.apply

    def frozen(self, params, grads, state):
        saved = {k: v.detach().clone() for k, v in params.items()}
        out = real(self, params, grads, state)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(saved[k])
        return out

    ctx.facts["undo"] = lambda: setattr(ClipAdam, "apply", real)
    ClipAdam.apply = frozen


def _half_batch(ctx):
    from speech_recognition_tools_tpu_torch.train import trainer

    real = trainer.Trainer.train_step

    def half(self, state, batch):
        n = max(1, batch["feats"].shape[0] // 2)
        return real(self, state, {k: v[:n] for k, v in batch.items()})

    ctx.facts["undo"] = lambda: setattr(trainer.Trainer, "train_step", real)
    trainer.Trainer.train_step = half


FAULTS = [
    ("wsj_fdlp_e2e.decode", _alter_search_token, {"score_rel", "unscored"}),
    ("wsj_fdlp_e2e.decode", _revive_impossible_prefixes, {"revived"}),
    ("wsj_fdlp_e2e.featgen", _alter_features, {"feat_max", "feat_p999"}),
    ("wsj_fdlp_e2e.stream", _alter_served_token, {"token_gap", "conf_abs", "partial_bad"}),
    ("timit_hybrid.train", _unchanged_state, {"change_leaf"}),
    ("timit_hybrid.train", _half_batch, {"loss_rel", "grad_leaf", "change_leaf"}),
]


@pytest.mark.parametrize("cell,fault,caught", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_fault_is_caught(tiny_root, cell, fault, caught):
    box = {}

    def prepare(ctx):
        box["ctx"] = ctx
        fault(ctx)

    try:
        result, _ = run_tiny(tiny_root, cell, prepare=prepare)
    finally:
        box["ctx"].facts["undo"]()
    failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert not result["correct"] and failed & caught, result["checks"]


def test_sound_search_scores_no_impossible_prefix(tiny_root):
    """Unbroken, the search of the fault above returns no hypothesis that
    the reference calls impossible, nor the reverse."""
    result, ctx = run_tiny(tiny_root, "wsj_fdlp_e2e.decode", prepare=_outgrow_frames)
    readings = ctx.facts["readings"]
    assert result["correct"], result["checks"]
    assert readings["revived"] == readings["unscored"] == 0
