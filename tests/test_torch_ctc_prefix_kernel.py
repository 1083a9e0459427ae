"""Kernel K2 (csrc/ctc_prefix.cu) behind decode/ctc_prefix.py::ctc_prefix_scores.

On the CPU: CPU input takes the plain version and launches nothing, and
kernels.py keeps K2 in a library of its own whose source does not enter
K1's library path. On the card (skipped without one): the kernel against
ctc_prefix_scores_reference at the decode cell's shape, at B = 32 and at
B = 1, a card beam search against the CPU search, the launch count, and
the inputs the kernel refuses. Run there with
`python -m pytest --noconftest tests/test_torch_ctc_prefix_kernel.py`
(tests/conftest.py imports JAX; these tests need torch alone).
"""

import dataclasses
import hashlib
import os
import shutil

import pytest
import torch
from torch_card import card  # noqa: F401  (the fixture)

from speech_recognition_tools_tpu_torch import kernels
from speech_recognition_tools_tpu_torch.decode import ctc_prefix as ctc
from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_encoded
from speech_recognition_tools_tpu_torch.models.transformer_asr import (
    TransformerASR,
    TransformerASRConfig,
)

NEG_INF = torch.tensor(ctc.NEG_INF, dtype=torch.float32)
V = 52
# prefixes of every utterance: empty (last token -1), ordinary tokens, a
# repeated last token, blank as the last token, eos; the last row is made
# impossible (NEG_INF forward variables) below
PREFIXES = [[], [5], [5, 5], [7, 3], [0], [3, 0], [12, 12, 12], [9, 4, 9, 4], [V - 1]]


def _logp(B, T, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.log_softmax(torch.randn(B, T, V, generator=g) * 2, -1).to(device)


def prefix_inputs(B, T, enc_len, seed, device):
    """logp, enc_len, prefix_lens, last_tokens and r_prev for PREFIXES and
    one impossible prefix, the forward variables chained through the plain
    version from the empty prefix's (chip_smoke.py times K2 on them)."""
    logp = _logp(B, T, seed, device)
    enc_len = torch.as_tensor(enc_len, dtype=torch.long, device=device)
    rows = []
    for seq in PREFIXES:
        r = ctc.init_prefix_state(logp, enc_len, 1)
        for j, tok in enumerate(seq):
            lens = torch.full((B, 1), j, dtype=torch.long, device=device)
            last = torch.full((B, 1), seq[j - 1] if j else -1, dtype=torch.long, device=device)
            _, _, r_new = ctc.ctc_prefix_scores_reference(logp, enc_len, lens, last, r)
            r = r_new[:, :, tok]
        rows.append(r)
    rows.append(torch.full_like(rows[0], ctc.NEG_INF))
    r_prev = torch.cat(rows, 1).contiguous()
    lens = torch.tensor([len(s) for s in PREFIXES] + [3], device=device).expand(B, -1)
    last = torch.tensor([s[-1] if s else -1 for s in PREFIXES] + [8], device=device).expand(B, -1)
    return logp, enc_len, lens.contiguous(), last.contiguous(), r_prev


def _assert_matches(got, want):
    """Finite entries within 1e-5 relative; every NEG_INF entry exact, in
    place. Returns the number of NEG_INF entries."""
    got, want = got.cpu(), want.cpu()
    dead = want == NEG_INF
    assert torch.equal(got == NEG_INF, dead)
    assert (~dead).any()
    assert torch.isfinite(got[~dead]).all() and (got[~dead] > -1e29).all()
    torch.testing.assert_close(got[~dead], want[~dead], rtol=1e-5, atol=0)
    return int(dead.sum())


def _check_kernel(B, T, enc_len, seed, device, expand_first=False):
    args = prefix_inputs(B, T, enc_len, seed, device)
    before = ctc.ctc_prefix_scores.launches
    got = ctc.ctc_prefix_scores(*args)
    torch.cuda.synchronize()
    assert ctc.ctc_prefix_scores.launches == before + 1
    want = ctc.ctc_prefix_scores_reference(*args)
    assert got[2].shape == want[2].shape == (B, len(PREFIXES) + 1, V, T, 2)
    assert got[2].stride() == want[2].stride()
    dead = sum(_assert_matches(g, w) for g, w in zip(got, want))
    assert dead > 0
    if expand_first:  # the search's first step: the empty prefix's expanded state
        logp, enc, _, _, _ = args
        K = 10
        r0 = ctc.init_prefix_state(logp, enc, K)
        zeros = torch.zeros((B, K), dtype=torch.long, device=device)
        first = (logp, enc, zeros, torch.full_like(zeros, -1), r0)
        for g, w in zip(ctc.ctc_prefix_scores(*first), ctc.ctc_prefix_scores_reference(*first)):
            _assert_matches(g, w)


# ------------------------------------------------------------------ CPU


def test_cpu_input_runs_the_plain_version_and_launches_nothing():
    args = prefix_inputs(2, 9, [9, 5], 1, torch.device("cpu"))
    before = ctc.ctc_prefix_scores.launches
    got = ctc.ctc_prefix_scores(*args)
    want = ctc.ctc_prefix_scores_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ctc.ctc_prefix_scores.launches == before


def test_input_on_another_device_raises():
    logp = torch.empty((1, 4, V), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ctc.ctc_prefix_scores(logp, None, None, None, None)


def test_kernels_names_two_libraries():
    k1, k2 = kernels.library_path("lpc_cepstra"), kernels.library_path("ctc_prefix")
    assert k1 != k2
    with pytest.raises(TypeError):  # every caller names its kernel
        kernels.library_path()
    assert os.path.dirname(k1) == os.path.dirname(k2) == kernels.BUILD_DIR
    assert os.path.basename(k1).startswith("liblpc_cepstra-")
    assert os.path.basename(k2).startswith("libctc_prefix-")
    k1_src, k2_src = (kernels.KERNELS[n].source for n in ("lpc_cepstra", "ctc_prefix"))
    assert k1_src == kernels.SOURCE != k2_src and os.path.exists(k2_src)


def test_k1_library_path_is_k1s_source_units_and_flags_alone(tmp_path, monkeypatch):
    """K1's path is the hash it always was (K1's source, the flags, K1's
    units); an edit of K2's source moves K2's path and not K1's."""
    h = hashlib.sha1()
    with open(kernels.SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([*kernels.COMPILE_FLAGS, *kernels.LINK_FLAGS]).encode())
    h.update(repr(kernels._units()).encode())
    k1 = os.path.join(kernels.BUILD_DIR, f"liblpc_cepstra-{h.hexdigest()[:12]}.so")
    assert kernels.library_path("lpc_cepstra") == k1
    k2 = kernels.library_path("ctc_prefix")

    edited = tmp_path / "ctc_prefix.cu"
    shutil.copy(kernels.KERNELS["ctc_prefix"].source, edited)
    with open(edited, "a") as f:
        f.write("// edited\n")
    monkeypatch.setitem(kernels.KERNELS, "ctc_prefix",
                        dataclasses.replace(kernels.KERNELS["ctc_prefix"], source=str(edited)))
    assert kernels.library_path("ctc_prefix") != k2
    assert kernels.library_path("lpc_cepstra") == k1


# ------------------------------------------------------------------ card


@pytest.mark.parametrize("B,T,lo", [(8, 303, 100), (32, 249, 149)], ids=["B8", "B32"])
def test_kernel_matches_the_plain_version_at_the_decode_cells_shape(card, B, T, lo):
    """B 8, K 10, V 52, T 303, enc_len spread over 100-303; and B 32 at T
    249, enc_len 149-249 (32 utterances of 6-10 s, a recog_e2e batch)."""
    enc = torch.linspace(lo, T, B).round().long().tolist()
    _check_kernel(B, T, enc, 2, card, expand_first=True)


def test_kernel_matches_the_plain_version_at_one_utterance(card):
    """B = 1, the streaming rescore; a valid length past T is held to T."""
    _check_kernel(1, 57, [57], 3, card, expand_first=True)
    _check_kernel(1, 40, [45], 4, card)


def test_card_search_matches_the_cpu_search(card):
    """beam_search_encoded at beam 4, max_len 12 on the card is
    token-identical to the CPU search on the same encoder output, scores
    within 1e-5 relative, and launches K2 once a step."""
    cfg = TransformerASRConfig(vocab_size=V, adim=32, aheads=4, elayers=2, eunits=64,
                               dlayers=2, dunits=64, dropout=0.0)
    cpu_model = TransformerASR(cfg, 20, device="cpu").eval()
    cpu_model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # peaked heads: random weights otherwise give near ties
        cpu_model.ctc_head.weight.mul_(4.0)
        cpu_model.decoder.output.weight.mul_(4.0)
    card_model = TransformerASR(cfg, 20, device=card).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, 200, 20, generator=g)
    lens = torch.tensor([200, 150, 90])
    with torch.no_grad():
        enc = cpu_model.encode(feats, lens)
    beam = dict(beam_size=4, max_len=12)
    want_toks, want_scores = beam_search_encoded(cpu_model, *enc, **beam)
    before = ctc.ctc_prefix_scores.launches
    toks, scores = beam_search_encoded(card_model, *(x.to(card) for x in enc), **beam)
    steps = int((toks[:, :, 1:] >= 0).any(0).any(0).sum())
    assert steps >= 1
    assert ctc.ctc_prefix_scores.launches == before + steps
    assert torch.equal(toks.cpu(), want_toks)
    torch.testing.assert_close(scores.cpu(), want_scores, rtol=1e-5, atol=0)


def test_kernel_takes_int32_lengths(card):
    """encode_ring's int32 enc_len: widened, one launch, the int64 result."""
    args = prefix_inputs(2, 16, [16, 9], 6, card)
    want = ctc.ctc_prefix_scores(*args)
    before = ctc.ctc_prefix_scores.launches
    got = ctc.ctc_prefix_scores(args[0], args[1].int(), *args[2:])
    assert ctc.ctc_prefix_scores.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_refuses_what_it_does_not_take(card):
    logp, enc, lens, last, r_prev = prefix_inputs(2, 16, [16, 9], 5, card)
    before = ctc.ctc_prefix_scores.launches
    with pytest.raises(TypeError, match="float32"):
        ctc.ctc_prefix_scores(logp.double(), enc, lens, last, r_prev.double())
    with pytest.raises(ValueError, match="contiguous logp"):
        wide = torch.empty((2, 16, 2 * V), device=card)[..., :V].copy_(logp)
        ctc.ctc_prefix_scores(wide, enc, lens, last, r_prev)
    with pytest.raises(ValueError, match="rows contiguous"):
        ctc.ctc_prefix_scores(logp, enc, lens, last, r_prev.transpose(2, 3).contiguous()
                              .transpose(2, 3))
    with pytest.raises(ValueError, match="int64"):
        ctc.ctc_prefix_scores(logp, enc.float(), lens, last, r_prev)
    with pytest.raises(ValueError, match="int64"):
        ctc.ctc_prefix_scores(logp, enc, lens.int(), last, r_prev)
    with pytest.raises(ValueError, match="is on cpu"):
        ctc.ctc_prefix_scores(logp, enc.cpu(), lens, last, r_prev)
    assert ctc.ctc_prefix_scores.launches == before
