"""Kernel K3 (csrc/gru_scan.cu) behind ops/gru_scan.py::gru_scan, the time
loop of models/recurrent.py::MaskedGRULayer.

On the CPU: CPU input takes the plain loop and launches nothing; kernels.py
keeps K3 in a library of its own whose source enters neither K1's nor K2's
library path; the launch plan and the weight slices' layout; and a plain
mirror of K3's forward and backward algebra (the per-frame gate-gradient
recurrence and the frozen carry's pass-through, in torch ops), run through
the autograd.Function in the kernels' place, equals autograd through the
loop (also under torch.func.vmap). On the card (skipped without one): the
kernel's outputs and gradients against the plain loop at the train cell's
longest batch and at the RNNLM's shape, a few odd shapes, the launches of
one 3-layer train step, vmapped experts, and the inputs the kernel
refuses. Run there with
`python -m pytest --noconftest tests/test_torch_gru_kernel.py`
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
from speech_recognition_tools_tpu_torch.ops import gru_scan as k3
from speech_recognition_tools_tpu_torch.ops.gru_scan import gru_scan, gru_scan_reference


def _inputs(B, T, H, lengths, seed, device, dtype=torch.float32):
    """xi (B, T, 3H), W_hh (3H, H) and b_hn (H,) with the scales a drawn
    layer gives (orthogonal-like W_hh), lengths (B,) int64."""
    g = torch.Generator().manual_seed(seed)
    xi = torch.randn(B, T, 3 * H, generator=g, dtype=torch.float64)
    w = torch.randn(3 * H, H, generator=g, dtype=torch.float64) / H ** 0.5
    b = 0.1 * torch.randn(H, generator=g, dtype=torch.float64)
    return (xi.to(device, dtype), w.to(device, dtype), b.to(device, dtype),
            torch.as_tensor(lengths, dtype=torch.long, device=device))


# ------------------------------------------------------------- mirrors


def mirror_forward(xi, weight_hh, bias_hn, lengths, save):
    """K3's forward in torch ops: (y, gates) with gates (B, T, 4H) = r, z,
    n, W_hn h + b_hn of every frame (the kernel writes valid frames only)."""
    B, T, H3 = xi.shape
    H = H3 // 3
    keep = k3.length_mask(lengths, T)
    h = xi.new_zeros((B, H))
    ys, gs = [], []
    for t in range(T):
        x_r, x_z, x_n = xi[:, t].split(H, -1)
        h_r, h_z, h_n = (h @ weight_hh.T).split(H, -1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        hnb = h_n + bias_hn
        n = torch.tanh(x_n + r * hnb)
        h_new = (1 - z) * n + z * h
        k = keep[:, t, None]
        h = torch.where(k, h_new, h)
        ys.append(torch.where(k, h_new, 0.0))
        gs.append(torch.cat([r, z, n, hnb], -1))
    return torch.stack(ys, 1), (torch.stack(gs, 1) if save else xi.new_empty(0))


def mirror_backward(dy, y, gates, weight_hh, lengths):
    """K3's backward in torch ops: t = T-1 .. 0, dh the carry's gradient;
    on a valid frame g = dy + dh, the gate gradients from the saved gates
    and h_{t-1} = y[:, t-1], dh <- g z + dhh W_hh; past the length dh
    passes through and dxi = dhh = 0. Returns (dxi, dhh)."""
    B, T, H = y.shape
    keep = k3.length_mask(lengths, T)
    dh = y.new_zeros((B, H))
    dxi = y.new_zeros((B, T, 3 * H))
    dhh = y.new_zeros((B, T, 3 * H))
    for t in reversed(range(T)):
        k = keep[:, t, None]
        r, z, n, hnb = gates[:, t].split(H, -1)
        h_prev = y[:, t - 1] if t else torch.zeros_like(dh)
        g = dy[:, t] + dh
        dn = g * (1 - z) * (1 - n * n)
        dz = g * (h_prev - n) * z * (1 - z)
        dr = dn * hnb * r * (1 - r)
        dxi[:, t] = torch.where(k, torch.cat([dr, dz, dn], -1), 0.0)
        dhh[:, t] = torch.where(k, torch.cat([dr, dz, dn * r], -1), 0.0)
        dh = torch.where(k, g * z + dhh[:, t] @ weight_hh, dh)
    return dxi, dhh


@pytest.fixture
def mirrored(monkeypatch):
    """The autograd.Function with the mirrors in the kernels' place."""
    monkeypatch.setattr(k3, "_kernel_forward", mirror_forward)
    monkeypatch.setattr(k3, "_kernel_backward", mirror_backward)


def _grads(fn, xi, w, b, lengths, dy):
    xi, w, b = (x.detach().requires_grad_() for x in (xi, w, b))
    y = fn(xi, w, b, lengths)
    (y * dy).sum().backward()
    return y.detach(), xi.grad, w.grad, b.grad


# ------------------------------------------------------------------ CPU


def test_cpu_input_runs_the_plain_loop_and_launches_nothing():
    from speech_recognition_tools_tpu_torch.models.recurrent import MaskedGRULayer

    layer = MaskedGRULayer(6, 8)
    x = torch.randn(3, 7, 6)
    lengths = torch.tensor([7, 3, 0])
    before = gru_scan.launches
    got = layer(x, lengths)
    xi = torch.nn.functional.linear(x, layer.weight_ih, layer.bias_ih)
    want = gru_scan_reference(xi, layer.weight_hh, layer.bias_hn, lengths)
    assert torch.equal(got, want)
    assert torch.equal(got[1, 3:], torch.zeros(4, 8)) and torch.equal(got[2], torch.zeros(7, 8))
    assert gru_scan.launches == before


def test_input_on_another_device_raises():
    xi = torch.empty((1, 4, 24), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gru_scan(xi, torch.empty(24, 8), torch.empty(8), torch.tensor([4]))


def test_kernels_names_three_libraries():
    k1, k2, k3_lib = (kernels.library_path(n) for n in ("lpc_cepstra", "ctc_prefix", "gru_scan"))
    assert len({k1, k2, k3_lib}) == 3
    assert os.path.dirname(k3_lib) == kernels.BUILD_DIR
    assert os.path.basename(k3_lib).startswith("libgru_scan-")
    srcs = [kernels.KERNELS[n].source for n in ("lpc_cepstra", "ctc_prefix", "gru_scan")]
    assert srcs[2] == kernels.GRU_SOURCE and os.path.exists(srcs[2])
    assert len(set(srcs)) == 3
    names = [n for n, _ in kernels.KERNELS["gru_scan"].units()]
    assert names[0] == "entry" and len(names) == 1 + len(kernels.gru_configs())
    assert {n for n, _ in kernels.KERNELS["gru_scan"].more} == {"gru_scan_bwd_f32"}
    assert sorted(u for u, _, _ in kernels.gru_configs()) == [1, 2]  # one instantiation a upt


def test_k3_source_enters_neither_k1s_nor_k2s_library(tmp_path, monkeypatch):
    """K1's and K2's paths are the hashes of their own sources, units and
    flags; an edit of K3's source moves K3's path alone."""
    def own_hash(name):
        k = kernels.KERNELS[name]
        h = hashlib.sha1()
        with open(k.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join([*kernels.COMPILE_FLAGS, *kernels.LINK_FLAGS]).encode())
        h.update(repr(k.units()).encode())
        return os.path.join(kernels.BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")

    paths = {n: kernels.library_path(n) for n in ("lpc_cepstra", "ctc_prefix", "gru_scan")}
    assert all(paths[n] == own_hash(n) for n in paths)
    edited = tmp_path / "gru_scan.cu"
    shutil.copy(kernels.GRU_SOURCE, edited)
    with open(edited, "a") as f:
        f.write("// edited\n")
    monkeypatch.setitem(kernels.KERNELS, "gru_scan",
                        dataclasses.replace(kernels.KERNELS["gru_scan"], source=str(edited)))
    assert kernels.library_path("gru_scan") != paths["gru_scan"]
    assert kernels.library_path("lpc_cepstra") == paths["lpc_cepstra"]
    assert kernels.library_path("ctc_prefix") == paths["ctc_prefix"]


@pytest.mark.parametrize("backward", [False, True])
def test_launch_plan(backward):
    """One layout serves both directions, a function of H alone. H 512: 16
    blocks of 32 units, one a lane; H 300, 64 and 8: fewer or emptier
    blocks; H 1000: 16 blocks, two units a lane; H 1025 raises. The
    direction's slices hold every unit of W_hh once."""
    want = {512: (16, 32, 1), 300: (16, 19, 1), 64: (2, 32, 1), 8: (1, 8, 1),
            1000: (16, 63, 2), 1024: (16, 64, 2)}
    for H, (cs, units, upt) in want.items():
        p = k3.launch_plan(H)
        assert (p.cs, p.units, p.upt) == (cs, units, upt), H
        assert p.cs * p.units >= H and p.units <= 32 * p.upt
        w = k3._slices(torch.ones(3 * H, H), p, backward)
        assert w.shape == ((p.cs, 96 * p.upt, H) if backward else (p.cs, H, 96 * p.upt))
        assert int(w.sum()) == 3 * H * H
    assert {u for u, _, _ in kernels.gru_configs()} == {k3.launch_plan(H).upt for H in want}
    with pytest.raises(ValueError, match="up to 1024"):
        k3.launch_plan(1025)


@pytest.mark.parametrize("H", [40, 1000])
def test_weight_slices_layout(H):
    """Block c's slot l + 32 i, gate g: forward [c][k][96 i + 3 l + g],
    backward [c][96 i + 3 l + g][k] = W_hh[g H + c U + 32 i + l][k]; slots
    past the units zero."""
    w = torch.randn(3 * H, H)
    p = k3.launch_plan(H)
    fwd, bwd = k3._slices(w, p, False), k3._slices(w, p, True)
    assert fwd.shape == (p.cs, H, 96 * p.upt) and bwd.shape == (p.cs, 96 * p.upt, H)
    for c in range(p.cs):
        for i in range(p.upt):
            for lane in range(32):
                slot = 32 * i + lane
                for g in range(3):
                    j = 96 * i + 3 * lane + g
                    u = c * p.units + slot
                    want = w[g * H + u] if slot < p.units and u < H else torch.zeros(H)
                    assert torch.equal(fwd[c, :, j], want) and torch.equal(bwd[c, j], want)


@pytest.mark.parametrize("B,T,H,lengths", [
    (4, 9, 8, [9, 1, 0, 5]),
    (1, 12, 16, [12]),
    (3, 7, 64, [7, 6, 1]),
    (2, 5, 33, [0, 5]),
])
def test_mirror_of_k3_algebra_equals_autograd_through_the_loop(mirrored, B, T, H, lengths):
    """The autograd.Function with the mirrors in the kernels' place: y and
    the gradients of xi, W_hh and b_hn equal autograd through the plain
    loop (float64, 1e-6), lengths 0, 1 and T among them."""
    xi, w, b, lens = _inputs(B, T, H, lengths, 7, "cpu", torch.float64)
    dy = torch.randn(B, T, H, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    want = _grads(gru_scan_reference, xi, w, b, lens, dy)
    got = _grads(lambda *a: k3._GruScan.apply(*a, True)[0], xi, w, b, lens, dy)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-6, atol=1e-6)
    for row, n in enumerate(lengths):  # past the length, no gradient into xi
        assert torch.equal(got[1][row, n:], torch.zeros_like(got[1][row, n:]))


def test_mirror_under_vmap_equals_each_expert(mirrored):
    """torch.func.vmap over stacked experts (the expert-parallel zoo): the
    Function's vmap rule runs each expert alone; outputs and gradients
    equal each expert's own loop."""
    E, B, T, H = 3, 2, 6, 8
    g = torch.Generator().manual_seed(3)
    xi = torch.randn(E, B, T, 3 * H, generator=g, dtype=torch.float64, requires_grad=True)
    w = (torch.randn(E, 3 * H, H, generator=g, dtype=torch.float64) / 3).requires_grad_()
    b = torch.randn(E, H, generator=g, dtype=torch.float64, requires_grad=True)
    lens = torch.tensor([6, 3])
    y = torch.func.vmap(lambda x_, w_, b_: k3._GruScan.apply(x_, w_, b_, lens, True)[0])(xi, w, b)
    y.square().sum().backward()
    for e in range(E):
        xe, we, be = (t[e].detach().requires_grad_() for t in (xi, w, b))
        ye = gru_scan_reference(xe, we, be, lens)
        ye.square().sum().backward()
        torch.testing.assert_close(y[e].detach(), ye.detach(), rtol=1e-6, atol=1e-6)
        for got, want in ((xi.grad[e], xe.grad), (w.grad[e], we.grad), (b.grad[e], be.grad)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ card


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _check_card(B, T, D, H, lengths, seed, device, limit=2e-5):
    """A layer's outputs and its gradients (of xi, W_hh, b_hn and, through
    the input projection, W_ih) by K3 against the plain loop on the card:
    the worst entry's gap over the largest entry, under `limit`; one
    launch forward, one backward."""
    from speech_recognition_tools_tpu_torch.models.recurrent import MaskedGRULayer

    torch.manual_seed(seed)
    layer = MaskedGRULayer(D, H, device=device)
    x = torch.randn(B, T, D, device=device)
    lens = torch.as_tensor(lengths, dtype=torch.long, device=device)
    dy = torch.randn(B, T, H, device=device)

    def run(scan):
        for p in layer.parameters():
            p.grad = None
        xi = torch.nn.functional.linear(x, layer.weight_ih, layer.bias_ih)
        y = scan(xi, layer.weight_hh, layer.bias_hn, lens)
        (y * dy).sum().backward()
        return [y.detach()] + [p.grad.clone() for p in layer.parameters()]

    before = gru_scan.launches
    got = run(gru_scan)
    torch.cuda.synchronize()
    assert gru_scan.launches == before + 2
    want = run(gru_scan_reference)
    readings = [_rel(g, w) for g, w in zip(got, want)]
    assert max(readings) < limit, readings
    valid = k3.length_mask(lens, T)
    assert torch.equal(got[0][~valid], torch.zeros_like(got[0][~valid]))
    return readings


def test_card_matches_the_plain_loop_at_the_train_cells_longest_batch(card):
    """B 32, T 608, H 512, the first layer (D 20) and a later one (D 512),
    lengths spread over 200-608 frames."""
    lens = torch.linspace(200, 608, 32).round().long().tolist()
    _check_card(32, 608, 20, 512, lens, 0, card)
    _check_card(32, 608, 512, 512, lens, 1, card)


def test_card_matches_the_plain_loop_at_the_rnnlms_shape(card):
    """B 8, T 50, D 256, H 1000 (lm_loss): the slice read from L2."""
    _check_card(8, 50, 256, 1000, [50, 49, 40, 33, 20, 12, 5, 1], 2, card)


@pytest.mark.parametrize("B,T,D,H,lengths", [
    (1, 37, 20, 512, [37]),
    (5, 30, 13, 300, [30, 0, 1, 29, 17]),
    (7, 20, 8, 64, [20, 20, 3, 1, 0, 11, 19]),
    (3, 11, 9, 8, [11, 2, 7]),
    (4, 13, 7, 30, [13, 6, 1, 0]),
    (2, 25, 40, 600, [25, 24]),
])
def test_card_matches_the_plain_loop_at_odd_shapes(card, B, T, D, H, lengths):
    _check_card(B, T, D, H, lengths, 3, card)


def test_card_forward_without_gradient_stores_nothing(card):
    xi, w, b, lens = _inputs(4, 16, 64, [16, 9, 1, 0], 4, card)
    before = gru_scan.launches
    with torch.no_grad():
        got = gru_scan(xi, w, b, lens)
    assert gru_scan.launches == before + 1
    torch.testing.assert_close(got, gru_scan_reference(xi, w, b, lens), rtol=0, atol=2e-6)
    got32 = gru_scan(xi, w, b, lens.int())  # egs lengths are int32
    assert torch.equal(got32, got)


def test_card_train_step_launches_k3_six_times(card):
    """One 3 x 512 train_step: each layer's forward and backward one launch."""
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    model = RNNClassifier(20, 3, 512, 64, device=card)
    trainer = Trainer(model, lambda m, batch, train: (
        torch.nn.functional.cross_entropy(m(batch["x"], batch["lengths"]).flatten(0, 1),
                                          batch["y"].flatten()), {}), TrainConfig())
    state = trainer.init_state()
    batch = {"x": torch.randn(4, 50, 20, device=card),
             "lengths": torch.tensor([50, 40, 30, 20], device=card),
             "y": torch.randint(0, 64, (4, 50), device=card)}
    before = gru_scan.launches
    loss, _, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert gru_scan.launches == before + 6


GRU_ARCHS = ["rnn", "multitask_ae", "multitask_aear", "vae", "vae_classifier", "arvae",
             "pm_ae", "apc", "curl", "curl_unsup", "multimod"]


@pytest.mark.parametrize("arch", GRU_ARCHS + ["rnnlm"])
def test_card_every_gru_model_trains_through_k3(card, arch):
    """Every model of the port with a GRU stack (train_am's archs at small
    widths, one Trainer step through its make_loss; the RNNLM's lm_loss
    forward and backward) runs each GRU layer on K3: at least one launch
    a layer, and one backward."""
    from speech_recognition_tools_tpu_torch.cli import train_am
    from speech_recognition_tools_tpu_torch.models.recurrent import MaskedGRULayer
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM, lm_loss
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.manual_seed(9)
    lengths = torch.tensor([9, 6, 2], device=card)
    before = gru_scan.launches
    if arch == "rnnlm":
        model = RNNLM(12, 8, 16, 2, device=card)
        loss = lm_loss(model, torch.randint(0, 12, (3, 9), device=card), lengths)
        loss.backward()
    else:
        args = train_am.get_parser().parse_args(
            ["egs", "out", "--arch", arch, "--num_layers", "2", "--num_layers_dec", "1",
             "--hidden_dim", "16", "--bn_dim", "8", "--comp_num", "2"])
        model = train_am.build_model(args, 20, 12, card)
        trainer = Trainer(model, train_am.make_loss(args), TrainConfig())
        batch = {"feats": torch.randn(3, 9, 20, device=card), "lengths": lengths,
                 "labels": torch.randint(0, 12, (3, 9), device=card)}
        loss, _, _ = trainer.train_step(trainer.init_state(), batch)
    torch.cuda.synchronize()
    layers = sum(isinstance(m, MaskedGRULayer) for m in model.modules())
    assert layers > 0 and torch.isfinite(loss)
    assert gru_scan.launches - before >= layers + 1, (arch, layers, gru_scan.launches - before)


def test_card_vmapped_experts_match_each_expert(card):
    """The expert-parallel zoo's vmapped GRU stacks: one launch an expert
    each way; outputs and gradients equal each expert's own."""
    from speech_recognition_tools_tpu_torch.models.recurrent import DecoderRNN
    from speech_recognition_tools_tpu_torch.parallel.ep import vmap_experts, unstack_expert_params

    torch.manual_seed(5)
    experts = vmap_experts(lambda: DecoderRNN(12, 2, 64, 10, device=card), 3)
    x = torch.randn(3, 4, 20, 12, device=card)
    lens = torch.tensor([20, 15, 9, 1], device=card)
    before = gru_scan.launches
    out = experts(x, lens)
    out.square().sum().backward()
    assert gru_scan.launches == before + 3 * 2 * 2
    params = unstack_expert_params({k: v.detach() for k, v in experts.stacked().items()}, 3)
    for e in range(3):
        one = DecoderRNN(12, 2, 64, 10, device=card)
        one.load_state_dict(params[e])
        want = torch.func.functional_call(one, params[e], (x[e], lens))
        assert _rel(out[e].detach(), want.detach()) < 2e-5


def test_card_refuses_what_it_does_not_take(card):
    xi, w, b, lens = _inputs(2, 8, 16, [8, 3], 6, card)
    before = gru_scan.launches
    with pytest.raises(TypeError, match="float32"):
        gru_scan(xi.double(), w.double(), b.double(), lens)
    with pytest.raises(ValueError, match="contiguous xi"):
        gru_scan(xi.transpose(0, 1).contiguous().transpose(0, 1), w, b, lens)
    with pytest.raises(ValueError, match="lengths are on cpu"):
        gru_scan(xi, w, b, lens.cpu())
    with pytest.raises(ValueError, match="weight_hh is on cpu"):
        gru_scan(xi, w.cpu(), b, lens)
    with pytest.raises(ValueError, match="int64 or int32"):
        gru_scan(xi, w, b, lens.float())
    with pytest.raises(ValueError, match="up to 1024"):
        gru_scan(*_inputs(1, 2, 1030, [2], 6, card))
    assert gru_scan.launches == before


def test_card_entry_refuses_a_plan_it_does_not_take(card):
    """The C entry points check the layout they are given: blocks of more
    units than the lanes carry, a cluster size the kernel does not take, a
    upt no instantiation has; each returns cudaErrorInvalidValue (1) and
    launches nothing. The shared memory they size themselves."""
    lib = kernels.load("gru_scan")
    B, T, H = 2, 4, 64
    xi, w, b, lens = _inputs(B, T, H, [4, 2], 7, card)
    y = torch.zeros(B, T, H, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    for cs, upt in ((1, 1), (3, 1), (2, 3)):
        rc = lib.gru_scan_f32(xi.data_ptr(), w.data_ptr(), b.data_ptr(), lens.data_ptr(), B, T,
                              H, cs, upt, y.data_ptr(), None, stream)
        assert rc == 1, (cs, upt, rc)
        rc = lib.gru_scan_bwd_f32(y.data_ptr(), y.data_ptr(), y.data_ptr(), w.data_ptr(),
                                  lens.data_ptr(), B, T, H, cs, upt, y.data_ptr(), y.data_ptr(),
                                  stream)
        assert rc == 1, (cs, upt, rc)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros_like(y))
