"""Training steps (traffic kind "train").

The model family comes from the configuration's `am.type`:
  - "rnn": `cli/train_am.py`'s `build_model(--arch rnn)` and `make_loss`
    stepped by `train/trainer.py::Trainer.train_step` (clipped Adam of
    `train/optim.py`), batches from `io/egs.py::iter_egs_batches` over an
    egs directory that set-up writes under TMPDIR, moved by
    `batch_on_device`, as `train_am` runs them;
  - "transformer_asr": `cli/train_e2e.py::make_train_step` (the joint
    CTC/attention loss, clipped Adam with b2 0.98 on the Noam rate), its
    batches from `token_batches` over egs and a text file set-up writes.

Inputs from the seed: `utterances` feature matrices of lengths evenly
spread over [seconds_lo, seconds_hi] (the same set every seed), N(0, 1)
as global CMVN leaves features; hybrid frame labels uniform over the
classes with every class present; e2e transcripts of random characters,
one per 12 output frames. The loader cycles over the egs (the batches'
order drawn from the seed).

Set-up builds the one training object and drives it through its first
three steps by the window's own call and loader; the window continues
with it. Check: the plain reference (reference/training.py) follows those
three steps from the same first weights and batches: each step's loss,
the first step's clipped gradient (the program's read back from Adam's
first moment, mu = (1 - b1) g), the change of the weights over the three
steps, each leaf by its norm.
"""

import os
import shutil
import tempfile
import time
from contextlib import nullcontext

import numpy as np

from benchmark.common import device_generator, draw_weights, lengths_grid, numpy_seed

B1 = 0.9
FIRST_STEPS = 3
LETTERS = "abcdefghijklmnopqrstuvwxyz'.-0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _span(ctx, name):
    return ctx.rec.span(name) if ctx.trace else nullcontext()


def _features(ctx, gen, dim):
    import torch

    p = ctx.params
    rate = p["frame_rate"]
    lens = lengths_grid(p["utterances"], p["seconds_lo"], p["seconds_hi"], 1.0 / rate,
                        ctx.seed)
    feats = torch.randn(int(lens.sum()), dim, generator=gen, device=ctx.device).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [(f"utt{i:04d}", feats[offs[i]:offs[i + 1]]) for i in range(len(lens))]


def _cycle(make_iter):
    while True:
        yield from make_iter()


def _setup_rnn(ctx, gen, work):
    from speech_recognition_tools_tpu_torch.cli import train_am
    from speech_recognition_tools_tpu_torch.io.egs import build_egs, iter_egs_batches, load_egs
    from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

    am, dev = ctx.config["am"], ctx.device
    C, D = am["num_classes"], ctx.config["frontend"]["nfilters"]
    utts = _features(ctx, gen, D)
    rng = np.random.RandomState(numpy_seed(ctx.seed))
    total = sum(len(f) for _, f in utts)
    flat = rng.randint(0, C, total)
    flat[rng.choice(total, C, replace=False)] = np.arange(C)  # every class present
    labels = dict(zip([k for k, _ in utts],
                      np.split(flat, np.cumsum([len(f) for _, f in utts])[:-1])))
    egs = os.path.join(work, "egs")
    build_egs(iter(utts), egs, labels, num_targets=C)

    args = train_am.get_parser().parse_args([
        egs, os.path.join(work, "am"), "--arch", "rnn",
        "--num_layers", str(am["num_layers"]), "--hidden_dim", str(am["hidden_dim"]),
        "--dropout", str(am["dropout"]), "--optimizer", am["optimizer"],
        "--learning_rate", str(am["learning_rate"]), "--clip_thresh", str(am["clip_thresh"]),
        "--batch_size", str(am["batch_size"])])
    model = train_am.build_model(args, D, C, dev)
    weights = draw_weights(model, gen, dev)
    trainer = Trainer(model, train_am.make_loss(args),
                      TrainConfig(optimizer=args.optimizer, learning_rate=args.learning_rate,
                                  clip_threshold=args.clip_thresh))
    tstate = trainer.init_state()
    _, loaded = load_egs(egs)
    order = numpy_seed(ctx.seed)
    batches = _cycle(lambda: iter_egs_batches(loaded, args.batch_size, shuffle_seed=order))

    def step(host_batch):
        with _span(ctx, "train.load"):
            batch = train_am.batch_on_device(host_batch, dev)
        with _span(ctx, "train.step"):
            loss, _, _ = trainer.train_step(tstate, batch)
        return loss

    def first_grads():
        mu = tstate.opt_state["mu"]
        return {k: v.detach() / (1 - B1) for k, v in mu.items()}

    def params():
        return {k: v.detach() for k, v in tstate.params.items()}

    lr = float(np.float32(args.learning_rate))  # inject_hyperparams holds it in float32
    return dict(step=step, batches=batches, weights=weights, first_grads=first_grads,
                params=params, lr_at=lambda count: lr, b2=0.999, clip=args.clip_thresh,
                owner=[model, trainer, tstate])


def _setup_e2e(ctx, gen, work):
    import torch

    from speech_recognition_tools_tpu_torch.cli import train_e2e
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab
    from speech_recognition_tools_tpu_torch.models.transformer_asr import (
        TransformerASR,
        TransformerASRConfig,
        noam_schedule,
    )
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    from benchmark.common import random_transcript

    am, dev = ctx.config["am"], ctx.device
    if am["dropout"] != 0:
        raise ValueError("the e2e train check follows the step without dropout: set "
                         "am.dropout to 0 in the cell's configuration")
    D = ctx.config["frontend"]["nfilters"]
    utts = _features(ctx, gen, D)
    rng = np.random.RandomState(numpy_seed(ctx.seed))
    # <blank>, <unk>, <space>, the letters, <sos/eos>
    letters = LETTERS[: am["vocab_size"] - 4]
    texts = {k: random_transcript(rng, letters, max(1, (len(f) // 4 - 2) // 3))
             for k, f in utts}
    vocab = build_char_vocab([*texts.values(), letters])
    if len(vocab) != am["vocab_size"]:
        raise ValueError(f"the transcripts give {len(vocab)} units, not am.vocab_size")
    egs = os.path.join(work, "egs")
    build_egs(iter(utts), egs)
    cfg = TransformerASRConfig(
        vocab_size=len(vocab), adim=am["adim"], aheads=am["aheads"], elayers=am["elayers"],
        eunits=am["eunits"], dlayers=am["dlayers"], dunits=am["dunits"], dropout=0.0,
        mtlalpha=am["mtlalpha"], lsm_weight=am["lsm_weight"])
    model = TransformerASR(cfg, D, device=dev)
    weights = draw_weights(model, gen, dev)
    sched = noam_schedule(cfg.adim, am["warmup_steps"], am["transformer_lr"])
    opt = ClipAdam(sched, am["grad_clip"], b2=0.98)
    params_live = dict(model.named_parameters())
    opt_state = [opt.init(params_live)]
    step_fn = train_e2e.make_train_step(model, cfg, opt)
    batches = _cycle(lambda: train_e2e.token_batches(egs, texts, vocab, am["batch_size"]))

    def step(host_batch):
        with _span(ctx, "train.load"):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}
        with _span(ctx, "train.step"):
            opt_state[0], loss, _ = step_fn(opt_state[0], batch)
            loss = float(loss)  # train_e2e reads it every step
        return loss

    def first_grads():
        return {k: v.detach() / (1 - B1) for k, v in opt_state[0]["mu"].items()}

    def params():
        return {k: v.detach() for k, v in params_live.items()}

    return dict(step=step, batches=batches, weights=weights, first_grads=first_grads,
                params=params, lr_at=sched, b2=0.98, clip=am["grad_clip"],
                owner=[model, opt_state])


def setup(ctx):
    kind = ctx.config["am"]["type"]
    work = tempfile.mkdtemp(prefix="bench_train_")  # under TMPDIR
    gen = device_generator(ctx.seed, ctx.device)
    made = {"rnn": _setup_rnn, "transformer_asr": _setup_e2e}[kind](ctx, gen, work)
    state = dict(made, work=work, first=[], losses=[])
    for n in range(FIRST_STEPS):  # the window's own call and feed, rows that all differ
        host = next(state["batches"])
        state["first"].append(host)
        state["losses"].append(float(state["step"](host)))
        if n == 0:
            state["g1"] = {k: v.clone() for k, v in state["first_grads"]().items()}
    state["p3"] = {k: v.clone() for k, v in state["params"]().items()}
    return state


def window(ctx, state):
    rate = ctx.params["frame_rate"]
    steps = audio = frames = 0
    step_frames = []
    t0 = time.perf_counter()
    while True:
        host = next(state["batches"])
        state["step"](host)
        n = int(np.asarray(host["lengths"]).sum())
        audio += n / rate
        frames += n
        step_frames.append(n)
        steps += 1
        if ctx.tracer is not None and ctx.tracer.active:
            ctx.tracer.unit_done()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    ctx.facts.update(steps=steps, step_frames=step_frames)
    return {"metrics": {"train_audio_s_per_s": audio / elapsed},
            "attempted": steps, "failed": 0}


def _leaf_readings(got_g, got_dp, ref_g, ref_dp):
    """The worst leaf's gap between the program's and the reference's norms,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger: of the first clipped gradient, and of the change over the
    first steps (leaves whose reference gradient is under a thousandth of
    the median leaf's left out: they move by round-off alone)."""
    import torch

    def norms(d):
        return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}

    gg, rg, gd, rd = norms(got_g), norms(ref_g), norms(got_dp), norms(ref_dp)
    med_g = float(np.median(list(rg.values())))
    med_d = float(np.median(list(rd.values())))
    grad = max(abs(gg[k] - rg[k]) / max(rg[k], med_g) for k in rg)
    moved = [k for k in rd if rg[k] >= 1e-3 * med_g]
    change = max(abs(gd[k] - rd[k]) / max(rd[k], med_d) for k in moved)
    return grad, change


def _readings(ctx, state, P, half=False):
    """The reference's losses, first clipped gradient and change over the
    first steps; `half`: with each batch cut to its first half of rows, the
    mean taken over them (a fault the check has to catch)."""
    import torch

    from benchmark.reference.training import adam_steps

    am = ctx.config["am"]
    batches = [{k: torch.as_tensor(v, device=ctx.device) for k, v in host.items()
                if k != "keys"} for host in state["first"]]
    if half:
        batches = [{k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()} for b in batches]
    losses, g1, p3 = adam_steps(state["weights"], batches, am, state["lr_at"], state["clip"],
                                state["b2"], P)
    return [float(x) for x in losses], g1, {k: p3[k] - P.t(v) for k, v in
                                            state["weights"].items()}


def _against(other, losses, g1, dp):
    o_losses, o_g1, o_dp = other
    grad, change = _leaf_readings(o_g1, o_dp, g1, dp)
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(o_losses, losses)),
            "grad_leaf": grad, "change_leaf": change}


def check(ctx, state):
    import torch

    from benchmark.reference.precision import Precision

    got_dp = {k: state["p3"][k].double() - state["weights"][k].double() for k in state["p3"]}
    got_g, got_losses = state["g1"], state["losses"]
    for k in ("owner", "step", "batches", "first_grads", "params"):
        state.pop(k)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(state["work"], ignore_errors=True)
    losses, g1, dp = _readings(ctx, state, Precision("f64"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses))
    grad, change = _leaf_readings(got_g, got_dp, g1, dp)
    readings = {"loss_rel": loss_rel, "grad_leaf": grad, "change_leaf": change}
    if ctx.facts.get("control"):
        ctx.facts["control_readings"] = _against(
            _readings(ctx, state, Precision("tf32")), losses, g1, dp)
        ctx.facts["fault_readings"] = {"half_batch": _against(
            _readings(ctx, state, Precision("f64"), half=True), losses, g1, dp)}
    ctx.facts["readings"] = readings
    return [(k, readings[k], lim) for k, lim in ctx.cell["limits"].items()]
