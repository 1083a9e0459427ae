"""Share of the H100's float32 peak (67 TFLOP/s) that a hybrid train step's
necessary operations reach over the step's own time (the benchmark's span
around `Trainer.train_step`, synchronised in the traced run), over the
window's steps after the profiled ones.

Counted from the shapes over the valid frames only (2 flops a
multiply-add): per frame and GRU layer the input and recurrent products
2 x 3H (D_in + H) and ~12 H of gates; the output layer 2 H C and its
softmax ~3 C; the backward pass twice the forward; Adam ~10 flops a
parameter a step. Only the "rnn" family: for another it reads nothing.
"""

from benchmark.common import H100_F32_FLOPS


def step_flops(am, feat_dim, frames):
    H, C = am["hidden_dim"], am["num_classes"]
    fwd = 0
    d_in = feat_dim
    for _ in range(am["num_layers"]):
        fwd += 2 * 3 * H * (d_in + H) + 12 * H
        d_in = H
    fwd += 2 * H * C + 3 * C
    params = 0
    d_in = feat_dim
    for _ in range(am["num_layers"]):
        params += 3 * H * (d_in + H) + 4 * H
        d_in = H
    params += H * C + C
    return 3 * fwd * frames + 10 * params


def read(run):
    am = run.config["am"]
    spans = run.spans.get("train.step")
    frames = run.facts.get("step_frames")
    if am["type"] != "rnn" or not spans or not frames:
        return None
    D = run.config["frontend"]["nfilters"]
    total = sum(step_flops(am, D, f) for f in frames[run.traced_units:])
    return 100.0 * total / sum(spans) / H100_F32_FLOPS
