"""Share of the H100's float32 peak (67 TFLOP/s) that the decode's
necessary operations reach over the window's batches after the profiled
ones, over their wall time.

Counted from the shapes, as the work the configuration needs and not
what one implementation launches (2 flops a multiply-add):
  - encoder, per valid input frame and output frame: the two 3x3
    convolutions and the projection of the subsampling, then per layer
    the q, k, v, out projections, the attention's scores and weighted sum
    over the utterance's valid frames, the FFN;
  - search, per step and hypothesis (beam x batch): the decoder for one
    new token (self-attention over the prefix, cross-attention over the
    memory, whose keys and values are projected once per utterance, the
    FFN, the output layer), the GRU RNNLM step and its output layer, and
    the CTC prefix scores (the two forward variables of every vocabulary
    extension over the valid frames: 8 operations each).
"""

from benchmark.common import H100_F32_FLOPS


def encoder_flops(am, idim, t_in, t2):
    A, F = am["adim"], am["eunits"]
    d1 = (idim - 1) // 2
    d2 = (d1 - 1) // 2
    t1 = (t_in - 1) // 2
    conv = 2 * 9 * A * t1 * d1 + 2 * 9 * A * A * t2 * d2 + 2 * d2 * A * A * t2
    layer = t2 * (8 * A * A + 4 * t2 * A + 4 * A * F)
    return conv + am["elayers"] * layer + 2 * A * am["vocab_size"] * t2


def search_step_flops(am, lm, t2, prefix):
    A, F, V = am["adim"], am["dunits"], am["vocab_size"]
    dec = am["dlayers"] * (8 * A * A + 4 * prefix * A + 4 * A * A + 4 * t2 * A + 4 * A * F)
    dec += 2 * A * V
    E, H = lm["embed_dim"], lm["units"]
    rnn = lm["layers"] * 2 * 3 * H * (E + H) + 2 * H * V
    return dec + rnn + 8 * t2 * V


def read(run):
    f = run.facts
    skip = run.traced_units
    seconds = sum(f.get("batch_s", [])[skip:])
    if not seconds:
        return None
    am, lm = run.config["am"], run.config["lm"]
    idim = run.config["frontend"]["nfilters"]
    K = f["beam"]
    total = 0
    for ins, lens, steps in zip(f["in_lens"][skip:], f["enc_lens"][skip:], f["steps"][skip:]):
        for t_in, t2 in zip(ins, lens):
            total += encoder_flops(am, idim, t_in, t2)
            total += 4 * am["dlayers"] * am["adim"] ** 2 * t2  # cross-attention keys, values
            total += K * sum(search_step_flops(am, lm, t2, s + 1) for s in range(steps))
    return 100.0 * total / seconds / H100_F32_FLOPS
