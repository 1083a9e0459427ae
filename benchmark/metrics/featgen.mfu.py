"""Share of the H100's float32 peak (67 TFLOP/s) that FDLP's necessary
operations reach over the window's passes after the profiled ones, over
their wall time.

Counted from the shapes, per valid analysis window of N = srate fduration
samples (2 flops a multiply-add): the window multiply N; the DCT-II as a
real FFT 2.5 N log2 N; the band lags, each band over its own support
(the mel bank's nonzero bins, reference/fdlp.py) 2 x support x (order +
2); Levinson and the cepstrum per band (common.py::k1_work); the
log-envelope 2 x coeff_num x kk and its exp and window 2 kk per band; the
overlap-add kk per band; the log, one per output value.
"""

import math

from benchmark.common import H100_F32_FLOPS, k1_work
from benchmark.reference.fdlp import geometry, mel_filterbank


def window_flops(fe):
    srate, fdur, nb = fe["srate"], fe["fduration"], fe["nfilters"]
    N = int(srate * fdur)
    g = geometry(fe)
    fb = mel_filterbank(nb, int(2 * fdur * srate), srate,
                        float(fe["fbank_type"].split(",")[1]))[:, :-1]
    support = int((fb != 0).sum())
    kk = g["kk"]
    lpc, _ = k1_work(nb, fe["order"], fe["coeff_num"])
    return (N + 2.5 * N * math.log2(N) + 2 * support * (fe["order"] + 2) + lpc
            + nb * (2 * fe["coeff_num"] * kk + 2 * kk + kk))


def read(run):
    f = run.facts
    seconds = sum(f.get("pass_s", [])[run.traced_units:])
    if not f.get("pass_windows") or not seconds:
        return None
    fe = run.config["frontend"]
    per_pass = (window_flops(fe) * sum(f["pass_windows"])
                + fe["nfilters"] * sum(f["pass_frames"]))
    passes = len(f["pass_s"]) - run.traced_units
    return 100.0 * passes * per_pass / seconds / H100_F32_FLOPS
