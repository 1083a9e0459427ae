"""K1's share of its roofline on the H100 in the traced passes: the least
time the card could take for the LPC -> cepstrum rows of the valid
analysis windows (common.py::k1_work, a frozen copy of chip_smoke.py's:
the larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s), over
the device time of the kernels named below in the trace. The padded
windows a batch also solves are not counted as needed work."""

from benchmark.common import k1_bound_s

KERNELS = ("lpc_cepstra",)


def read(run):
    t = run.trace
    f = run.facts
    if not t or not f.get("pass_windows"):
        return None
    kernel_s = sum(s for name, s in t["by_name"].items() if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    fe = run.config["frontend"]
    traced_passes = min(run.cell.get("trace_units", 1), f["passes"])
    rows = traced_passes * sum(f["pass_windows"]) * fe["nfilters"]
    return 100.0 * k1_bound_s(rows, fe["order"], fe["coeff_num"]) / kernel_s
