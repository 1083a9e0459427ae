"""kernels.register_report on the `-Xptxas -v` build logs of the port's
three kernels, as nvcc 12.8 wrote them on an H100's machine
(tests/data/ptxas/<name>.log): one entry per compiled entry function, with
its template arguments, registers, stack and spill bytes."""

import os

import pytest

from speech_recognition_tools_tpu_torch import kernels

LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ptxas")


def _entries(name):
    if name == "lpc_cepstra":
        lanes, chunks = kernels.instantiations()
        return {("lpc_cepstra_kernel", (n, c)) for n in lanes for c in chunks}
    if name == "ctc_prefix":
        return {("ctc_prefix_kernel", ())}
    return {(k, cfg) for k in ("gru_fwd_kernel", "gru_bwd_kernel") for cfg in kernels.gru_configs()}


# (entry function, template) -> (registers, stack bytes), as the logs say
READINGS = {
    "lpc_cepstra": {("lpc_cepstra_kernel", (1, 4)): (31, 0),
                    ("lpc_cepstra_kernel", (16, 40)): (174, 0)},
    "ctc_prefix": {("ctc_prefix_kernel", ()): (125, 0)},
    "gru_scan": {("gru_fwd_kernel", (1, 6, True)): (168, 0),
                 ("gru_bwd_kernel", (1, 6, True)): (112, 16),
                 ("gru_bwd_kernel", (2, 8, False)): (146, 16)},
}


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_register_report_reads_each_kernels_build_log(name, tmp_path, monkeypatch):
    """Every instantiation the source names is reported once, sorted, with
    no spills; the report of a built library reads the log beside it."""
    with open(os.path.join(LOGS, f"{name}.log")) as f:
        log = f.read()
    report = kernels.register_report(name, log)
    assert [(d["kernel"], d["template"]) for d in report] == sorted(_entries(name))
    for d in report:
        assert set(d) == {"kernel", "template", "registers", "stack", "spill_stores",
                          "spill_loads"}
        assert 0 < d["registers"] <= 255 and d["spill_stores"] == d["spill_loads"] == 0
    got = {(d["kernel"], d["template"]): (d["registers"], d["stack"]) for d in report}
    assert {k: got[k] for k in READINGS[name]} == READINGS[name]

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    assert kernels.register_report(name) == []  # not built: no log
    with open(kernels.library_path(name) + ".log", "w") as f:
        f.write(log)
    assert kernels.register_report(name) == report
