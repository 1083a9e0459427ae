"""Host milliseconds a beam-search step spends in the LLM's expert layers:
the port's `llm.moe` spans directly under each step's `search.decoder`
(not the prefill's), over the steps of the profiled batches' `search`
spans. A step launches its work without waiting for the device, so this
is the time to route and launch the expert layers; the device trails it.

Read from the port's own spans (`utils/profiling.py::span`), which record
only while the profiler runs: the window's first `run.traced_units` units.
None where the port recorded no `llm.moe` span."""

from benchmark import llm_spans


def read(run):
    return llm_spans.ms_per_step(run, "llm.moe")
