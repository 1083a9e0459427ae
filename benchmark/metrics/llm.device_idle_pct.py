"""Share of the traced window in which no device activity ran, in the
speech LLM's cell: the device-only profiler trace of the window's first
batch. None for a configuration without the LLM."""

from benchmark.tracing import idle_pct


def read(run):
    if "llm" not in run.config:
        return None
    return idle_pct(run.trace)
