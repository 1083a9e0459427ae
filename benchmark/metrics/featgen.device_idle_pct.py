"""Share of the traced window in which no device activity ran: the
device-only profiler trace of the window's first units of work (the
cell's trace_units batches, steps or passes)."""

from benchmark.tracing import idle_pct


def read(run):
    return idle_pct(run.trace)
