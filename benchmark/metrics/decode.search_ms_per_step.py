"""Milliseconds a beam-search step takes: the benchmark's span around
`beam_search_encoded` (synchronised at both ends in the traced run),
summed over the window's batches after the profiled ones, over the steps
they ran."""


def read(run):
    spans = run.spans.get("decode.search")
    if not spans:
        return None
    steps = sum(run.facts["steps"][run.traced_units:])
    return 1e3 * sum(spans) / steps if steps else None
