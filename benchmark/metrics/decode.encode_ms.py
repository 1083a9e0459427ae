"""Milliseconds the encoder takes a batch: the benchmark's span around
`TransformerASR.encode` (synchronised at both ends in the traced run),
the mean over the window's batches after the profiled ones."""


def read(run):
    spans = run.spans.get("decode.encode")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
