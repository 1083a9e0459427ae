"""Milliseconds the streaming front-end takes a 0.25 s message: the
benchmark's span around `StreamingFdlp.process` of each connection
(synchronised at both ends in the traced run), the mean over the
window's messages after its profiled seconds."""


def read(run):
    spans = run.spans.get("stream.featgen")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
