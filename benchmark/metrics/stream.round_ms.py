"""Milliseconds of the service lock's batcher work a scheduling round
takes: the benchmark's span around `StreamBatcher.push` (under the
service lock; synchronised at both ends in the traced run), summed over
the window after its profiled seconds, over the rounds the batcher counted
there (`StreamBatcher.rounds`).
The ticker's drains and the finals' flushes run rounds outside the span,
so this reads low where they are many."""


def read(run):
    spans = run.spans.get("stream.push")
    rounds = run.facts.get("rounds", 0) - run.facts.get("rounds_traced", 0)
    if not spans or not rounds:
        return None
    return 1e3 * sum(spans) / rounds
