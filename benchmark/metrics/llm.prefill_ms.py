"""Milliseconds a batch's prefill takes: the benchmark's span around
`SpeechLLM.decode_init_cache` (one prefill of the batch's audio prefixes
and the latent cache expanded to the beams; synchronised at both ends in
the traced run), the mean over the window's batches after the profiled
ones. None where no prefill ran (a cell without the speech LLM)."""


def read(run):
    spans = run.spans.get("llm.prefill")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
