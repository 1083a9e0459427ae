"""Host milliseconds a beam-search step spends in the LLM's latent
attention: the port's `llm.attn` spans directly under each step's
`search.decoder` (the cache write and the absorbed attention of every
layer; not the prefill's), over the steps of the profiled batches'
`search` spans. Host time, as `llm.moe_ms_per_step`.

None where the port recorded no `llm.attn` span."""

from benchmark import llm_spans


def read(run):
    return llm_spans.ms_per_step(run, "llm.attn")
