"""Share of the beam search's steps replayed as one CUDA graph: 100 x
`beam_search_encoded.graph_steps` / `beam_search_encoded.steps`, the
port's own counters (decode/beam_jit.py) over every search of the run,
set-up's two-step warm-up searches included (their first steps run eagerly
and capture the graphs the window replays). The engagement share of the
graphed step. None where the port keeps no such counters."""


def read(run):
    from speech_recognition_tools_tpu_torch.decode import beam_jit

    search = beam_jit.beam_search_encoded
    steps = getattr(search, "steps", None)
    graph_steps = getattr(search, "graph_steps", None)
    if not steps or graph_steps is None:
        return None
    return 100.0 * graph_steps / steps
