"""Milliseconds a step spends loading: the benchmark's span around the
loader's move of a host batch to the device (`batch_on_device`, or
train_e2e's `torch.as_tensor` per array), synchronised at both ends in the
traced run, the mean over the window's steps after the profiled ones.
The egs reading and padding (`iter_egs_batches`) run between steps and
are in neither span."""


def read(run):
    spans = run.spans.get("train.load")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
