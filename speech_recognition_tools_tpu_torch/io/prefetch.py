"""Host-side async batch prefetching with device double-buffering.

Port of speech_recognition_tools_tpu/io/prefetch.py. The reference's
equivalent is torch DataLoader workers (--load_data_workers 10,
train_rnn_nnet_classifier.py:70). A background thread pulls batches from
the iterator, pins their host arrays and copies them to the card with
non_blocking=True on a side CUDA stream, so that the next batch's
host-to-device copy overlaps the current step's compute; the consumer's
stream waits on that copy's event before the batch is yielded. On the CPU
the batches are only converted to tensors.
"""

import queue
import threading

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import resolve_device

PARALLEL_ITEM = "ROADMAP Queue 1 item 5: the parallel paths"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def prefetch_to_device(iterator, size: int = 2, device="cuda", sharding=None):
    """Wrap a host batch iterator with async device prefetch.

    Args:
      iterator: yields pytrees (dicts, lists, tuples) of numpy arrays or
        tensors; other leaves pass through unchanged.
      size: prefetch depth (2 = double buffering).
      device: "cuda" (default) or "cpu".
      sharding: not yet ported (a sharded put needs the parallel layer);
        NotImplementedError if given.

    Yields the batches in order, their arrays as tensors on `device`. An
    exception raised by the iterator is raised on the consumer's side.
    """
    if sharding is not None:
        raise NotImplementedError(f"prefetch_to_device(sharding=...) is not yet ported "
                                  f"({PARALLEL_ITEM})")
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q = queue.Queue(maxsize=size)
    sentinel = object()

    def put(x):
        t = torch.as_tensor(x)
        if side is None:
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def producer():
        try:
            for batch in iterator:
                if side is None:
                    q.put((_tree_map(put, batch), None))
                    continue
                with torch.cuda.stream(side):
                    moved = _tree_map(put, batch)
                    done = torch.cuda.Event()
                    done.record(side)
                q.put((moved, done))
        except Exception as e:  # surface errors on the consumer side
            q.put((e, None))
            return
        q.put((sentinel, None))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item, done = q.get()
        if item is sentinel:
            return
        if isinstance(item, Exception):
            raise item
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            # the copies were allocated on the side stream: keep the
            # allocator from reusing them before the consumer is done
            _tree_map(lambda t: t.record_stream(consumer), item)
        yield item
