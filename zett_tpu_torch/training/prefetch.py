"""The train loop's batch prefetcher (counterpart of ``_DevicePrefetcher``,
``zett_tpu/training/engine.py:46-116``).

A background thread pulls the next host batches (the collate), pins them,
copies them to the card on a side CUDA stream and records an event after
the copy, while the loop runs the current step. The loop's stream waits on
that event before it reads a batch, and every device tensor of the batch is
``record_stream``-ed on the loop's stream so the caching allocator does not
hand its memory to another tensor while the step may still read it. On the
CPU the thread collates and converts, with no stream.

The thread pulls only the items its source yields, in order, so a run with
prefetch consumes the same batches as one without. Under more than one
rank the trainer does not use it: every rank pulls its batch in lockstep
with the step, as the JAX trainer does across hosts (``engine.py:722-728``;
the collective step is the barrier). An exception in the
thread is raised again in the loop by ``__next__``; nothing falls back to
an inline pull.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

JOIN_TIMEOUT_S = 30.0


class BatchPrefetcher:
    """Iterates ``(*head, host_batch, device_batch)`` for each
    ``(*head, host_batch)`` of ``items``, at most ``depth`` items ahead of
    the consumer. ``to_device(host_batch, pin)`` builds the device batch
    (a dict of tensors); ``close()`` stops and joins the thread."""

    _END = object()

    def __init__(self, items: Iterable[Tuple[Any, ...]],
                 to_device: Callable[[Dict[str, Any], bool], Dict[str, torch.Tensor]],
                 device, depth: int = 2):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(items, to_device),
                                        daemon=True, name="zett-batch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocks until ``item`` is queued or ``close()`` asks to stop."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, items, to_device):
        try:
            for item in items:
                if self._stop.is_set():
                    return
                *head, batch = item
                event = None
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        dev = to_device(batch, True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                else:
                    dev = to_device(batch, False)
                if not self._put((*head, batch, dev, event)):
                    return
            self._put(self._END)
        except BaseException as exc:  # noqa: BLE001 — raised again in the loop
            self._put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._q.put(self._END)  # a later call stops again
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        *head, batch, dev, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in dev.values():
                t.record_stream(stream)
        return (*head, batch, dev)

    def close(self) -> None:
        """Sets the stop flag, then drains the queue while joining, so a
        thread blocked on a full queue or inside a pull sees the flag; gives
        up after ``JOIN_TIMEOUT_S`` with a warning."""
        self._stop.set()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "the batch-prefetch thread is still inside a pull after %.0f s", JOIN_TIMEOUT_S)
