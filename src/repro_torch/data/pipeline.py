"""Sharded data pipeline with host-side prefetch.

Wraps a batch source (``SyntheticLM`` here; a file-backed loader with the
same (step, shard)-pure interface plugs in the same way) and prefetches
ahead of the training loop on a background thread. Because batches are
pure functions of (step, shard), skip-ahead after a checkpoint restore is
O(1): just start asking for the restored step. Batches stay what the
source returns (int64 CPU tensors for ``SyntheticLM``); a train window
copies them into its static device buffers.

The port's ``SyntheticLM`` rows are pure in (seed, step, row), so the
pipeline passes the source its ``shard`` and no shard count.

``prefetch=0`` fetches each batch in the consumer's thread when it asks
for it, with no prefetch thread. The port's training CLI takes that: its
eager step is host-bound (PERF.md §5), and a prefetch thread's batch
making competes with the step's launches for the interpreter lock
(+2.3 % an eager CLI step and +1.5 % a graphed one on an NVIDIA H100
80GB HBM3 at 700 W, PERF.md), where making the batch before the step
costs ~2 ms of host time.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional


class Prefetcher:
    def __init__(self, fetch: Callable[[int], Any], start_step: int,
                 depth: int = 2):
        self._fetch = fetch
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next_step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next_step
        while not self._stop.is_set():
            try:
                item = (step, self._fetch(step))
            except Exception as e:  # surface loader errors to the consumer
                self._queue.put((step, e))
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self, expected_step: int) -> Any:
        step, item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        if step != expected_step:
            raise RuntimeError(f"pipeline out of sync: got {step}, "
                               f"expected {expected_step}")
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class DataPipeline:
    """Step-indexed, shard-aware pipeline with prefetch + skip-ahead."""

    def __init__(self, source, batch_size: int, seq_len: int,
                 shard: int = 0, prefetch: int = 2):
        self.source = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shard = shard
        self._prefetch_depth = prefetch
        self._prefetcher: Optional[Prefetcher] = None
        self._step = 0

    def _fetch(self, step: int):
        return self.source.batch(step, self.batch_size, self.seq_len,
                                 shard=self.shard)

    def start(self, step: int = 0):
        self.stop()
        self._step = step
        if self._prefetch_depth > 0:
            self._prefetcher = Prefetcher(self._fetch, step,
                                          depth=self._prefetch_depth)

    def next(self) -> Dict[str, Any]:
        if self._prefetch_depth == 0:
            batch = self._fetch(self._step)
        else:
            if self._prefetcher is None:
                self.start(self._step)
            batch = self._prefetcher.get(self._step)
        self._step += 1
        return batch

    def next_at(self, step: int) -> Dict[str, Any]:
        """Fetch THE batch for ``step`` — the consumer's step index is
        authoritative, not the pipeline's internal cursor. When they
        agree this is ``next()``; when they don't (a supervisor replay
        after a restore the pipeline didn't hear about) the prefetcher
        restarts at ``step`` so the replayed step re-reads exactly the
        batch it saw the first time. Batches are pure in (step, shard),
        so a resync costs one prefetch restart, never wrong data."""
        if self._step != step or (self._prefetch_depth > 0
                                  and self._prefetcher is None):
            self.start(step)
        return self.next()

    def skip_to(self, step: int):
        """O(1) skip-ahead (restore-from-checkpoint path)."""
        self.start(step)

    def stop(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
