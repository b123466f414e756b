"""Sharded host loader with background prefetch and exact resume.

A copy of the JAX package's ``data/loader.py`` (numpy only).

At 1000+ nodes the data pipeline must be (a) shardable by host without
coordination, (b) restartable to an exact step, (c) overlapped with
compute.  This loader achieves all three with a stateless design: the
underlying source maps ``step -> global batch`` deterministically; each
host slices its shard by ``host_id``; a small thread pool prefetches the
next ``prefetch`` steps while the current one trains.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class ShardedLoader:
    def __init__(
        self,
        batch_fn: Callable[[int], dict[str, np.ndarray]],
        *,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ) -> None:
        self._batch_fn = batch_fn
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = max(0, prefetch)

    def _shard(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            assert b % self.num_hosts == 0, (
                f"global batch {b} not divisible by {self.num_hosts} hosts")
            per = b // self.num_hosts
            out[k] = v[self.host_id * per:(self.host_id + 1) * per]
        return out

    def get(self, step: int) -> dict[str, np.ndarray]:
        """This host's shard of the global batch for ``step``."""
        return self._shard(self._batch_fn(step))

    def iterate(self, start_step: int, end_step: int | None = None
                ) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        """Prefetching iterator from ``start_step`` (exact resume point)."""
        if self.prefetch == 0:
            step = start_step
            while end_step is None or step < end_step:
                yield step, self.get(step)
                step += 1
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer() -> None:
            step = start_step
            while not stop.is_set() and (end_step is None or step < end_step):
                try:
                    q.put((step, self.get(step)), timeout=0.1)
                except queue.Full:
                    continue
                step += 1
            q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
