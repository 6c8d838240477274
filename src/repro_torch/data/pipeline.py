"""Host data pipeline: per-process sharded batches + background prefetch
(port of ``repro.data.pipeline``).

Each process feeds its shard of the global batch: ``ShardedBatcher``
computes the process's slice from (process_index, process_count), which
default to the data coordinate and data-parallel degree of the active
rank mesh (``distributed.sharding.use_mesh``), else to
``torch.distributed``'s rank and world size when a process group is
initialised, and to 0 / 1 otherwise. ``Prefetcher`` overlaps host
batch synthesis with device compute in a background thread. Batches stay
on the host, as the reference's do: the consumer moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch.distributed as dist

from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.distributed.sharding import current_mesh


def _process_grid() -> tuple[int, int]:
    """(shard index, shard count) of this process: its data coordinate
    under a rank mesh (the ranks of one model group feed the same rows),
    else its rank in the process group."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh.axis_index(mesh.batch_axes), mesh.axis_size(
            mesh.batch_axes)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedBatcher:
    """Deterministic per-process batch shards keyed by step (restart-safe)."""

    def __init__(self, cfg: TokenStreamConfig,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        rank, world = _process_grid()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if cfg.global_batch % self.process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {self.process_count} processes")
        self.host_size = cfg.global_batch // self.process_count
        self.host_start = self.process_index * self.host_size

    def batch(self, step: int) -> dict:
        return token_batch(self.cfg, step, self.host_start, self.host_size)

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded queue).
    Iterating yields (step, batch); ``close`` stops the thread."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, make_batch(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
