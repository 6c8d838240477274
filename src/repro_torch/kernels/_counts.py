"""Launch counters that stay exact when several threads launch kernels.

Each wrapper module keeps a dict of counts (``ops.launches``); ``bump``
adds one to each key under a lock shared by all of them, so the
read-modify-write of two threads (router replicas, each on its own stream)
cannot lose an increment. The lock costs well under a microsecond, against
several for the launch it counts.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()


def bump(counts: dict, *keys: str) -> None:
    with _LOCK:
        for k in keys:
            counts[k] += 1


def reset(*counts: dict) -> None:
    with _LOCK:
        for c in counts:
            for k in c:
                c[k] = 0
