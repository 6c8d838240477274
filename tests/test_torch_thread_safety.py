"""What router replicas share across threads stays exact: the kernels'
launch counters, the profiler's call counts and sums, the kernel
library loader (one build, not one per thread), the head's rounded-table
memo and the tracer's track ids. Threads switch every microsecond here, so
an unguarded read-modify-write would lose counts."""
import os
import sys
import threading
import time

import pytest
import torch

from repro_torch.kernels import _build, _counts
from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops
from repro_torch.kernels.bsr_spmm import ops as spmm_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.prox_adam import ops as adam_ops
from repro_torch.models import layers
from repro_torch.obs.profile import Profiler
from repro_torch.obs.trace import Tracer

# at least 8 threads, and more than there are cores (an even count)
THREADS, N = max(8, (os.cpu_count() or 1) // 2 * 2 + 2), 10_000


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(fn, n=THREADS):
    start = threading.Barrier(n)

    def body(i):
        start.wait()
        fn(i)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("mod,key", [
    (spmm_ops, "spmm_t"), (sddmm_ops, "bsr_sddmm"),
    (paged_ops, "paged_flash_fwd"), (flash_ops, "flash_attention_fwd"),
    (adam_ops, "prox_adam")])
def test_launch_counters_exact(mod, key, fast_switching):
    mod.reset_launches()
    _run_threads(lambda i: [_counts.bump(mod.launches, key)
                            for _ in range(N)])
    assert mod.launches[key] == THREADS * N
    mod.reset_launches()
    assert mod.launches[key] == 0


def test_spmm_wrapper_and_variant_counters_exact(fast_switching):
    spmm_ops.reset_launches()
    kernels = spmm_ops.KERNELS
    _run_threads(lambda i: [spmm_ops._count("spmm", kernels[i % 2])
                            for _ in range(N)])
    assert spmm_ops.launches["spmm"] == THREADS * N
    assert [spmm_ops.variant_launches[f"spmm_{k}"] for k in kernels] == \
        [THREADS // 2 * N] * 2
    spmm_ops.reset_launches()


def test_profiler_counts_exact(fast_switching):
    x = torch.zeros(2)
    with Profiler() as p:
        _run_threads(lambda i: [p.call(f"k{i % 2}", torch.neg, x)
                                for _ in range(N)])
        _run_threads(lambda i: [p.wall_since("tick", time.perf_counter())
                                for _ in range(N // 10)])
    s = p.summary()
    assert s["k0"]["n_calls"] == s["k1"]["n_calls"] == THREADS // 2 * N
    assert s["tick"]["n_calls"] == THREADS * N // 10
    assert s["tick"]["total_ms"] >= s["tick"]["max_ms"] > 0


def test_library_load_builds_once(monkeypatch):
    """Threads that first call a kernel together run one build."""
    built = []

    def slow_build(names):
        built.append(names)
        time.sleep(0.05)
        return []

    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    libs = []
    _run_threads(lambda i: libs.append(_build.load("bsr_spmm")))
    assert built == [("bsr_spmm",)]
    assert len({id(lib) for lib in libs}) == 1


def test_rounded_head_memo_shared_and_exact(fast_switching):
    w = torch.randn(300, 40)
    outs = []
    _run_threads(lambda i: outs.append(
        layers._rounded_f32(w, torch.bfloat16)))
    assert len({id(o) for o in outs}) == 1
    assert torch.equal(outs[0], w.to(torch.bfloat16).float())
    w.add_(1.0)                               # a new version: a new memo
    assert torch.equal(layers._rounded_f32(w, torch.bfloat16),
                       w.to(torch.bfloat16).float())


def test_tracer_track_ids_unique(fast_switching):
    tracer = Tracer()
    _run_threads(lambda i: [tracer._tid(i * N + r) for r in range(200)])
    tids = list(tracer._tids.values())
    assert len(tids) == len(set(tids)) == THREADS * 200
