#!/usr/bin/env python3
"""Which collectives the gloo backend takes for CUDA tensors.

    python3 tools/gloo_cuda_probe.py      # one card; 2 ranks share it

Ranks that share a card cannot use NCCL, so a device mesh on one card
(``launch/mesh.py``) runs its collectives through gloo. This starts 2
ranks on ``cuda:0`` (a ``FileStore`` rendezvous, no TCP port), calls each
collective of ``torch.distributed`` the port could build on with CUDA
tensors of a few dtypes, and prints for each whether it ran and what it
returned; and whether torch has the fake process group a dry run would
use. It needs a CUDA card.
"""
from __future__ import annotations

import importlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _cases(t: torch.Tensor, world: int) -> list:
    dev = t.device

    def all_reduce(dtype=None, op=dist.ReduceOp.SUM):
        x = t.clone() if dtype is None else t.to(dtype)
        dist.all_reduce(x, op=op)
        return x.float().tolist()

    def all_gather(dtype=None):
        x = t if dtype is None else t.to(dtype)
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return [float(o[0]) for o in out]

    def all_gather_into_tensor():
        out = torch.empty(world * t.numel(), device=dev)
        dist.all_gather_into_tensor(out, t)
        return out.tolist()

    def broadcast():
        x = t.clone()
        dist.broadcast(x, 0)
        return x.tolist()

    def all_to_all_single():
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out.tolist()

    def reduce_scatter_tensor():
        out = torch.empty(t.numel() // world, device=dev)
        dist.reduce_scatter_tensor(out, t)
        return out.tolist()

    return [("all_reduce f32 sum", all_reduce),
            ("all_reduce f32 max", lambda: all_reduce(op=dist.ReduceOp.MAX)),
            ("all_reduce int32 sum", lambda: all_reduce(torch.int32)),
            ("all_reduce bf16 sum", lambda: all_reduce(torch.bfloat16)),
            ("all_gather f32", all_gather),
            ("all_gather bf16", lambda: all_gather(torch.bfloat16)),
            ("all_gather uint8", lambda: all_gather(torch.uint8)),
            ("all_gather_into_tensor f32", all_gather_into_tensor),
            ("broadcast f32", broadcast),
            ("all_to_all_single f32", all_to_all_single),
            ("reduce_scatter_tensor f32", reduce_scatter_tensor)]


def _rank(rank: int, store: str, results) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    t = torch.full((4,), float(rank + 1), device="cuda:0")
    out = {}
    for name, fn in _cases(t, WORLD):
        try:
            value = fn()
            torch.cuda.synchronize()
            out[name] = f"ok {value}"
        except Exception as e:            # report, then go on to the next
            out[name] = f"FAILED {type(e).__name__}: {str(e)[:160]}"
    if rank == 0:
        results.put(out)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {WORLD} ranks on cuda:0")
    fake_pg = "torch.testing._internal.distributed.fake_pg"
    try:        # the fake process group a dry run of 256 ranks would take
        importlib.import_module(fake_pg)
        print(f"{fake_pg}: present")
    except ImportError as e:
        print(f"{fake_pg}: missing ({e})")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(os.path.join(d, "store"), results),
                           nprocs=WORLD, start_method="spawn", join=True)
    for name, res in results.get().items():
        print(f"gloo, CUDA tensors, {name}: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
