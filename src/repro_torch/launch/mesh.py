"""Device meshes over ``torch.distributed`` ranks.

Port of ``repro.launch.mesh``. A mesh is one process per rank: rank
``r`` of a ("data", "model") mesh of shape (D, M) sits at data coordinate
``r // M`` and model coordinate ``r % M`` (the row-major order of the
reference's ``jax.make_mesh``). Each rank holds one process group per
axis (the ranks that differ from it only along that axis) and one over
the batch axes ("pod", "data").

    make_host_mesh(data, model)   a (data, model) mesh over the ranks of
                                  the initialised process group
    make_production_mesh(multi)   (16, 16) = 256 ranks, or
                                  (2, 16, 16) = 512 with multi_pod
    mesh_from_flag(spec)          a CLI ``--mesh`` value as a mesh
    run_ranks(fn, world, device)  ``fn(*args)`` on ``world`` ranks: joins
                                  the group of ``torchrun`` where its
                                  environment is set, else spawns the
                                  ranks with a ``FileStore`` rendezvous
    launch(spec, fn, device)      the launchers' ``--mesh``: run_ranks
                                  for the flag's mesh

Rank ``r`` runs on ``cuda:(local_rank % device_count)``, or the CPU when
asked. The backend is chosen by rule (``pick_backend``): NCCL where every
rank has a card of its own, gloo where ranks share a card or run on the
CPU (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

# how long a rank waits in the rendezvous or in a collective before it
# raises, so that a rank that died cannot leave the others hanging
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a device mesh.

    ``shape`` maps axis name to size in axis order, as the reference's
    ``Mesh.shape``; ``coords`` this rank's index on each axis;
    ``groups`` a process group per axis and one under the key "batch"
    over the batch axes ("pod", "data"); ``layout`` the placement
    ``distributed.sharding.shard_params`` recorded, by leaf path."""
    shape: dict
    rank: int
    coords: dict
    groups: dict
    device: torch.device
    backend: str
    layout: dict = dataclasses.field(default_factory=dict)
    # whether the pass running holds only this data coordinate's rows of
    # the batch (``distributed.parallel.data_parallel``)
    batch_split: bool = False

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in ("pod", "data") if a in self.shape)

    def group(self, axes):
        """The process group over ``axes``: one axis, or the batch axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == self.batch_axes:
            return self.groups["batch"]
        if len(axes) == 1:
            return self.groups[axes[0]]
        raise ValueError(f"no process group over {axes}")


def pick_backend(device: torch.device, world: int) -> str:
    """NCCL where every rank has a card of its own; gloo where ranks share
    a card or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """``cuda:(local_rank % device_count)`` for a CUDA device, else the
    device as given. A CUDA device without a visible card raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass --device cpu to "
                           "run the mesh on the CPU")
    dev = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(dev)
    return dev


def _build(shape: dict, device: torch.device) -> Optional[Mesh]:
    """The groups of a mesh of ``shape`` over the first ranks of the
    initialised process group, as the reference takes the first devices
    (every rank creates every group, in the same order; a rank outside
    the mesh gets None)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = 1
    for s in shape.values():
        n *= s
    if n > world:
        raise SystemExit(f"mesh {tuple(shape.values())} needs {n} devices "
                         f"but only {world} present")
    world = n
    names = tuple(shape)
    sizes = tuple(shape.values())
    coords, rest = {}, rank
    for a, s in zip(reversed(names), reversed(sizes)):
        coords[a] = rest % s
        rest //= s
    coords = {a: coords[a] for a in names}

    def ranks_along(axes) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes``."""
        out: dict = {}
        for r in range(world):
            c, rr = {}, r
            for a, s in zip(reversed(names), reversed(sizes)):
                c[a] = rr % s
                rr //= s
            key = tuple(c[a] for a in names if a not in axes)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out)]

    groups = {}
    batch = tuple(a for a in ("pod", "data") if a in shape)
    for key, axes in [(a, (a,)) for a in names] + [("batch", batch)]:
        for members in ranks_along(axes):
            g = dist.new_group(members, timeout=TIMEOUT)
            if rank in members:
                groups[key] = g
    if rank >= n:
        return None
    return Mesh(shape=dict(shape), rank=rank, coords=coords, groups=groups,
                device=device, backend=dist.get_backend())


# the device ``init_rank`` gave this process
_DEVICE: list = [torch.device("cpu")]


def make_host_mesh(data: int = 1, model: int = 1) -> Optional[Mesh]:
    """A (data, model) mesh over the first data * model ranks of the
    initialised group (None on the ranks past them)."""
    return _build({"data": data, "model": model}, _DEVICE[0])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod:
    (pod=2, data=16, model=16) = 512 ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    n = 1
    for s in shape.values():
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {tuple(shape.values())} needs {n} devices but only {have} "
            "present; start one rank per device (torchrun --nproc-per-node, "
            "across hosts) before building the production mesh")
    return _build(shape, _DEVICE[0])


def parse_mesh_flag(spec: Optional[str]) -> Optional[tuple]:
    """The (data, model) of a ``--mesh`` flag, None for 'none', the
    production shapes for 'single' / 'multi'."""
    if spec in (None, "", "none"):
        return None
    if spec == "single":
        return (16, 16)
    if spec == "multi":
        return (2, 16, 16)
    try:
        data, model = (int(t) for t in spec.split(","))
    except ValueError:
        raise SystemExit(
            f"--mesh must be none|single|multi|DATA,MODEL — got {spec!r}")
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh {spec}: axis sizes must be >= 1")
    return (data, model)


def mesh_from_flag(spec: Optional[str]) -> Optional[Mesh]:
    """Resolve a CLI ``--mesh`` flag to a Mesh (or None).

    'none'   -> no mesh (one process),
    'single' -> production (data=16, model=16) pod,
    'multi'  -> production (pod=2, data=16, model=16),
    'D,M'    -> host mesh (data=D, model=M) over the ranks of the
                initialised process group (``run_ranks`` starts them)."""
    shape = parse_mesh_flag(spec)
    if shape is None:
        return None
    if spec == "single":
        return make_production_mesh()
    if spec == "multi":
        return make_production_mesh(multi_pod=True)
    data, model = shape
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < data * model:
        raise SystemExit(
            f"--mesh {spec} needs {data * model} devices but only {have} "
            f"present; launch {data * model} ranks (the launchers spawn "
            "them for --mesh, or run under torchrun --nproc-per-node "
            f"{data * model})")
    return make_host_mesh(data, model)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------

def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def init_rank(rank: int, world: int, device, init_method: str,
              local_rank: Optional[int] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world``; returns the rank's
    device. The backend follows ``pick_backend``."""
    dev = rank_device(device, rank if local_rank is None else local_rank)
    backend = pick_backend(dev, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT, **kw)
    _DEVICE[0] = dev
    if dev.type == "cpu":
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    return dev


def _spawned(rank: int, world: int, store: str, device, fn, args):
    init_rank(rank, world, device, f"file://{store}")
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, device, args: tuple = (),
              timeout: Optional[float] = None, store_dir=None):
    """Run ``fn(*args)`` on ``world`` ranks.

    Under ``torchrun`` this process is one rank: it joins from the
    environment and runs ``fn``. Otherwise it spawns ``world`` processes
    that meet at a ``FileStore`` in a fresh temporary directory (no TCP
    port, so concurrent runs cannot collide). A rank that raises takes the
    whole group down and this call raises; so do ranks still running after
    ``timeout`` seconds, which are stopped. The store's directory is made
    under ``store_dir`` (default: the system's temporary directory). A
    process that is already a rank of a group of ``world`` ranks runs
    ``fn`` itself and returns its result."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise SystemExit(f"the process group has "
                             f"{dist.get_world_size()} ranks but the mesh "
                             f"needs {world}")
        return fn(*args)
    if under_torchrun():
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks but the mesh needs {world}")
        init_rank(rank, world, device, "env://",
                  local_rank=int(os.environ["LOCAL_RANK"]))
        try:
            fn(*args)
        finally:
            dist.destroy_process_group()
        return
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_mesh_", dir=store_dir) as d:
        ctx = mp.start_processes(_spawned, args=(
            world, os.path.join(d, "store"), str(device), fn, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s; stopped")


def require_ranks(spec: str) -> None:
    """Exit with the reference's error for a production mesh whose ranks
    were not started (one host never spawns 256 or 512)."""
    if spec in ("single", "multi") and not dist.is_initialized() \
            and not under_torchrun():
        mesh_from_flag(spec)                # raises: too few devices


def launch(spec: str, fn: Callable, device, args: tuple = ()):
    """``fn(*args, mesh)`` under ``distributed.sharding.use_mesh(mesh)`` on
    every rank of the ``--mesh`` flag ``spec``: spawned here for 'D,M',
    joined under ``torchrun`` or an initialised group. Rank 0 prints the
    mesh and its backend first; the other ranks print nothing. The
    production meshes ('single', 'multi') are never spawned on one host:
    without their ranks started they exit with the reference's error."""
    shape = parse_mesh_flag(spec)
    require_ranks(spec)
    n = 1
    for s in shape:
        n *= s
    return run_ranks(_on_rank, n, device, (spec, fn, args))


def _on_rank(spec: str, fn: Callable, args: tuple):
    from repro_torch.distributed.sharding import use_mesh
    if not is_main_rank():
        sys.stdout = open(os.devnull, "w")
    mesh = mesh_from_flag(spec)
    if mesh is None:            # a rank past a mesh smaller than the group
        return None
    print(f"mesh {spec}: {mesh.size} ranks ({mesh.backend}), rank 0 on "
          f"{mesh.device}")
    with use_mesh(mesh):
        return fn(*args, mesh)


def is_main_rank() -> bool:
    """Rank 0, or the only process: the one that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0
