"""The model's collectives on a rank mesh, and the per-pass views of a
rank's params.

A leaf dimension that the placement rules map to a mesh axis is either
*computed split* or *stored split*:

  * computed split: a projection's OUTPUT dim on "model" (``COMPUTED``
    names the leaves and dims). The rank keeps its slice, computes only
    its slice of the output (``col_parallel``), and the slices are
    all-gathered over the model group. The input's gradient is summed
    over the group in the backward, as Megatron's column-parallel layer
    does. A compressed leaf split by block rows over "model" is computed
    split too: the kernels run unchanged on the rank's shard.
  * stored split: any other split dim (FSDP's "embed" on "data", and a
    "model" dim that is a projection's input). The leaf is all-gathered
    before use. Over the batch axes the backward sums the gradient over
    the group before taking the rank's slice (the data-parallel reduction
    of that leaf); over "model" it takes the slice, every rank of the
    group having computed the same gradient. A compressed leaf split over
    the batch axes is joined whole (``sparse.formats.join_rows``).

``layer_view`` / ``stacked_view`` apply this to one layer's (or the
stacked layers') params for one pass, and mark each computed-split leaf
with the dim it is split on (``split_dim``); the call sites in
``models/`` read the mark. Activations are gathered, so attention, the
RG-LRU scan and the WKV scan run whole on every rank of a model group.

The collectives are all_gather and all_reduce, which gloo and NCCL both
take for CUDA tensors. None moves a tensor off its device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh, leaf_spec
from repro_torch.sparse.formats import is_bcsr, join_rows

Tensor = torch.Tensor

# leaf name -> the dims of its per-layer (unstacked) shape that are
# computed split when "model" takes them: projection outputs (dim 0 of an
# expert stack is the expert-parallel split of the MoE FFN)
COMPUTED = {
    "wq": (1,), "wk": (1,), "wv": (1,),
    "wi": (1,), "wg": (1,), "cm_k": (1,), "cm_r": (1,),
    "lru_in": (1,), "lru_gate": (1,),
    "rwkv_r": (1,), "rwkv_k": (1,), "rwkv_v": (1,), "rwkv_g": (1,),
    "head": (1,), "embedding": (0,),
    "ewi": (0, 2), "ewg": (0, 2), "ewo": (0,),
}
_MARK = "_repro_split"


def split_dim(w) -> Optional[int]:
    """The dim a computed-split leaf is split on over "model", or None."""
    return getattr(w, _MARK, None)


def _mark(w, dim: int):
    object.__setattr__(w, _MARK, dim)
    return w


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_gather_list(t: Tensor, group) -> list:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_gather_cat(t: Tensor, dim: int, group) -> Tensor:
    return torch.cat(all_gather_list(t, group), dim)


def _own_slice(g: Tensor, dim: int, group) -> Tensor:
    n = dist.get_world_size(group)
    return g.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice,
    summing the gradient over the group first where ``reduce``."""

    @staticmethod
    def forward(ctx, t, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.reduce:
            dist.all_reduce(g, group=ctx.group)
        return _own_slice(g, ctx.dim, ctx.group), None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    """Sum over the group; the backward passes the gradient, which every
    rank of the group holds whole."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    """Mean over the group, forward and backward (its own adjoint)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def _group(mesh, axes):
    return mesh.group((axes,) if isinstance(axes, str) else tuple(axes))


def _over_batch(mesh, axes) -> bool:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return any(a in mesh.batch_axes for a in axes)


def gather(t: Tensor, dim: int, axes, mesh=None) -> Tensor:
    """A stored-split tensor gathered along ``dim`` over ``axes``
    (differentiable; see the module docstring for its backward)."""
    mesh = mesh or current_mesh()
    if mesh.axis_size(axes) == 1:
        return t
    return _Gather.apply(t, dim, _group(mesh, axes), _over_batch(mesh, axes))


def model_group(mesh=None):
    mesh = mesh or current_mesh()
    return mesh.group("model")


def model_index(mesh=None) -> int:
    mesh = mesh or current_mesh()
    return mesh.coords.get("model", 0)


def col_parallel(x: Tensor, fn, dim: int = -1) -> Tensor:
    """``fn(x)`` computed split over "model": ``fn`` gives this rank's
    slice of the output, and the slices are gathered along ``dim``."""
    mesh = current_mesh()
    g = model_group(mesh)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _SumGrad.apply(x, g)
    y = fn(x)
    dim = dim % y.dim()
    if torch.is_grad_enabled() and y.requires_grad:
        return _Gather.apply(y, dim, g, False)
    return all_gather_cat(y, dim, g)


def sum_model(t: Tensor) -> Tensor:
    """Sum of ``t`` over the model group (an expert-parallel FFN's output;
    a vocab-split embedding's rows)."""
    return _Sum.apply(t, model_group())


def sum_grad_model(t: Tensor) -> Tensor:
    """``t`` whose gradient is summed over the model group."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumGrad.apply(t, model_group())
    return t


@contextlib.contextmanager
def data_parallel(on: bool = True):
    """Declare that the passes run inside hold only this data
    coordinate's rows of the batch (``on``), or the whole batch."""
    mesh = current_mesh()
    if mesh is None:
        yield
        return
    prev, mesh.batch_split = mesh.batch_split, on
    try:
        yield
    finally:
        mesh.batch_split = prev


def batch_split() -> bool:
    """Whether the running pass holds one data shard's rows of a batch
    split over more than one."""
    mesh = current_mesh()
    return (mesh is not None and mesh.batch_split
            and mesh.axis_size(mesh.batch_axes) > 1)


def whole_batch():
    return data_parallel(False)


def mean_batch(t: Tensor) -> Tensor:
    """Mean of ``t`` over the batch shards (the aux losses' statistics);
    ``t`` itself where the batch is not split."""
    if not batch_split():
        return t
    return _Mean.apply(t, current_mesh().groups["batch"])


def gather_batch(t: Tensor) -> Tensor:
    """Rows of every batch shard along dim 0 (differentiable: the backward
    sums over the batch group, then takes this rank's rows)."""
    if not batch_split():
        return t
    return _Gather.apply(t, 0, current_mesh().groups["batch"], True)


def batch_rows(t: Tensor, mesh=None) -> Tensor:
    """This data coordinate's rows of a tensor every rank holds whole."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return t
    n = mesh.axis_size(mesh.batch_axes)
    return t.chunk(n, 0)[mesh.axis_index(mesh.batch_axes)]


# ---------------------------------------------------------------------------
# Per-pass views of a rank's params
# ---------------------------------------------------------------------------

def _join(m, axes, mesh, path: str):
    """A compressed leaf split by block rows over ``axes``, joined whole
    for this pass: the block store gathered (differentiably), the tables
    those ``shard_params`` joined when it split the leaf (a store's tables
    never change)."""
    name = "codes" if hasattr(m, "codes") else "data"
    store, group = getattr(m, name), _group(mesh, axes)
    if torch.is_grad_enabled() and store.requires_grad:
        parts = _Gather.apply(store.unsqueeze(0), 0, group,
                              _over_batch(mesh, axes)).unbind(0)
    else:
        parts = all_gather_list(store, group)
    shards = [dataclasses.replace(m, **{name: p}) for p in parts]
    return join_rows(shards, mesh.layout[("joined", path)])


def _dense_view(t: Tensor, spec: tuple, name: str, mesh) -> Tensor:
    computed = COMPUTED.get(name, ())
    mark = None
    for i, axes in enumerate(spec):
        if axes is None or mesh.axis_size(axes) == 1:
            continue
        if axes == "model" and i in computed:
            mark = i
            continue
        t = gather(t, i, axes, mesh)
    return t if mark is None else _mark(t, mark)


def _bcsr_view(m, axes, mesh, path: str):
    if axes is None or mesh.axis_size(axes) == 1:
        return m
    if axes == "model":
        return _mark(dataclasses.replace(m), 0)
    return _join(m, axes, mesh, path)


def layer_view(tree, path: str, mesh=None, stacked: bool = False):
    """One layer's params (a dict, or a compressed leaf) for one pass,
    ``path`` its place in the rank's tree ("layers/b0_attn" for a slice of
    the stacked layers, with ``stacked``). Stored-split dims are gathered,
    computed-split leaves are marked."""
    mesh = mesh or current_mesh()
    if mesh is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: layer_view(v, f"{path}/{k}", mesh, stacked)
                for k, v in tree.items()}
    if is_bcsr(tree):
        axes = mesh.layout.get(("bcsr", path))
        if stacked and axes != "model":
            return tree     # joined whole before the layers were unbound
        return _bcsr_view(tree, axes, mesh, path)
    if not isinstance(tree, Tensor):
        return tree
    name = path.rsplit("/", 1)[-1]
    if stacked:
        spec = leaf_spec(mesh, path, tree.unsqueeze(0))[1:]
    else:
        spec = leaf_spec(mesh, path, tree)
    return _dense_view(tree, spec, name, mesh)


def stacked_view(tree, path: str, mesh=None):
    """The stacked layers' params before they are unbound: a split of the
    layer axis is gathered, and compressed leaves split over the batch
    axes are joined."""
    mesh = mesh or current_mesh()
    if mesh is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: stacked_view(v, f"{path}/{k}", mesh)
                for k, v in tree.items()}
    if is_bcsr(tree):
        axes = mesh.layout.get(("bcsr", path))
        if axes in (None, "model") or mesh.axis_size(axes) == 1:
            return tree
        return _join(tree, axes, mesh, path)
    if not isinstance(tree, Tensor):
        return tree
    spec = leaf_spec(mesh, path, tree)
    if spec and spec[0] is not None:
        tree = gather(tree, 0, spec[0], mesh)
    return tree
