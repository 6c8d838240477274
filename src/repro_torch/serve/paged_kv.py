"""Slot resource pools for the continuous-batching serving engine.

Port of ``repro.serve.paged_kv``. Every layer gets a slot resource pool,
of one of two kinds by layer kind:

* **Block-paged KV** (``attn`` layers): ``(n_pages, page_size,
  kv_heads, head_dim)`` K and V pages shared by every request slot, mapped
  onto each request's logical context through a per-slot **page table**
  ``(capacity, max_pages)``: logical page ``p`` of a slot covers absolute
  positions ``[p*page_size, (p+1)*page_size)``. Int8-KV configs store int8
  pages plus per-(page, offset, head) f32 scales
  (``attention.init_paged_kv``).
* **Slot-indexed recurrent state** (``rglru`` / ``rwkv`` layers): state
  tensors with a leading ``capacity`` axis, slot ``i``'s state at index
  ``i``. No paging: recurrent state is O(1) per slot whatever the
  context length.

Both kinds coexist in one tree for hybrid block patterns (recurrentgemma's
2:1 RG-LRU : attention), which mirrors ``Model.init_cache``: the layers of
the repeated block pattern are stacked under ``"layers"`` (leading
``n_super`` axis), the remainder under ``"rem"``.

Page allocation is host-side (``PageAllocator``, a refcounted free list);
the step only consumes the page table. Page 0 is reserved as the trash
page: masked-out token writes land there, and unallocated page-table
entries point at it (their reads are masked by the causal-by-absolute-
position mask of ``models.attention.paged_attention``).

Where the reference returns new pools (``copy_page``, ``zero_state_slots``),
the port updates the pool tensors in place and returns the same tree: the
reference donates the pools to its jitted step for the same effect.
"""
from __future__ import annotations

import torch

from repro_torch.core.metrics import tree_leaves
from repro_torch.models import attention, rglru, rwkv6
from repro_torch.models.transformer import KINDS, layer_kinds
from repro_torch.obs.metrics import NULL_REGISTRY

# pool-subtree keys holding slot-indexed recurrent state (vs "attn" pages)
_STATE_KEYS = ("rec", "tm", "cm")


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages covering a context of ``n_tokens`` positions."""
    return -(-int(n_tokens) // int(page_size))


def unsupported_kinds(model) -> list[str]:
    """Layer kinds of the model outside the engine's pool coverage."""
    return sorted(set(layer_kinds(model.cfg)) - set(KINDS))


def _layer_pools(cfg, kind: str, n_pages: int, page_size: int, dtype,
                 capacity: int, device) -> dict:
    if kind == "attn":
        return {"attn": attention.init_paged_kv(cfg, n_pages, page_size,
                                                dtype, device)}
    if kind == "rglru":
        return {"rec": rglru.init_rglru_state(cfg, capacity, dtype, device)}
    if kind == "rwkv":
        return rwkv6.init_rwkv_state(cfg, capacity, device)
    raise NotImplementedError(
        f"layer kind {kind!r} has no slot resource pool: the engine covers "
        "attn/rglru/rwkv; use the sequential serving path (launch/serve "
        "without --engine)")


def init_paged_cache(model, n_pages: int, page_size: int, dtype=None, *,
                     capacity: int = 1) -> dict:
    """Slot resource pool tree of ``model`` on its device.

    Mirrors ``Model.init_cache``'s tree with each attention layer's ring
    buffer replaced by a ``(n_pages, page_size, kv, hd)`` page pool and
    each recurrent layer's state by a ``capacity``-slot state pool (the
    engine's slot-batch size). One page table indexes every attention
    layer's pool identically, so the engine allocates pages once per
    request, not per layer."""
    cfg = model.cfg
    dtype = dtype or model.cdt
    dev = model.device

    def stacked(kind):
        one = _layer_pools(cfg, kind, n_pages, page_size, dtype, capacity,
                           "meta")
        return {sub: {leaf: torch.zeros((cfg.n_super_blocks,) + t.shape,
                                        dtype=t.dtype, device=dev)
                      for leaf, t in tree.items()}
                for sub, tree in one.items()}

    pools = {"layers": {f"b{i}_{kind}": stacked(kind)
                        for i, kind in enumerate(cfg.block_pattern)}}
    rem = cfg.remainder_pattern
    if rem:
        pools["rem"] = {f"r{i}_{kind}": _layer_pools(cfg, kind, n_pages,
                                                     page_size, dtype,
                                                     capacity, dev)
                        for i, kind in enumerate(rem)}
    return pools


def paged_cache_bytes(pools) -> int:
    """Total bytes of the slot resource pools (all layers, both kinds)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(pools))


def slot_resource_bytes(pools) -> dict:
    """Byte split of the pool tree by resource kind: paged KV pools (the
    ``"attn"`` subtrees, scales included) vs slot-indexed recurrent state
    (the ``"rec"``/``"tm"``/``"cm"`` subtrees). The two sum to
    ``paged_cache_bytes(pools)``."""
    split = {"kv_page_bytes": 0, "state_slot_bytes": 0}
    for group in ("layers", "rem"):
        for layer in (pools.get(group) or {}).values():
            for key, sub in layer.items():
                kind = "kv_page_bytes" if key == "attn" else "state_slot_bytes"
                split[kind] += paged_cache_bytes(sub)
    return split


def _group_leaves(pools, keys):
    """(leaf, lead) for every leaf under a subtree named in ``keys``;
    ``lead`` is 1 in the stacked ``"layers"`` group, 0 in ``"rem"``."""
    for group, lead in (("layers", 1), ("rem", 0)):
        for layer in (pools.get(group) or {}).values():
            for key, sub in layer.items():
                if key in keys:
                    for leaf in tree_leaves(sub):
                        yield leaf, lead


def zero_state_slots(pools, mask):
    """Zero, in place, the recurrent state of the slots selected by
    ``mask`` ((capacity,) bool): a finished request's state must not be
    readable by the slot's next occupant. Touches only the state-pool
    subtrees; paged KV pages are recycled through the page allocator."""
    slots = torch.as_tensor(mask, dtype=torch.bool).cpu().nonzero()[:, 0]
    idx = {}                                # one host-to-device copy
    for leaf, lead in _group_leaves(pools, _STATE_KEYS):
        if leaf.device not in idx:
            idx[leaf.device] = slots.to(leaf.device)
        leaf.index_fill_(lead, idx[leaf.device], 0)
    return pools


def copy_page(pools, src: int, dst: int):
    """Copy page ``src`` onto page ``dst``, in place, in every attention
    pool leaf (K, V and int8 scales): the copy-on-write step behind
    prefix-cache hits that end mid-page. The new request maps the cached
    full pages read-only and gets a private copy of the partially matching
    boundary page, which its own prefill then overwrites from the
    divergence point."""
    for leaf, lead in _group_leaves(pools, ("attn",)):
        if lead == 0:
            leaf[dst] = leaf[src]
        else:
            leaf[:, dst] = leaf[:, src]
    return pools


class PageAllocator:
    """Host-side refcounted free-list page allocator. Page 0 is reserved
    (trash page) and can never be allocated, shared, or freed.

    ``alloc(n)`` pops ``n`` page ids (lowest-numbered first — keeps page
    tables dense and reproducible) at refcount 1, or raises ``MemoryError``
    without allocating anything. Pages are shared by ``incref`` (the prefix
    cache maps one physical page into many requests' page tables — and
    holds its own reference so cached pages survive their writer) and
    released by ``free``: a page returns to the free list only
    when its last owner lets go. ``refcount`` is the test suite's invariant
    hook: at every tick it must equal the number of distinct owners (slot
    page tables + radix-tree nodes + in-flight COW sources).
    """

    def __init__(self, n_pages: int, metrics=NULL_REGISTRY):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is reserved), "
                             f"got {n_pages}")
        self.n_pages = int(n_pages)
        # descending so .pop() hands out the lowest id first
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._rc: dict[int, int] = {}      # page -> refcount (allocated only)
        self._m_in_use = metrics.gauge(
            "repro_pages_in_use", "KV pages currently allocated")
        self._m_free = metrics.gauge(
            "repro_pages_free", "KV pages on the free list")
        self._m_allocs = metrics.counter(
            "repro_page_allocs_total", "pages handed out by alloc()")
        self._m_frees = metrics.counter(
            "repro_page_frees_total", "pages returned to the free list")
        self._m_free.set(len(self._free))
        self._m_in_use.set(0)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def _sync_gauges(self) -> None:
        self._m_free.set(len(self._free))
        self._m_in_use.set(self.n_pages - 1 - len(self._free))

    def refcount(self, page: int) -> int:
        return self._rc.get(int(page), 0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"requested {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        if pages:
            self._m_allocs.inc(len(pages))
            self._sync_gauges()
        return pages

    def incref(self, page: int) -> None:
        p = int(page)
        if p not in self._rc:
            raise ValueError(f"incref on unallocated page {p}")
        self._rc[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; the last owner returns it to the
        free list. Freeing an unallocated (or trash) page is an error."""
        returned = 0
        for p in pages:
            p = int(p)
            if not 0 < p < self.n_pages:
                raise ValueError(f"page {p} is not an allocatable page")
            rc = self._rc.get(p)
            if rc is None:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
                returned += 1
            else:
                self._rc[p] = rc - 1
        if returned:
            self._m_frees.inc(returned)
            self._sync_gauges()
