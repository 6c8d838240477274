"""The port's copy of ``repro.serve.prefix_cache`` (host-side, numpy only).

Radix-tree prefix cache over block-paged KV: requests that share a
prompt prefix share physical KV pages.

The engine gives every request slot a *page table* — a level of
indirection between logical context positions and physical KV pages. This
module exploits it: a full page's KV content is a pure function of the
``page_size`` token ids it covers (positions are absolute, weights fixed,
kernels deterministic), so two requests whose prompts agree on tokens
``[p*ps, (p+1)*ps)`` can map the *same* physical page at logical index
``p``. A shared system prompt is prefilled once and every later request
skips straight past it — TTFT drops from O(prompt) to O(suffix).

Structure: a radix tree at page granularity. Each edge is labelled by the
``page_size`` token ids a page covers; each node owns one physical page.
Matching a new prompt walks the tree page by page; insertion (at prompt
completion, when the pages are final) adds nodes for the uncached suffix.
The tree holds its own reference on every cached page (see
``PageAllocator`` refcounts), so cached pages survive the request that
wrote them and are reclaimed — LRU leaves first — only under allocator
pressure.

Copy-on-write on the first diverging page: when the match ends mid-page
(the new prompt agrees with a cached page on its first ``r < page_size``
tokens), the cached page cannot be shared directly — the new request must
write its own tokens from offset ``r`` on, and pages are only shared
read-only. Instead ``match`` hands back that page as a COW source: the
scheduler allocates a private page, the engine copies the source onto it
(``paged_kv.copy_page``, one compiled shape), and the request's prefill
overwrites it from the divergence point. The source is pinned (incref) by
``match`` until the copy lands, so eviction can never race it.

Two hard rules keep sharing sound:

* Only *immutable* pages enter the tree: pages fully covered by the
  prompt. Generated tokens are written at positions ``>= len(prompt)``,
  so a partial tail page is still written after prefill and never cached.
* A match is capped at ``len(prompt) - 1`` tokens: the final prompt token
  is always processed by the model, because its logits seed sampling.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.paged_kv import PageAllocator


class _Node:
    """One cached page: edge label ``key`` (page_size token ids as bytes),
    physical ``page``, LRU stamp, and parent linkage for leaf eviction."""
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: bytes, page: int, parent: "_Node"):
        self.key = key
        self.page = page
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    def __init__(self, allocator: PageAllocator, page_size: int,
                 metrics=None):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.root = _Node(b"", 0, None)     # owns no page (trash page id 0)
        self._clock = 0
        # hit/eviction/COW accounting lives in the metrics registry (the
        # stats dict and the Prometheus exposition read the same numbers);
        # standalone caches get a private live registry so counters work
        m = metrics if metrics is not None else MetricsRegistry()
        self._m_queries = m.counter(
            "repro_prefix_queries_total", "prefix-cache match() calls")
        self._m_hit_queries = m.counter(
            "repro_prefix_hit_queries_total",
            "match() calls returning >= 1 cached token")
        self._m_tok_queried = m.counter(
            "repro_prefix_tokens_queried_total", "prompt tokens matched")
        self._m_tok_hit = m.counter(
            "repro_prefix_tokens_hit_total",
            "prompt tokens served from the cache")
        self._m_inserts = m.counter(
            "repro_prefix_inserted_pages_total", "pages newly cached")
        self._m_evictions = m.counter(
            "repro_prefix_evictions_total", "cached pages evicted (LRU)")
        self._m_cow = m.counter(
            "repro_prefix_cow_hits_total",
            "matches ending mid-page (copy-on-write source handed out)")
        self._m_cached_pages = m.gauge(
            "repro_prefix_cached_pages", "pages held by the radix tree")

    # -- bookkeeping --------------------------------------------------------

    # registry-backed spellings of the original counter attributes
    @property
    def n_queries(self) -> int:
        return int(self._m_queries.value())

    @property
    def n_hit_queries(self) -> int:
        return int(self._m_hit_queries.value())

    @property
    def tokens_queried(self) -> int:
        return int(self._m_tok_queried.value())

    @property
    def tokens_hit(self) -> int:
        return int(self._m_tok_hit.value())

    @property
    def n_evicted(self) -> int:
        return int(self._m_evictions.value())

    @property
    def n_cached_pages(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def cached_pages(self) -> list[int]:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                out.append(ch.page)
                stack.append(ch)
        return out

    @property
    def hit_rate(self) -> float:
        """Fraction of queried prompt tokens served from the cache."""
        return self.tokens_hit / max(self.tokens_queried, 1)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _key(self, tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    # -- the cache interface ------------------------------------------------

    def match(self, prompt: np.ndarray
              ) -> tuple[list[int], int, Optional[int]]:
        """Longest cached prefix of ``prompt``, capped at ``len(prompt)-1``.

        Returns ``(pages, n_cached, cow_src)``: ``pages`` are the shared
        full pages covering ``prompt[:len(pages)*page_size]`` — one
        reference per page is taken FOR THE CALLER (the request's page
        table); ``n_cached`` is the total cached token count; when
        ``n_cached`` extends mid-page, ``cow_src`` is the partially
        matching cached page (also incref'd — the caller must copy it onto
        a private page and then release the reference).
        """
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        limit = len(prompt) - 1             # last token always runs
        self._m_queries.inc()
        self._m_tok_queried.inc(len(prompt))

        pages: list[int] = []
        node = self.root
        pos = 0
        while pos + ps <= limit:
            child = node.children.get(self._key(prompt[pos:pos + ps]))
            if child is None:
                break
            self._touch(child)
            self.allocator.incref(child.page)
            pages.append(child.page)
            node = child
            pos += ps

        # first diverging page: the child sharing the longest head with the
        # remaining prompt becomes the COW source
        cow_src, best = None, 0
        rem = prompt[pos:pos + min(ps, limit - pos)]
        if len(rem) > 0:
            for key, child in node.children.items():
                cached = np.frombuffer(key, np.int32)[:len(rem)]
                r = int((np.cumprod(cached == rem)).sum())
                if r > best:
                    best, cow_src = r, child
        if cow_src is not None:
            self._touch(cow_src)
            self.allocator.incref(cow_src.page)
            cow_src = cow_src.page
            self._m_cow.inc()

        n_cached = pos + best
        self._m_tok_hit.inc(n_cached)
        if n_cached > 0:
            self._m_hit_queries.inc()
        return pages, n_cached, cow_src

    def insert(self, prompt: np.ndarray, pages: list) -> int:
        """Cache the immutable prompt pages: ``pages[j]`` must hold the KV
        of ``prompt[j*ps:(j+1)*ps]`` (only pages FULLY covered by the
        prompt may be passed — the partial tail page is still written by
        decode). Existing nodes win (first writer stays, identical content
        by construction); each newly cached page gains a tree reference.
        Returns the number of pages newly cached."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        assert len(pages) * ps <= len(prompt), \
            f"{len(pages)} pages exceed the {len(prompt)}-token prompt"
        node, added = self.root, 0
        for j, page in enumerate(pages):
            key = self._key(prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(page), node)
                node.children[key] = child
                self.allocator.incref(int(page))
                added += 1
            self._touch(child)
            node = child
        if added:
            self._m_inserts.inc(added)
            self._m_cached_pages.add(added)
        return added

    def evict(self, n: int) -> int:
        """Free up to ``n`` cached pages, coldest evictable leaves first.
        A leaf is evictable when the tree is its page's only owner
        (refcount 1) — pages still mapped by a running slot (or pinned as
        an in-flight COW source) are never touched. Evicting a leaf can
        expose its parent; the sweep repeats until satisfied or stuck.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n:
            best: Optional[_Node] = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                for ch in node.children.values():
                    if ch.children:
                        stack.append(ch)
                    elif self.allocator.refcount(ch.page) == 1 and (
                            best is None or ch.last_used < best.last_used):
                        best = ch
            if best is None:
                break
            del best.parent.children[best.key]
            self.allocator.free([best.page])
            freed += 1
        if freed:
            self._m_evictions.inc(freed)
            self._m_cached_pages.add(-freed)
        return freed
