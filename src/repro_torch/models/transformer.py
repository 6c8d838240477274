"""Decoder stack for attention, RG-LRU and RWKV layers, with an MLP or an
MoE FFN.

Port of ``repro.models.transformer`` for the layer kinds ``attn``,
``rglru`` (Griffin: temporal conv + RG-LRU, then an MLP) and ``rwkv``
(time mix, then channel mix). A config with ``moe`` replaces the MLP of
attention and RG-LRU layers by the top-k MoE of ``models/moe.py`` in every
mode; ``apply_hidden`` sums its aux losses over the layers. The params keep
the reference's layout: the layers of the repeated block pattern are
stacked under ``params["layers"]`` with a leading ``n_super`` axis, the
remainder under ``params["rem"]``. A Python loop over the layer axis takes
the place of ``lax.scan``; the stacked params are unbound into per-layer
views once per pass (so a backward stacks their gradients once).

Entry points, each taking raw params or ``CompressedParams``:
    apply_hidden(params, batch)            -> hidden, aux
    apply_train(params, batch)             -> logits, aux
    head(params, hidden)                   -> f32 logits
    init_cache(batch, seq_len)             -> ring KV cache
    prefill(params, prompt, cache)         -> last-position logits, cache
    decode_step(params, tok, cache, pos)   -> logits, cache
    paged_step(params, tokens, pools, page_table, start_pos, n_tokens)
                                           -> last-valid-token logits, pools

Compressed projections (attention q/k/v/o, MLP, the MoE experts, the
RG-LRU and RWKV projections, head) run ``sparse_matmul`` with the model's
``sparse_backend`` ('auto': the CUDA kernels for tensors on the card).
Caches and engine pools are updated in place: attention writes its K/V
into them, and a recurrent layer copies its new state over the old one.

Under a rank mesh (``distributed.sharding.use_mesh``) the params are this
rank's part (``shard_params``): each pass takes a view of every layer
(``distributed.parallel``) that gathers its stored-split leaves and marks
its computed-split ones; caches and pools hold every head on every rank
of a model group, and the batch rows of this rank's data coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.models import attention, moe as moe_lib, rglru, rwkv6
from repro_torch.models.layers import (apply_embed, apply_head, apply_mlp,
                                       apply_norm, init_embed, init_mlp,
                                       init_norm, truncated_normal_init)
from repro_torch.sparse.compress import CompressedParams
from repro_torch.sparse.formats import is_bcsr

Tensor = torch.Tensor
PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# the layer kinds the port runs, and those of them that carry recurrent
# state (the serving engine's slot pools, launch/train's refusal)
KINDS = ("attn", "rglru", "rwkv")
RECURRENT_KINDS = ("rglru", "rwkv")


def layer_kinds(cfg) -> tuple:
    """The kinds of ``cfg``'s layers in order: the block pattern, then the
    remainder pattern."""
    return tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)


def _split_params(params) -> tuple[PyTree, Optional[PyTree]]:
    if isinstance(params, CompressedParams):
        return params.dense, params.sparse
    return params, None


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: tensors and compressed formats are
    indexed on their leading axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, Tensor) or is_bcsr(tree):
        return tree[i]
    return tree


def _unbind(tree, n: int) -> list:
    """All ``n`` layers of a stacked tree at once (``torch.unbind`` per
    tensor). Its backward stacks the layers' gradients once, where taking
    ``tree[i]`` per layer would allocate a zero tensor of the whole stack
    in the backward of every select."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, Tensor):
        return list(tree.unbind(0))
    if is_bcsr(tree):
        fields = {f.name: getattr(tree, f.name).unbind(0)
                  for f in dataclasses.fields(tree)
                  if isinstance(getattr(tree, f.name), Tensor)}
        return [dataclasses.replace(tree, **{k: v[i] for k, v in fields.items()})
                for i in range(n)]
    return [tree] * n


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _zero_aux(device) -> dict:
    return {"load_balance": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _write_state(cache: dict, new: dict) -> None:
    """Copy a recurrent layer's new state over its cache entries, in
    place (the entries may be views into a stacked cache)."""
    for sub, tree in new.items():
        for leaf, t in tree.items():
            cache[sub][leaf].copy_(t)


class Model:
    """A decoder of config ``cfg`` (layer kinds attn / rglru / rwkv, MLP or
    MoE FFN) on ``device``.

    ``sparse_backend`` is handed to every ``sparse_matmul``: 'auto' (the
    kernels on a CUDA device, the plain version on the CPU) or 'ref' (the
    plain version everywhere, to compare against on the card)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 sparse_backend: str = "auto"):
        kinds = set(layer_kinds(cfg))
        if not kinds <= set(KINDS):
            raise ValueError(f"{cfg.name}: unknown layer kinds "
                             f"{sorted(kinds - set(KINDS))}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sparse_backend = sparse_backend
        self.cdt = _DTYPES[cfg.compute_dtype]

    # -- params ---------------------------------------------------------------

    def _init_layer(self, kind: str, gen, device) -> dict:
        cfg = self.cfg
        p = {"pre_norm": init_norm(cfg.d_model, cfg.norm, device)}
        if kind == "attn":
            p["attn"] = attention.init_attention(cfg, gen, device)
        elif kind == "rglru":
            p["rec"] = rglru.init_rglru(cfg, gen, device)
        else:
            p["tm"] = rwkv6.init_time_mix(cfg, gen, device)
        p["ffn_norm"] = init_norm(cfg.d_model, cfg.norm, device)
        if kind == "rwkv":
            p["cm"] = rwkv6.init_channel_mix(cfg, gen, device)
        elif cfg.moe is not None:
            p["moe"] = moe_lib.init_moe(cfg, gen, device)
        else:
            p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated, gen,
                                device)
        return p

    def _init_super(self, gen, device) -> dict:
        return {f"b{i}_{kind}": self._init_layer(kind, gen, device)
                for i, kind in enumerate(self.cfg.block_pattern)}

    def init(self, gen: Optional[torch.Generator] = None,
             device=None, each_part: Optional[Callable] = None) -> dict:
        """Random f32 params in the reference's layout. The generator ``gen``
        must live on the target device; ``device="meta"`` gives shapes only.

        ``each_part(group, part)``, where given, takes each part as it is
        drawn and returns what to keep of it, before the next part is
        drawn: group "layers" with one super-block's {key: layer}, "rem"
        with one remainder layer's {key: layer}, "head" with the untied
        head (``sparse.compress.init_compressed`` prunes and compresses
        there, so that the dense model never exists whole)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        keep = each_part or (lambda group, part: part)
        params: dict = {"embed": init_embed(cfg.vocab, cfg.d_model, gen, dev)}
        params["layers"] = _stack_trees(
            [keep("layers", self._init_super(gen, dev))
             for _ in range(cfg.n_super_blocks)])
        rem = cfg.remainder_pattern
        if rem:
            params["rem"] = {}
            for i, kind in enumerate(rem):
                params["rem"].update(keep("rem", {
                    f"r{i}_{kind}": self._init_layer(kind, gen, dev)}))
        params["final_norm"] = init_norm(cfg.d_model, cfg.norm, dev)
        if not cfg.tie_embeddings:
            params["head"] = keep("head", truncated_normal_init(
                (cfg.d_model, cfg.vocab), 1.0, gen, dev))
        return params

    # -- layers ---------------------------------------------------------------

    def _embed(self, dense, inputs: Tensor) -> Tensor:
        """Token ids (B, S), or precomputed frontend embeddings (B, S, d)."""
        if inputs.dim() == 3:
            return inputs.to(self.cdt)
        return apply_embed(parallel.layer_view(dense["embed"], "embed"),
                           inputs, self.cdt)

    def _layers(self, dense, sparse, cache=None):
        """Yield (kind, layer params, compressed layer weights, layer cache)
        for every layer in order: the stacked ones, then the remainder."""
        n = self.cfg.n_super_blocks
        view = parallel.layer_view
        p_all = _unbind(parallel.stacked_view(dense["layers"], "layers"), n)
        sp_all = _unbind(parallel.stacked_view(
            (sparse or {}).get("layers", {}), "layers"), n)
        sp_rem = (sparse or {}).get("rem", {})
        for i in range(n):
            p_i, sp_i = p_all[i], sp_all[i]
            c_i = _index(cache["layers"], i) if cache is not None else {}
            for key in p_i:
                path = f"layers/{key}"
                yield (key.split("_", 1)[1],
                       view(p_i[key], path, stacked=True),
                       view(sp_i.get(key), path, stacked=True) or {},
                       c_i.get(key))
        for key, p in dense.get("rem", {}).items():
            c = cache["rem"][key] if cache is not None else None
            path = f"rem/{key}"
            yield (key.split("_", 1)[1], view(p, path),
                   view(sp_rem.get(key), path) or {}, c)

    def _layer(self, kind: str, p: dict, x: Tensor, sp: dict, mode: str,
               cache: Optional[dict] = None, positions=None, pos=None,
               page_table=None, n_tokens=None, backend: str = "auto",
               kv_splits: int = 1, aux: Optional[dict] = None) -> Tensor:
        """One layer, mixer then FFN, pre-norm residuals. ``mode``: 'train'
        (full sequence, no cache), 'prefill' (full sequence from a fresh
        state, filling ``cache``), 'decode' (one token at ``pos``) or
        'paged' (the engine's mixed step against the slot pools). The new
        recurrent state is written into ``cache`` in place; an MoE FFN's
        aux losses are added into ``aux`` where given (the other modes
        drop them, as the reference does)."""
        cfg, sb = self.cfg, self.sparse_backend
        state = cache
        if mode == "paged" and kind != "attn":
            # a slot whose FIRST prefill chunk lands this tick (absolute
            # position 0) starts a new request: its state starts from zero,
            # whatever a previous occupant of the slot left (the engine also
            # zeroes recycled slots; this is the correctness invariant)
            fresh = (positions[:, 0] == 0) & (n_tokens > 0)
            state = _tree_map(lambda t: torch.where(
                fresh.reshape((-1,) + (1,) * (t.dim() - 1)), 0, t), cache)
        carried = mode in ("decode", "paged")
        h = apply_norm(p["pre_norm"], x, cfg.norm)
        new: dict = {}
        if kind == "attn":
            a, sa = p["attn"], sp.get("attn")
            if mode == "train":
                mix = attention.apply_attention(a, h, cfg, positions, sa, sb)
            elif mode == "prefill":
                mix, _ = attention.prefill_attention(a, h, cache["attn"],
                                                     positions, cfg, sa, sb)
            elif mode == "decode":
                mix, _ = attention.decode_attention(a, h, cache["attn"], pos,
                                                    cfg, sa, sb)
            else:
                mix, _ = attention.paged_attention(
                    a, h, cache["attn"], page_table, positions, n_tokens, cfg,
                    sa, backend=backend, kv_splits=kv_splits,
                    sparse_backend=sb)
        elif kind == "rglru":
            if mode == "paged":
                mix, new["rec"] = rglru.apply_rglru_block_paged(
                    p["rec"], h, cfg, state["rec"], n_tokens, sp.get("rec"), sb)
            else:
                mix, new["rec"] = rglru.apply_rglru_block(
                    p["rec"], h, cfg, state["rec"] if carried else None,
                    sp.get("rec"), sb)
        else:
            if mode == "paged":
                mix, new["tm"] = rwkv6.apply_time_mix_paged(
                    p["tm"], h, cfg, state["tm"], n_tokens, sp.get("tm"), sb)
            else:
                mix, new["tm"] = rwkv6.apply_time_mix(
                    p["tm"], h, cfg, state["tm"] if carried else None,
                    sp.get("tm"), sb)
        x = x + mix
        h = apply_norm(p["ffn_norm"], x, cfg.norm)
        if kind == "rwkv":
            if mode == "paged":
                f, new["cm"] = rwkv6.apply_channel_mix_paged(
                    p["cm"], h, state["cm"], n_tokens, sp.get("cm"), sb)
            else:
                f, new["cm"] = rwkv6.apply_channel_mix(
                    p["cm"], h, state["cm"] if carried else None,
                    sp.get("cm"), sb)
        elif cfg.moe is not None:
            # the whole (B, S) block is routed, padding of the engine's
            # tick included, as in the reference: its capacity counts them
            f, a = moe_lib.apply_moe(p["moe"], h, cfg, sparse=sp.get("moe"),
                                     backend=sb)
            if aux is not None:
                for key in aux:
                    aux[key] = aux[key] + a[key]
        else:
            f = apply_mlp(p["mlp"], h, cfg.act, cfg.mlp_gated,
                          sparse_weights=sp.get("mlp"), backend=sb)
        if cache is not None:
            _write_state(cache, new)
        return x + f

    def apply_hidden(self, params, batch: dict) -> tuple[Tensor, dict]:
        dense, sparse = _split_params(params)
        x = self._embed(dense, batch["inputs"])
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        aux = _zero_aux(x.device)
        for kind, p, sp, _ in self._layers(dense, sparse):
            x = self._layer(kind, p, x, sp, "train", positions=positions,
                            aux=aux)
        return x, aux

    def head(self, params, x: Tensor) -> Tensor:
        dense, sparse = _split_params(params)
        cfg = self.cfg
        view = parallel.layer_view
        x = apply_norm(view(dense["final_norm"], "final_norm"), x, cfg.norm)
        hp = ({"embedding": view(dense["embed"]["embedding"],
                                 "embed/embedding")} if cfg.tie_embeddings
              else {"head": view(dense["head"], "head")})
        sw = ({"head": view(sparse["head"], "head")}
              if sparse and "head" in sparse else None)
        return apply_head(hp, x, cfg.tie_embeddings, cfg.logit_softcap,
                          sparse_weights=sw, backend=self.sparse_backend)

    def apply_train(self, params, batch: dict) -> tuple[Tensor, dict]:
        x, aux = self.apply_hidden(params, batch)
        return self.head(params, x), aux

    def _layer_cache(self, kind: str, batch: int, seq_len: int, dtype) -> dict:
        cfg, dev = self.cfg, self.device
        if kind == "attn":
            return {"attn": attention.init_kv_cache(cfg, batch, seq_len, dtype,
                                                    dev)}
        if kind == "rglru":
            return {"rec": rglru.init_rglru_state(cfg, batch, dtype, dev)}
        return rwkv6.init_rwkv_state(cfg, batch, dev)

    def init_cache(self, batch: int, seq_len: int, dtype=None) -> dict:
        """Ring KV caches for attention layers, recurrent state for RG-LRU
        and RWKV layers, in the reference's tree."""
        cfg = self.cfg
        dtype = dtype or self.cdt
        cache = {"layers": _stack_trees([
            {f"b{i}_{kind}": self._layer_cache(kind, batch, seq_len, dtype)
             for i, kind in enumerate(cfg.block_pattern)}
            for _ in range(cfg.n_super_blocks)])}
        if cfg.remainder_pattern:
            cache["rem"] = {f"r{i}_{kind}": self._layer_cache(kind, batch,
                                                              seq_len, dtype)
                            for i, kind in enumerate(cfg.remainder_pattern)}
        return cache

    def decode_step(self, params, inputs: Tensor, cache: dict,
                    pos: int) -> tuple[Tensor, dict]:
        """inputs: (B, 1) ids or (B, 1, d) embeddings; pos: int. The cache
        is updated in place and returned."""
        dense, sparse = _split_params(params)
        x = self._embed(dense, inputs)
        for kind, p, sp, c in self._layers(dense, sparse, cache):
            x = self._layer(kind, p, x, sp, "decode", c, pos=pos)
        return self.head(params, x), cache

    def prefill(self, params, inputs: Tensor,
                cache: dict) -> tuple[Tensor, dict]:
        """Whole prompt in one forward, filling the cache in place (the
        recurrent layers scan from a zero state and keep the final one).
        Returns (last-position logits (B, vocab), cache ready for decode
        at S)."""
        dense, sparse = _split_params(params)
        x = self._embed(dense, inputs)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for kind, p, sp, c in self._layers(dense, sparse, cache):
            x = self._layer(kind, p, x, sp, "prefill", c, positions=positions)
        return self.head(params, x[:, -1:])[:, 0], cache

    def paged_step(self, params, tokens: Tensor, pools: dict,
                   page_table: Tensor, start_pos: Tensor, n_tokens: Tensor,
                   backend: str = "auto",
                   kv_splits: int = 1) -> tuple[Tensor, dict]:
        """Continuous-batching mixed step over a fixed-capacity slot batch.

        tokens: (B, C) ids, up to C new tokens per slot (decode slots carry
        1, prefill slots a chunk, inactive slots 0, see ``n_tokens``);
        pools: the slot resource pools of ``serve.paged_kv.init_paged_cache``
        (paged KV for attention layers, slot-indexed state for recurrent
        ones), updated in place; page_table: (B, P) int32; start_pos,
        n_tokens: (B,) int32. Returns (f32 logits at each slot's LAST valid
        token (B, vocab), pools): one call serves any prefill/decode mix of
        an engine tick. ``backend`` and ``kv_splits`` pick the paged
        attention ('cuda': the paged flash-decode kernel, 'ref': gather then
        softmax, 'auto': by the tensors' device; see
        ``attention.paged_attention``).
        """
        dense, sparse = _split_params(params)
        x = self._embed(dense, tokens)
        c = x.shape[1]
        positions = (start_pos[:, None]
                     + torch.arange(c, dtype=torch.int32, device=x.device))
        for kind, p, sp, cache in self._layers(dense, sparse, pools):
            x = self._layer(kind, p, x, sp, "paged", cache,
                            positions=positions, page_table=page_table,
                            n_tokens=n_tokens, backend=backend,
                            kv_splits=kv_splits)
        last = (n_tokens.long() - 1).clamp(0, c - 1)
        xl = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.head(params, xl)[:, 0], pools
