"""Decoder stack for attention-only configs.

Port of ``repro.models.transformer`` for ``attn`` layers. The params keep
the reference's layout: the layers of the repeated block pattern are
stacked under ``params["layers"]`` with a leading ``n_super`` axis, the
remainder under ``params["rem"]``. A Python loop over the layer axis takes
the place of ``lax.scan``; ``t[i]`` of a stacked tensor (and ``m[i]`` of a
stacked BlockCSR) is a contiguous view.

Entry points, each taking raw params or ``CompressedParams``:
    apply_hidden(params, batch)            -> hidden, aux
    apply_train(params, batch)             -> logits, aux   (forward only)
    head(params, hidden)                   -> f32 logits
    init_cache(batch, seq_len)             -> ring KV cache
    prefill(params, prompt, cache)         -> last-position logits, cache
    decode_step(params, tok, cache, pos)   -> logits, cache

Compressed projections (attention q/k/v/o, MLP, head) run ``sparse_matmul``
with the model's ``sparse_backend`` ('auto': the CUDA kernels for tensors
on the card). RG-LRU, RWKV and MoE layers are not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (apply_embed, apply_head, apply_mlp,
                                       apply_norm, init_embed, init_mlp,
                                       init_norm, truncated_normal_init)
from repro_torch.sparse.compress import CompressedParams
from repro_torch.sparse.formats import is_bcsr

Tensor = torch.Tensor
PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_LATER = ("not ported yet: RG-LRU, RWKV and MoE layers come with ROADMAP "
          "Queue 1 item 8")


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


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _zero_aux(device) -> dict:
    return {"load_balance": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


class Model:
    """An attention-only decoder of config ``cfg`` on ``device``.

    ``sparse_backend`` is handed to every ``sparse_matmul``: 'auto' (the
    kernels on a CUDA device, the plain version on the CPU) or 'ref' (the
    plain version everywhere, to compare against on the card)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 sparse_backend: str = "auto"):
        kinds = set(cfg.block_pattern) | set(cfg.remainder_pattern)
        if kinds != {"attn"} or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: layer kinds {sorted(kinds)}"
                f"{' with MoE' if cfg.moe is not None else ''} are {_LATER}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sparse_backend = sparse_backend
        self.cdt = _DTYPES[cfg.compute_dtype]

    # -- params ---------------------------------------------------------------

    def _init_layer(self, gen, device) -> dict:
        cfg = self.cfg
        return {"pre_norm": init_norm(cfg.d_model, cfg.norm, device),
                "attn": attention.init_attention(cfg, gen, device),
                "ffn_norm": init_norm(cfg.d_model, cfg.norm, device),
                "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated, gen,
                                device)}

    def _init_super(self, gen, device) -> dict:
        return {f"b{i}_{kind}": self._init_layer(gen, device)
                for i, kind in enumerate(self.cfg.block_pattern)}

    def init(self, gen: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Random f32 params in the reference's layout. The generator ``gen``
        must live on the target device; ``device="meta"`` gives shapes only."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        params: dict = {"embed": init_embed(cfg.vocab, cfg.d_model, gen, dev)}
        params["layers"] = _stack_trees(
            [self._init_super(gen, dev) for _ in range(cfg.n_super_blocks)])
        rem = cfg.remainder_pattern
        if rem:
            params["rem"] = {f"r{i}_{kind}": self._init_layer(gen, dev)
                             for i, kind in enumerate(rem)}
        params["final_norm"] = init_norm(cfg.d_model, cfg.norm, dev)
        if not cfg.tie_embeddings:
            params["head"] = truncated_normal_init((cfg.d_model, cfg.vocab),
                                                   1.0, gen, dev)
        return params

    # -- layers ---------------------------------------------------------------

    def _embed(self, dense, inputs: Tensor) -> Tensor:
        """Token ids (B, S), or precomputed frontend embeddings (B, S, d)."""
        if inputs.dim() == 3:
            return inputs.to(self.cdt)
        return apply_embed(dense["embed"], inputs, self.cdt)

    def _ffn(self, p, x, sp):
        cfg = self.cfg
        h = apply_norm(p["ffn_norm"], x, cfg.norm)
        return x + apply_mlp(p["mlp"], h, cfg.act, cfg.mlp_gated,
                             sparse_weights=sp.get("mlp"),
                             backend=self.sparse_backend)

    def _layers(self, dense, sparse, cache=None):
        """Yield (layer params, compressed layer weights, layer cache) for
        every layer in order: the stacked ones, then the remainder."""
        sp_layers = (sparse or {}).get("layers", {})
        sp_rem = (sparse or {}).get("rem", {})
        for i in range(self.cfg.n_super_blocks):
            p_i = _index(dense["layers"], i)
            sp_i = _index(sp_layers, i)
            c_i = _index(cache["layers"], i) if cache is not None else {}
            for key in p_i:
                yield p_i[key], sp_i.get(key) or {}, c_i.get(key)
        for key, p in dense.get("rem", {}).items():
            c = cache["rem"][key] if cache is not None else None
            yield p, sp_rem.get(key) or {}, c

    def apply_hidden(self, params, batch: dict) -> tuple[Tensor, dict]:
        dense, sparse = _split_params(params)
        cfg = self.cfg
        x = self._embed(dense, batch["inputs"])
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for p, sp, _ in self._layers(dense, sparse):
            h = apply_norm(p["pre_norm"], x, cfg.norm)
            x = x + attention.apply_attention(p["attn"], h, cfg, positions,
                                              sp.get("attn"),
                                              self.sparse_backend)
            x = self._ffn(p, x, sp)
        return x, _zero_aux(x.device)

    def head(self, params, x: Tensor) -> Tensor:
        dense, sparse = _split_params(params)
        cfg = self.cfg
        x = apply_norm(dense["final_norm"], x, cfg.norm)
        hp = ({"embedding": dense["embed"]["embedding"]} if cfg.tie_embeddings
              else {"head": dense["head"]})
        sw = {"head": sparse["head"]} if sparse and "head" in sparse else None
        return apply_head(hp, x, cfg.tie_embeddings, cfg.logit_softcap,
                          sparse_weights=sw, backend=self.sparse_backend)

    def apply_train(self, params, batch: dict) -> tuple[Tensor, dict]:
        x, aux = self.apply_hidden(params, batch)
        return self.head(params, x), aux

    def init_cache(self, batch: int, seq_len: int, dtype=None) -> dict:
        cfg = self.cfg
        dtype = dtype or self.cdt

        def one():
            return {"attn": attention.init_kv_cache(cfg, batch, seq_len, dtype,
                                                    self.device)}

        cache = {"layers": _stack_trees([
            {f"b{i}_{kind}": one() for i, kind in enumerate(cfg.block_pattern)}
            for _ in range(cfg.n_super_blocks)])}
        if cfg.remainder_pattern:
            cache["rem"] = {f"r{i}_{kind}": one()
                            for i, kind in enumerate(cfg.remainder_pattern)}
        return cache

    def decode_step(self, params, inputs: Tensor, cache: dict,
                    pos: int) -> tuple[Tensor, dict]:
        """inputs: (B, 1) ids or (B, 1, d) embeddings; pos: int. The cache
        is updated in place and returned."""
        dense, sparse = _split_params(params)
        cfg = self.cfg
        x = self._embed(dense, inputs)
        for p, sp, c in self._layers(dense, sparse, cache):
            h = apply_norm(p["pre_norm"], x, cfg.norm)
            mix, _ = attention.decode_attention(p["attn"], h, c["attn"], pos,
                                                cfg, sp.get("attn"),
                                                self.sparse_backend)
            x = self._ffn(p, x + mix, sp)
        return self.head(params, x), cache

    def prefill(self, params, inputs: Tensor,
                cache: dict) -> tuple[Tensor, dict]:
        """Whole prompt in one forward, filling the cache in place. Returns
        (last-position logits (B, vocab), cache ready for decode at S)."""
        dense, sparse = _split_params(params)
        cfg = self.cfg
        x = self._embed(dense, inputs)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for p, sp, c in self._layers(dense, sparse, cache):
            h = apply_norm(p["pre_norm"], x, cfg.norm)
            mix, _ = attention.prefill_attention(p["attn"], h, c["attn"],
                                                 positions, cfg,
                                                 sp.get("attn"),
                                                 self.sparse_backend)
            x = self._ffn(p, x + mix, sp)
        return self.head(params, x[:, -1:])[:, 0], cache
