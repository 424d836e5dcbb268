"""Decoder-only transformer LM, dense and MoE (port of
``repro/models/transformer.py``).

The model is written against the ParamGetter protocol of
``core.fsdp``: ``pg.globals(group)`` returns the gathered, unpacked tensors
of an unstacked group; ``pg.scan(groups, body, carry, xs)`` runs the FSDP
layer loop (per-layer all-gather -> unpack -> body, in the structure the
communication schedule lays out), which is the ZeRO-3 schedule.

Ported: the self-attention decoder with tp=1 -- the ``layers`` and
``globals`` groups, gemma2's alternating local/global windows, softcaps,
post-norms and tied embeddings, the q/k/v projection biases (``qkv_bias``:
qwen2.5 and qwen1.5), the mlp kinds, the MoE layer at ep=1 (the
router in ``layers``, the experts in the ``layers_experts`` group scanned
beside it, the load-balance term carried through the scan), the loss on
the materialized-logits (``ce_chunk=0``) branch, and the serving API: the
ring-buffer KV cache (``init_cache``, the reference's layout, bf16 K and
V), ``prefill`` and ``decode`` (a scalar position, or per-row positions
for continuous batching).  VLM cross-attention, tensor/expert
parallelism and the vocab-chunked CE raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.ragged import ShardDim, TensorSpec
from . import layers as L
from .moe import moe_ffn

# window of a global-attention layer (the reference's 2**30 sentinel)
GLOBAL_WINDOW = 2 ** 30


@dataclasses.dataclass(frozen=True)
class GroupDef:
    """One communication group: FULL logical tensor specs, stacked
    ``n_layers`` times if part of the layer loop, with optional outer
    (TP/EP) sharding applied before RaggedShard."""

    specs: tuple[TensorSpec, ...]
    n_layers: int | None = None
    outer: dict[str, ShardDim] = dataclasses.field(default_factory=dict)
    replicated_over_model: bool = False


def _gran(cfg, shape) -> int:
    """Granularity policy: block-quantized optimizers get quant_block-sized
    blocks on big tensors; else element-wise."""
    size = int(np.prod(shape))
    if (cfg.optimizer == "adam8bit" and len(shape) >= 2
            and size % cfg.quant_block == 0):
        return cfg.quant_block
    return 1


def spec(cfg, name, shape) -> TensorSpec:
    return TensorSpec(name, tuple(shape), granularity=_gran(cfg, shape))


def _check_supported(cfg) -> None:
    par = cfg.parallel
    unported = (
        (cfg.cross_attn_interval > 0, "VLM cross-attention",
         "Queue 1 item 14b"),
        (par.tp > 1, f"tp={par.tp}", "Queue 1 item 18"),
        (par.ep > 1, f"ep={par.ep}", "Queue 1 item 18"),
        (par.sequence_parallel, "sequence_parallel", "Queue 1 item 18"),
    )
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})")


class DecoderLM:
    def __init__(self, cfg):
        _check_supported(cfg)
        self.cfg = cfg
        # no VLM cross-attention blocks: one self layer per scanned block
        self.n_blocks = cfg.n_layers
        self.selfs_per_block = 1

    # ---------------- specs ------------------------------------------------
    def _self_layer_specs(self) -> list[TensorSpec]:
        cfg = self.cfg
        D, hd = cfg.d_model, cfg.hd
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        specs = [spec(cfg, "ln1", (D,)),
                 spec(cfg, "wq", (D, Hq * hd)),
                 spec(cfg, "wk", (D, Hkv * hd)),
                 spec(cfg, "wv", (D, Hkv * hd))]
        if cfg.qkv_bias:
            specs += [spec(cfg, "wq_b", (Hq * hd,)),
                      spec(cfg, "wk_b", (Hkv * hd,)),
                      spec(cfg, "wv_b", (Hkv * hd,))]
        specs.append(spec(cfg, "wo", (Hq * hd, D)))
        if cfg.post_norms:
            specs.append(spec(cfg, "post_ln1", (D,)))
        specs.append(spec(cfg, "ln2", (D,)))
        if cfg.n_experts:
            # the router lives in the layer group; the experts are a group
            # of their own (see groups())
            specs.append(spec(cfg, "moe_router", (D, cfg.n_experts)))
        else:
            specs.append(spec(cfg, "w1", (D, cfg.d_ff)))
            if cfg.mlp in ("swiglu", "geglu"):
                specs.append(spec(cfg, "w3", (D, cfg.d_ff)))
            specs.append(spec(cfg, "w2", (cfg.d_ff, D)))
        if cfg.post_norms:
            specs.append(spec(cfg, "post_ln2", (D,)))
        return specs

    def groups(self) -> dict[str, GroupDef]:
        cfg = self.cfg
        gl = [spec(cfg, "emb", (cfg.vocab, cfg.d_model)),
              spec(cfg, "final_ln", (cfg.d_model,))]
        if not cfg.tie_embeddings:
            gl.append(spec(cfg, "head", (cfg.d_model, cfg.vocab)))
        groups = {"layers": GroupDef(tuple(self._self_layer_specs()),
                                     n_layers=self.n_blocks)}
        if cfg.n_experts:
            E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
            groups["layers_experts"] = GroupDef(
                (spec(cfg, "moe_w1", (E, D, F)), spec(cfg, "moe_w3", (E, D, F)),
                 spec(cfg, "moe_w2", (E, F, D))), n_layers=self.n_blocks)
        groups["globals"] = GroupDef(tuple(gl))
        return groups

    # ---------------- forward ------------------------------------------------
    def _layer_windows(self) -> list[int]:
        """Per-layer attention window; gemma2 alternates local (sliding)
        and global layers, starting with a local one."""
        cfg = self.cfg
        if cfg.local_global_alternate and cfg.sliding_window:
            return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW
                    for i in range(cfg.n_layers)]
        if cfg.sliding_window:
            return [cfg.sliding_window] * cfg.n_layers
        return [GLOBAL_WINDOW] * cfg.n_layers

    def _self_block(self, p, x, q_pos, window, cache=None, cache_index=0):
        """One layer; returns ``(x, aux)``, aux the MoE load-balance term
        (0.0 for a dense layer).  With a ``cache`` (this layer's views) the
        attention writes its keys and values into it in place."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        out, _ = L.attention(cfg, p, h, q_pos=q_pos, cache=cache,
                             cache_index=cache_index, window=window)
        if cfg.post_norms:
            out = L.rms_norm(out, p["post_ln1"], cfg.norm_eps)
        x = x + out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            out, aux = moe_ffn(cfg, p, h, ep=cfg.parallel.ep)
        else:
            out, aux = L.mlp(cfg, p, h), 0.0
        if cfg.post_norms:
            out = L.rms_norm(out, p["post_ln2"], cfg.norm_eps)
        return x + out, aux

    def _scan_groups(self) -> list[str]:
        return ["layers"] + (["layers_experts"] if self.cfg.n_experts else [])

    def _backbone(self, pg, x, q_pos, caches=None, cache_index=0):
        """The layer stack; returns ``(x, aux)``, aux summed over layers in
        fp32.  ``caches``: the full cache (leading dims n_blocks,
        selfs_per_block), whose per-layer views each layer updates in
        place."""
        def body(p, carry, xs):
            x, aux = carry
            window, cache = xs
            x, a = self._self_block(p, x, q_pos, window, cache, cache_index)
            return (x, aux + a), None

        windows = self._layer_windows()
        xs = [(w, None if caches is None
               else {k: t[i, 0] for k, t in caches.items()})
              for i, w in enumerate(windows)]
        aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
        (x, aux), _ = pg.scan(self._scan_groups(), body, (x, aux0), xs)
        return x, aux

    def _embed_in(self, pg, tokens):
        g = pg.globals("globals")
        x = L.embed(tokens, g["emb"].to(pg.compute_dtype))
        return x, g

    def _logits(self, g, x):
        cfg = self.cfg
        x = L.rms_norm(x, g["final_ln"], cfg.norm_eps)
        head = g["emb"].T if cfg.tie_embeddings else g["head"]
        return L.lm_logits(x, head, softcap=cfg.final_softcap)

    # ---------------- public API ----------------------------------------------
    def loss(self, pg, batch):
        """(sum of next-token NLL plus the MoE load-balance term weighted
        by tokens / n_layers, number of predicted tokens) of the local
        batch; the runtime normalizes across ranks."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        q_pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
        x, g = self._embed_in(pg, tokens)
        x, aux = self._backbone(pg, x, q_pos)
        cfg = self.cfg
        ones = torch.ones((B, T - 1), dtype=torch.float32,
                          device=tokens.device)
        if cfg.ce_chunk:
            # vocab-chunked online-logsumexp CE: the (B, T, V) fp32
            # logits never exist
            x = L.rms_norm(x, g["final_ln"], cfg.norm_eps)
            head = g["emb"].T if cfg.tie_embeddings else g["head"]
            nll, w = L.chunked_ce(
                x[:, :-1], head.to(pg.compute_dtype), tokens[:, 1:], ones,
                vocab_chunk=cfg.ce_chunk, softcap=cfg.final_softcap)
        else:
            logits = self._logits(g, x)
            nll, w = L.vocab_parallel_ce(logits[:, :-1], tokens[:, 1:], ones)
        return nll + aux * w / max(cfg.n_layers, 1), w

    # ---------------- serving ------------------------------------------------
    def cache_window(self, seq_len: int) -> int:
        """Ring-buffer size: long-context decode on a sliding-window arch
        caps the cache at the window (the reference's rule)."""
        cfg = self.cfg
        if cfg.sliding_window and seq_len > 65536:
            return cfg.sliding_window
        return seq_len

    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Full KV cache shapes and dtypes, leading dims (n_blocks,
        selfs_per_block): K and V (B, Hkv, W, hd) in bf16 whatever the
        compute dtype, ``pos`` (B, W) int32."""
        cfg = self.cfg
        W = self.cache_window(seq_len)
        lead = (self.n_blocks, self.selfs_per_block, batch)
        return {"k": (lead + (cfg.n_kv_heads, W, cfg.hd), torch.bfloat16),
                "v": (lead + (cfg.n_kv_heads, W, cfg.hd), torch.bfloat16),
                "pos": (lead + (W,), torch.int32)}

    def cache_batch_dims(self) -> dict[str, int]:
        """Batch-dim index of each cache leaf."""
        return {"k": 2, "v": 2, "pos": 2}

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> dict:
        """An empty cache: K and V zeros, ``pos`` -1 (no slot filled).  On
        the card unless ``device`` says otherwise."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "init_cache places the cache on the card by default and no "
                "CUDA device is available; pass device='cpu'")
        return {k: torch.full(shape, -1 if k == "pos" else 0, dtype=dtype,
                              device=dev)
                for k, (shape, dtype) in self.cache_shapes(
                    batch, seq_len).items()}

    def prefill(self, pg, batch, cache):
        """Run the prompt ``batch["tokens"]`` (B, T) from position 0,
        filling the cache in place.  Returns ``(logits (B, 1, V) of the last
        position, cache)``."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        q_pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
        x, g = self._embed_in(pg, tokens)
        x, _ = self._backbone(pg, x, q_pos, caches=cache, cache_index=0)
        return self._logits(g, x[:, -1:]), cache

    def decode(self, pg, batch, cache, index):
        """One token per row (``batch["tokens"]`` (B, 1)) against a filled
        cache.  ``index``: the position, an int, or a (B,) integer tensor
        of per-row positions (continuous batching).  Returns ``(logits
        (B, 1, V), cache)``."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            q_pos = index.to(device=tokens.device, dtype=torch.int64)[:, None]
        else:
            q_pos = torch.full((B, 1), int(index), dtype=torch.int64,
                               device=tokens.device)
        x, g = self._embed_in(pg, tokens)
        x, _ = self._backbone(pg, x, q_pos, caches=cache, cache_index=index)
        return self._logits(g, x), cache
