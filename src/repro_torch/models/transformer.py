"""Decoder-only transformer LM, dense and MoE (port of
``repro/models/transformer.py``).

The model is written against the ParamGetter protocol of
``core.fsdp``: ``pg.globals(group)`` returns the gathered, unpacked tensors
of an unstacked group; ``pg.scan(groups, body, carry, xs)`` runs the FSDP
layer loop (per-layer all-gather -> unpack -> body, in the structure the
communication schedule lays out), which is the ZeRO-3 schedule.

Ported: the self-attention decoder -- the ``layers`` and ``globals``
groups, gemma2's alternating local/global windows, softcaps, post-norms
and tied embeddings, the q/k/v projection biases (``qkv_bias``: qwen2.5
and qwen1.5), the mlp kinds, the MoE layer (the router in ``layers``, the
experts in the ``layers_experts`` group scanned beside it, the
load-balance term carried through the scan), both losses (materialized
logits and the vocab-chunked CE), and the serving API: the ring-buffer KV
cache (``init_cache``, the reference's layout, bf16 K and V), ``prefill``
and ``decode`` (a scalar position, or per-row positions for continuous
batching).

The model axis (the reference's outer sharding, paper Fig. 5): under
tensor parallelism (``tp`` > 1) each tensor with a TP dim is split over
the model axis before FSDP (the ``layers`` group; ``emb`` over the vocab
rows and ``head`` over its columns in ``globals``), the rest of a layer
(norms, the router, and past ``n_kv_heads`` ranks the KV projections)
lives in ``layers_rep``, replicated over the model axis, whose gradient
the runtime all-reduces over it; the embedding and the cross entropy are
vocab-parallel, and with ``sequence_parallel`` the activations between the
blocks are split over the sequence.  Under expert parallelism (``ep`` >
1) the experts are split over the model axis on their expert dim and the
tokens travel to them and back by two all-to-alls (``models.moe``).
Serving with a model axis, and VLM cross-attention, raise
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
    if cfg.cross_attn_interval > 0:
        raise NotImplementedError(
            "VLM cross-attention is not ported yet (ROADMAP Queue 1 item "
            "14b)")


class DecoderLM:
    def __init__(self, cfg):
        _check_supported(cfg)
        self.cfg = cfg
        self.tp = cfg.parallel.tp
        self.ep = cfg.parallel.ep
        # no VLM cross-attention blocks: one self layer per scanned block
        self.n_blocks = cfg.n_layers
        self.selfs_per_block = 1

    # ---------------- specs ------------------------------------------------
    def _self_layer_specs(self):
        """(specs split over the model axis, replicated specs, outer
        dims): under tp > 1 a tensor with a TP dim is split on it, the
        rest is replicated; at tp = 1 every tensor is in the first list
        (the reference's ``_self_layer_specs``)."""
        cfg = self.cfg
        D, hd = cfg.d_model, cfg.hd
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        tp = self.tp
        kv_dim = 1 if min(tp, Hkv) == tp else None
        sharded, replicated, outer = [], [], {}

        def add(name, shape, dim=None):
            s = spec(cfg, name, shape)
            if tp > 1 and dim is not None:
                outer[name] = ShardDim(dim, "model")
            (replicated if tp > 1 and dim is None else sharded).append(s)

        add("ln1", (D,))
        add("wq", (D, Hq * hd), dim=1)
        add("wk", (D, Hkv * hd), dim=kv_dim)
        add("wv", (D, Hkv * hd), dim=kv_dim)
        if cfg.qkv_bias:
            add("wq_b", (Hq * hd,), dim=0)
            add("wk_b", (Hkv * hd,), dim=None if kv_dim is None else 0)
            add("wv_b", (Hkv * hd,), dim=None if kv_dim is None else 0)
        add("wo", (Hq * hd, D), dim=0)
        if cfg.post_norms:
            add("post_ln1", (D,))
        add("ln2", (D,))
        if cfg.n_experts:
            # the router lives in the layer group; the experts are a group
            # of their own (see groups())
            add("moe_router", (D, cfg.n_experts))
        else:
            add("w1", (D, cfg.d_ff), dim=1)
            if cfg.mlp in ("swiglu", "geglu"):
                add("w3", (D, cfg.d_ff), dim=1)
            add("w2", (cfg.d_ff, D), dim=0)
        if cfg.post_norms:
            add("post_ln2", (D,))
        return sharded, replicated, outer

    def groups(self) -> dict[str, GroupDef]:
        cfg = self.cfg
        sharded, replicated, outer = self._self_layer_specs()
        groups = {"layers": GroupDef(tuple(sharded), n_layers=self.n_blocks,
                                     outer=outer)}
        if replicated:
            groups["layers_rep"] = GroupDef(
                tuple(replicated), n_layers=self.n_blocks,
                replicated_over_model=True)
        if cfg.n_experts:
            E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
            especs = (spec(cfg, "moe_w1", (E, D, F)),
                      spec(cfg, "moe_w3", (E, D, F)),
                      spec(cfg, "moe_w2", (E, F, D)))
            groups["layers_experts"] = GroupDef(
                especs, n_layers=self.n_blocks,
                outer={s.name: ShardDim(0, "model") for s in especs}
                if self.ep > 1 else {})
        gl = [spec(cfg, "emb", (cfg.vocab, cfg.d_model)),
              spec(cfg, "final_ln", (cfg.d_model,))]
        gout = {"emb": ShardDim(0, "model")} if self.tp > 1 else {}
        if not cfg.tie_embeddings:
            gl.append(spec(cfg, "head", (cfg.d_model, cfg.vocab)))
            if self.tp > 1:
                gout["head"] = ShardDim(1, "model")
        groups["globals"] = GroupDef(tuple(gl), outer=gout)
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

    def _self_block(self, pg, p, x, q_pos, window, cache=None,
                    cache_index=0, sp=False):
        """One layer; returns ``(x, aux)``, aux the MoE load-balance term
        (0.0 for a dense layer).  With a ``cache`` (this layer's views) the
        attention writes its keys and values into it in place.  Under
        tensor parallelism the attention and the MLP run between
        ``gather_seq`` and ``reduce_out``; the replicated weights that act
        on the replicated activations enter through ``share_grad``."""
        cfg = self.cfg
        tpg = pg.tp_group

        def rep(name):
            return L.share_grad(p[name], tpg, sp)

        h = L.gather_seq(L.rms_norm(x, rep("ln1"), cfg.norm_eps), tpg, sp)
        out, _ = L.attention(cfg, p, h, q_pos=q_pos, cache=cache,
                             cache_index=cache_index, window=window,
                             tp_group=tpg, sp=sp)
        if cfg.post_norms:
            out = L.rms_norm(out, rep("post_ln1"), cfg.norm_eps)
        x = x + out
        h = L.rms_norm(x, rep("ln2"), cfg.norm_eps)
        if cfg.n_experts:
            out, aux = moe_ffn(cfg, {**p, "moe_router": rep("moe_router")},
                               h, ep=self.ep, ep_group=pg.ep_group)
        else:
            out, aux = L.mlp(cfg, p, L.gather_seq(h, tpg, sp), tp_group=tpg,
                             sp=sp), 0.0
        if cfg.post_norms:
            out = L.rms_norm(out, rep("post_ln2"), cfg.norm_eps)
        return x + out, aux

    def _scan_groups(self) -> list[str]:
        names = ["layers"]
        if self.tp > 1:
            names.append("layers_rep")
        if self.cfg.n_experts:
            names.append("layers_experts")
        return names

    def _backbone(self, pg, x, q_pos, caches=None, cache_index=0, sp=False):
        """The layer stack; returns ``(x, aux)``, aux summed over layers in
        fp32.  ``caches``: the full cache (leading dims n_blocks,
        selfs_per_block), whose per-layer views each layer updates in
        place."""
        def body(p, carry, xs):
            x, aux = carry
            window, cache = xs
            x, a = self._self_block(pg, p, x, q_pos, window, cache,
                                    cache_index, sp)
            return (x, aux + a), None

        windows = self._layer_windows()
        xs = [(w, None if caches is None
               else {k: t[i, 0] for k, t in caches.items()})
              for i, w in enumerate(windows)]
        aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
        (x, aux), _ = pg.scan(self._scan_groups(), body, (x, aux0), xs)
        return x, aux

    def _sp_active(self, T: int) -> bool:
        """Sequence parallelism: the residual stream split over the
        sequence on the TP ranks (Megatron-SP), for multi-token steps whose
        length divides (the reference's rule and message)."""
        sp = self.cfg.parallel.sequence_parallel and self.tp > 1
        if sp and self.cfg.n_experts:
            raise ValueError("sequence_parallel with MoE is not supported")
        return sp and T > 1 and T % self.tp == 0

    def _embed_in(self, pg, tokens, sp=False):
        """The embedding (vocab-parallel under tp: each rank looks up its
        rows, ``reduce_out`` combines them), the gathered ``globals`` and
        this rank's first vocab id."""
        g = pg.globals("globals")
        tpg = pg.tp_group
        vstart = pg.tp_rank * g["emb"].shape[0] if tpg is not None else 0
        x = L.embed(tokens, g["emb"].to(pg.compute_dtype), vstart)
        return L.reduce_out(x, tpg, sp), g, vstart

    def _head_in(self, pg, g, x, sp=False):
        """The final norm's output and the head (this rank's vocab columns
        under tp): the sequence gathered whole before the norm, the
        normed activations entering the head through ``gather_seq``, so
        the norm's weight -- a copy per TP rank in ``globals`` -- gets the
        same whole gradient on every rank."""
        tpg = pg.tp_group
        x = L.gather_seq_whole(x, tpg, sp)
        x = L.gather_seq(L.rms_norm(x, g["final_ln"], self.cfg.norm_eps),
                         tpg, False)
        head = g["emb"].T if self.cfg.tie_embeddings else g["head"]
        return x, head

    def _logits(self, pg, g, x, sp=False):
        x, head = self._head_in(pg, g, x, sp)
        return L.lm_logits(x, head, softcap=self.cfg.final_softcap)

    # ---------------- public API ----------------------------------------------
    def loss(self, pg, batch):
        """(sum of next-token NLL plus the MoE load-balance term weighted
        by tokens / n_layers, number of predicted tokens) of the local
        batch; the runtime normalizes across ranks.  Under tensor
        parallelism every rank of the model axis returns the same sums."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        sp = self._sp_active(T)
        q_pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
        x, g, vstart = self._embed_in(pg, tokens, sp)
        x, aux = self._backbone(pg, x, q_pos, sp=sp)
        cfg = self.cfg
        tpg = pg.tp_group
        ones = torch.ones((B, T - 1), dtype=torch.float32,
                          device=tokens.device)
        if cfg.ce_chunk:
            # vocab-chunked online-logsumexp CE: the (B, T, V) fp32
            # logits never exist
            x, head = self._head_in(pg, g, x, sp)
            nll, w = L.chunked_ce(
                x[:, :-1], head.to(pg.compute_dtype), tokens[:, 1:], ones,
                vocab_chunk=cfg.ce_chunk, softcap=cfg.final_softcap,
                tp_group=tpg, vocab_start=vstart)
        else:
            logits = self._logits(pg, g, x, sp)
            nll, w = L.vocab_parallel_ce(logits[:, :-1], tokens[:, 1:], ones,
                                         tp_group=tpg, vocab_start=vstart)
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
        x, g, _ = self._embed_in(pg, tokens)
        x, _ = self._backbone(pg, x, q_pos, caches=cache, cache_index=0)
        return self._logits(pg, g, x[:, -1:]), cache

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
        x, g, _ = self._embed_in(pg, tokens)
        x, _ = self._backbone(pg, x, q_pos, caches=cache, cache_index=index)
        return self._logits(pg, g, x), cache
