"""Encoder-decoder backbone of SeamlessM4T-medium [arXiv:2308.11596] (port
of ``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, n_frames, d_model).  A
bidirectional encoder runs over the frames; a causal decoder attends to
its own tokens (a ring-buffer KV cache when serving) and, in every layer,
to the encoder's output.  Three groups: ``enc_layers`` and ``dec_layers``
(two stacks, each scanned by the runtime's layer loop, whose schedule
resolves per stack) and ``globals`` (``frame_proj``, ``enc_final_ln``,
``emb``, ``final_ln``, ``head``).

The serve cache holds the decoder's ``k``, ``v`` (n_dec, B, Hkv, S, hd)
bf16 and ``pos`` (n_dec, B, S) int32, and the encoder's output
``memory`` (B, n_frames, d_model) bf16, with no layer dim.  ``prefill``
encodes the frames and writes the memory into the cache (in place; a
memory of another length than the cache's replaces the leaf, as the
reference's returned cache carries it); ``decode`` reads it back,
rounded to bf16, and recomputes each layer's cross K/V from it, as the
reference does.  So at fp32 compute a decode step sees a bf16-rounded
memory where the prefill saw the unrounded one.

No model axis (the reference's ``self.tp = 1``): a config with tensor or
expert parallelism raises.

PARITY: ALLCLOSE at fp32 (``models.layers``' classes);
tests/test_torch_encdec.py states the bounds.
"""
from __future__ import annotations

from typing import Any

import torch

from . import layers as L
from .cache import empty_cache
from .transformer import GroupDef, spec


class EncDecModel:
    def __init__(self, cfg):
        if cfg.parallel.tp > 1 or cfg.parallel.ep > 1:
            raise ValueError(
                f"{cfg.name}: the encoder-decoder runs without a model axis "
                f"(tp={cfg.parallel.tp}, ep={cfg.parallel.ep})")
        self.cfg = cfg
        self.tp = self.ep = 1
        self.n_enc = cfg.encoder_layers
        self.n_dec = cfg.n_layers

    # ------------------------------------------------------------------ #
    def _attn_specs(self, prefix=""):
        cfg = self.cfg
        D, hd = cfg.d_model, cfg.hd
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        return [(prefix + "wq", (D, Hq * hd)), (prefix + "wk", (D, Hkv * hd)),
                (prefix + "wv", (D, Hkv * hd)), (prefix + "wo", (Hq * hd, D))]

    def _mlp_specs(self):
        cfg = self.cfg
        D = cfg.d_model
        return [("ln2", (D,)), ("w1", (D, cfg.d_ff)), ("w3", (D, cfg.d_ff)),
                ("w2", (cfg.d_ff, D))]

    def groups(self) -> dict[str, GroupDef]:
        cfg = self.cfg
        D = cfg.d_model
        enc = [("ln1", (D,))] + self._attn_specs() + self._mlp_specs()
        dec = ([("ln1", (D,))] + self._attn_specs() + [("x_lnq", (D,))]
               + self._attn_specs("x_") + self._mlp_specs())
        return {
            "enc_layers": GroupDef(tuple(spec(cfg, n, s) for n, s in enc),
                                   n_layers=self.n_enc),
            "dec_layers": GroupDef(tuple(spec(cfg, n, s) for n, s in dec),
                                   n_layers=self.n_dec),
            "globals": GroupDef((
                spec(cfg, "frame_proj", (D, D)),
                spec(cfg, "enc_final_ln", (D,)),
                spec(cfg, "emb", (cfg.vocab, D)),
                spec(cfg, "final_ln", (D,)),
                spec(cfg, "head", (D, cfg.vocab)),
            )),
        }

    # ------------------------------------------------------------------ #
    @staticmethod
    def _positions(B: int, T: int, device) -> torch.Tensor:
        return torch.arange(T, device=device)[None].expand(B, T)

    def _encode(self, pg, frames, g):
        """The frame projection, then the bidirectional encoder stack and
        its final norm: (B, F, D) in the compute dtype."""
        cfg = self.cfg
        x = frames.to(pg.compute_dtype) @ g["frame_proj"].to(pg.compute_dtype)
        B, F, _ = x.shape
        pos = self._positions(B, F, x.device)

        def body(p, x, _):
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            out, _ = L.attention(cfg, p, h, q_pos=pos, causal=False)
            x = x + out
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            return x + L.mlp(cfg, p, h), None

        x, _ = pg.scan(["enc_layers"], body, x)
        return L.rms_norm(x, g["enc_final_ln"], cfg.norm_eps)

    def _dec_block(self, p, x, memory, q_pos, cache, cache_index):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        out, _ = L.attention(cfg, p, h, q_pos=q_pos, cache=cache,
                             cache_index=cache_index)
        x = x + out
        x = x + L.cross_attention(cfg, p, x, memory)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(cfg, p, h)

    def _decode_stack(self, pg, x, memory, q_pos, cache=None,
                      cache_index=0):
        """The decoder stack; ``cache``'s per-layer views are written in
        place."""
        def body(p, x, c):
            return self._dec_block(p, x, memory, q_pos, c, cache_index), None

        xs = None if cache is None else [
            {k: cache[k][i] for k in ("k", "v", "pos")}
            for i in range(self.n_dec)]
        x, _ = pg.scan(["dec_layers"], body, x, xs)
        return x

    def _head(self, g, x):
        x = L.rms_norm(x, g["final_ln"], self.cfg.norm_eps)
        return L.lm_logits(x, g["head"])

    # ------------------------------------------------------------------ #
    def loss(self, pg, batch):
        """(sum of next-token NLL, number of predicted tokens) of the local
        batch; the runtime normalizes across ranks."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        g = pg.globals("globals")
        memory = self._encode(pg, batch["frames"], g)
        x = L.embed(tokens, g["emb"].to(pg.compute_dtype))
        x = self._decode_stack(pg, x, memory,
                               self._positions(B, T, tokens.device))
        logits = self._head(g, x)
        ones = torch.ones((B, T - 1), dtype=torch.float32,
                          device=tokens.device)
        return L.vocab_parallel_ce(logits[:, :-1], tokens[:, 1:], ones)

    def cache_shapes(self, batch: int, seq_len: int) -> dict[str, Any]:
        cfg = self.cfg
        kv = (self.n_dec, batch, cfg.n_kv_heads, seq_len, cfg.hd)
        return {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16),
                "pos": ((self.n_dec, batch, seq_len), torch.int32),
                "memory": ((batch, cfg.n_frames, cfg.d_model),
                           torch.bfloat16)}

    def cache_batch_dims(self) -> dict[str, int]:
        """Batch-dim index of each cache leaf (the memory has no layer
        dim)."""
        return {"k": 1, "v": 1, "pos": 1, "memory": 0}

    def cache_fill(self) -> dict:
        """The value of each leaf in an empty cache: ``pos`` -1, the rest
        0."""
        return {"k": 0, "v": 0, "pos": -1, "memory": 0}

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> dict:
        """An empty cache (``cache_fill``), on the card unless ``device``
        says otherwise."""
        return empty_cache(self.cache_shapes(batch, seq_len),
                           self.cache_fill(), device)

    def prefill(self, pg, batch, cache):
        """Encode ``batch["frames"]`` into the cache's memory and run the
        prompt ``batch["tokens"]`` (B, T) from position 0 through the
        decoder, filling its KV cache in place.  Returns ``(logits (B, 1,
        V) of the last position, cache)``."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        g = pg.globals("globals")
        memory = self._encode(pg, batch["frames"], g)
        x = L.embed(tokens, g["emb"].to(pg.compute_dtype))
        x = self._decode_stack(pg, x, memory,
                               self._positions(B, T, tokens.device),
                               cache, 0)
        if cache["memory"].shape == memory.shape:
            cache["memory"].copy_(memory)
        else:
            cache["memory"] = memory.to(torch.bfloat16)
        return self._head(g, x[:, -1:]), cache

    def decode(self, pg, batch, cache, index):
        """One token per row (``batch["tokens"]`` (B, 1)) against the
        cache's decoder KV and its bf16 memory.  ``index``: an int, or a
        (B,) integer tensor of per-row positions.  Returns ``(logits (B,
        1, V), cache)``."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            q_pos = index.to(device=tokens.device, dtype=torch.int64)[:, None]
        else:
            q_pos = torch.full((B, 1), int(index), dtype=torch.int64,
                               device=tokens.device)
        g = pg.globals("globals")
        memory = cache["memory"].to(pg.compute_dtype)
        x = L.embed(tokens, g["emb"].to(pg.compute_dtype))
        x = self._decode_stack(pg, x, memory, q_pos, cache, index)
        return self._head(g, x), cache
