"""Recurrent-family models (port of ``repro/models/recurrent.py``): xLSTM
(sLSTM + mLSTM stacks) and Hymba (parallel attention + Mamba heads per
layer).

Both decode from an O(1) recurrent state (Hymba's attention beside it from
a ring-buffer KV cache), which is what makes the ``long_500k`` shape
runnable.  Their parameter trees are ragged-packed like the decoder's: a
``layers`` group stacked over the scanned blocks and a ``globals`` group.

The serve cache is a two-level dict stacked over the blocks
(``models.cache``).  The port's serve contract writes the cache in place
(``core.fsdp``: the runtime ignores the cache a step returns), so each
block copies its new states into its own rows of the cache; the
reference returns them as the layer scan's outputs.  A prefill continues
from the cache's state, as the reference's does (xLSTM's ``decode`` is
its ``prefill``).

Neither family has a model axis (the reference's ``self.tp = 1``): a
config with tensor or expert parallelism raises.

Hymba's cached conv window is fp32 (``cache_shapes``), where the
reference declares bf16: the reference's serve steps return it in the
compute dtype, so its fp32 runs carry it unrounded after the first call,
and its bf16 runs carry bf16 values, which fp32 holds exactly.  The port's
in-place cache thus carries what the reference's carries at either
compute dtype (ROADMAP Queue 3).

PARITY: ALLCLOSE at fp32 (``models.ssm``'s classes; the attention's as in
``models.layers``, its bf16 KV cache included); tests/test_torch_recurrent.py
states the bounds.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from . import layers as L
from .cache import copy_into, empty_cache, row, tree_map
from .ssm import (SLSTM_M0, mamba_mix, mamba_param_shapes, mlstm_mix,
                  mlstm_param_shapes, slstm_mix, slstm_param_shapes)
from .transformer import GLOBAL_WINDOW, GroupDef, spec


def _check_no_model_axis(cfg) -> None:
    if cfg.parallel.tp > 1 or cfg.parallel.ep > 1:
        raise ValueError(
            f"{cfg.name}: the recurrent families run without a model axis "
            f"(tp={cfg.parallel.tp}, ep={cfg.parallel.ep})")


def _globals_group(cfg) -> GroupDef:
    D = cfg.d_model
    return GroupDef((spec(cfg, "emb", (cfg.vocab, D)),
                     spec(cfg, "final_ln", (D,)),
                     spec(cfg, "head", (D, cfg.vocab))))


class _Recurrent:
    """What both families share: the embedding, the head and the loss."""

    def _embed(self, pg, tokens):
        g = pg.globals("globals")
        return L.embed(tokens, g["emb"].to(pg.compute_dtype)), g

    def _head(self, g, x):
        x = L.rms_norm(x, g["final_ln"], self.cfg.norm_eps)
        return L.lm_logits(x, g["head"])

    def loss(self, pg, batch):
        """(sum of next-token NLL, number of predicted tokens) of the local
        batch; the runtime normalizes across ranks."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        x, g = self._embed(pg, tokens)
        x = self._backbone(pg, x, self._positions(tokens, 0))
        logits = self._head(g, x)
        ones = torch.ones((B, T - 1), dtype=torch.float32,
                          device=tokens.device)
        return L.vocab_parallel_ce(logits[:, :-1], tokens[:, 1:], ones)

    def cache_batch_dims(self) -> dict:
        """Batch-dim index of each cache leaf (one per group of leaves)."""
        return {grp: tree_map(lambda _: self._bdims[grp], sub)
                for grp, sub in self.cache_fill().items()}

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> dict:
        """An empty cache (every leaf at ``cache_fill``), on the card
        unless ``device`` says otherwise."""
        return empty_cache(self.cache_shapes(batch, seq_len),
                           self.cache_fill(), device)

    @staticmethod
    def _positions(tokens, start: int):
        B, T = tokens.shape
        return torch.arange(start, start + T,
                            device=tokens.device)[None].expand(B, T)


class XLSTMModel(_Recurrent):
    """xLSTM-125m [arXiv:2405.04517]: super-blocks of (slstm_every - 1)
    mLSTM blocks followed by one sLSTM block, scanned over.  Stabilised
    sigmoid gating replaces the paper's exponential gating (the
    reference's DESIGN.md)."""

    def __init__(self, cfg):
        _check_no_model_axis(cfg)
        self.cfg = cfg
        k = cfg.slstm_every or cfg.n_layers
        if cfg.n_layers % k:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by "
                f"slstm_every={k}")
        self.per_block = k
        self.n_blocks = cfg.n_layers // k
        self.tp = self.ep = 1
        # the batch dim of each cache leaf: the mLSTM leaves carry the
        # block's (per_block - 1) cells before it
        self._bdims = {"m": 2, "s": 1}

    def groups(self) -> dict[str, GroupDef]:
        cfg = self.cfg
        D = cfg.d_model
        specs = []
        for i in range(self.per_block - 1):
            specs.append(spec(cfg, f"m{i}_ln", (D,)))
            for n, s in mlstm_param_shapes(cfg, D, prefix=f"m{i}_").items():
                specs.append(spec(cfg, n, s))
        specs.append(spec(cfg, "s_ln", (D,)))
        for n, s in slstm_param_shapes(cfg, D, prefix="s_").items():
            specs.append(spec(cfg, n, s))
        return {"layers": GroupDef(tuple(specs), n_layers=self.n_blocks),
                "globals": _globals_group(cfg)}

    def _block(self, p, x, states):
        """One super-block; with ``states`` (this block's cache rows) each
        cell continues from its state and writes the new one there."""
        cfg = self.cfg
        for i in range(self.per_block - 1):
            st = None if states is None else row(states["m"], i)
            h = L.rms_norm(x, p[f"m{i}_ln"], cfg.norm_eps)
            out, ns = mlstm_mix(cfg, p, h, state=st, prefix=f"m{i}_")
            x = x + out
            if st is not None:
                copy_into(st, ns)
        st = None if states is None else states["s"]
        h = L.rms_norm(x, p["s_ln"], cfg.norm_eps)
        out, ns = slstm_mix(cfg, p, h, state=st, prefix="s_")
        if st is not None:
            copy_into(st, ns)
        return x + out

    def _backbone(self, pg, x, q_pos, cache=None):
        del q_pos  # position-free

        def body(p, x, states):
            return self._block(p, x, states), None

        xs = None if cache is None else [row(cache, i)
                                         for i in range(self.n_blocks)]
        x, _ = pg.scan(["layers"], body, x, xs)
        return x

    def cache_shapes(self, batch: int, seq_len: int) -> dict[str, Any]:
        cfg = self.cfg
        H = cfg.n_heads
        hd = cfg.d_model // H
        nm = self.per_block - 1
        f32 = torch.float32
        return {
            "m": {"C": ((self.n_blocks, nm, batch, H, hd, hd), f32),
                  "n": ((self.n_blocks, nm, batch, H, hd), f32)},
            "s": {k: ((self.n_blocks, batch, H, hd), f32)
                  for k in ("c", "n", "m")},
        }

    def cache_fill(self) -> dict:
        """The value of each leaf in an empty cache: zeros, the sLSTM
        stabiliser at -1e30 (``slstm_mix``'s start)."""
        return {"m": {"C": 0.0, "n": 0.0},
                "s": {"c": 0.0, "n": 0.0, "m": SLSTM_M0}}

    def prefill(self, pg, batch, cache):
        """The prompt ``batch["tokens"]`` (B, T), continuing from the
        cache's state and leaving the new state there.  Returns (logits
        (B, 1, V) of the last position, cache)."""
        x, g = self._embed(pg, batch["tokens"])
        x = self._backbone(pg, x, None, cache)
        return self._head(g, x[:, -1:]), cache

    def decode(self, pg, batch, cache, index):
        """One token a row from the cache's state (``index`` is unused: the
        state holds the position)."""
        del index
        return self.prefill(pg, batch, cache)


class HymbaModel(_Recurrent):
    """Hymba-1.5B [arXiv:2411.13676]: each layer runs attention and a Mamba
    head in parallel on the same input; their outputs are normed and
    averaged.  Sliding-window attention everywhere but three global layers
    (first, middle, last).  Meta tokens are omitted (the reference's)."""

    def __init__(self, cfg):
        _check_no_model_axis(cfg)
        self.cfg = cfg
        self.n_blocks = cfg.n_layers
        self.tp = self.ep = 1
        self.d_inner = cfg.n_heads * cfg.hd
        self._bdims = {"attn": 1, "ssm": 1}

    def groups(self) -> dict[str, GroupDef]:
        cfg = self.cfg
        D, hd = cfg.d_model, cfg.hd
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        specs = [
            spec(cfg, "ln1", (D,)),
            spec(cfg, "wq", (D, Hq * hd)),
            spec(cfg, "wk", (D, Hkv * hd)),
            spec(cfg, "wv", (D, Hkv * hd)),
            spec(cfg, "wo", (Hq * hd, D)),
            spec(cfg, "attn_n", (Hq * hd,)),
            spec(cfg, "ssm_n", (self.d_inner,)),
            spec(cfg, "ln2", (D,)),
            spec(cfg, "w1", (D, cfg.d_ff)),
            spec(cfg, "w3", (D, cfg.d_ff)),
            spec(cfg, "w2", (cfg.d_ff, D)),
        ]
        for n, s in mamba_param_shapes(cfg, D, d_inner=self.d_inner).items():
            specs.append(spec(cfg, n, s))
        return {"layers": GroupDef(tuple(specs), n_layers=self.n_blocks),
                "globals": _globals_group(cfg)}

    def _layer_windows(self) -> list[int]:
        """The sliding window on every layer but the global first, middle
        and last ones."""
        cfg = self.cfg
        w = [cfg.sliding_window or GLOBAL_WINDOW] * cfg.n_layers
        for i in (0, cfg.n_layers // 2, cfg.n_layers - 1):
            w[i] = GLOBAL_WINDOW
        return w

    def _block(self, p, x, q_pos, window, cache, cache_index):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out = self._attn_branch(p, h, q_pos, window,
                                     None if cache is None else cache["attn"],
                                     cache_index)
        st = None if cache is None else cache["ssm"]
        ssm_out, ns = mamba_mix(cfg, p, h, state=st, d_inner=self.d_inner)
        if st is not None:
            copy_into(st, ns)
        fused = 0.5 * (L.rms_norm(attn_out, p["attn_n"], cfg.norm_eps)
                       + L.rms_norm(ssm_out, p["ssm_n"], cfg.norm_eps))
        x = x + fused @ p["wo"].to(x.dtype)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        up = F.silu(h @ p["w1"].to(x.dtype)) * (h @ p["w3"].to(x.dtype))
        return x + up @ p["w2"].to(x.dtype)

    def _attn_branch(self, p, h, q_pos, window, cache, cache_index):
        """Attention without the output projection (applied after the
        fusion with the Mamba branch); with a ``cache`` the new keys and
        values are written into it (``layers.cache_write``)."""
        cfg = self.cfg
        B, T, _ = h.shape
        hd = cfg.hd

        def proj(name, heads):
            return (h @ p[name].to(h.dtype)).reshape(
                B, T, heads, hd).transpose(1, 2)

        q = L.rope(proj("wq", cfg.n_heads), q_pos, cfg.rope_theta)
        k = L.rope(proj("wk", cfg.n_kv_heads), q_pos, cfg.rope_theta)
        v = proj("wv", cfg.n_kv_heads)
        if cache is None:
            out = L.chunked_attention(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                                      window=window)
        else:
            L.cache_write(cache, k, v, q_pos, cache_index)
            out = L.chunked_attention(q, cache["k"], cache["v"], q_pos=q_pos,
                                      kv_pos=cache["pos"],
                                      kv_valid=cache["pos"] >= 0,
                                      window=window)
        return out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)

    def _backbone(self, pg, x, q_pos, cache=None, cache_index=0):
        def body(p, x, xs):
            window, layer_cache = xs
            return self._block(p, x, q_pos, window, layer_cache,
                               cache_index), None

        xs = [(w, None if cache is None else row(cache, i))
              for i, w in enumerate(self._layer_windows())]
        x, _ = pg.scan(["layers"], body, x, xs)
        return x

    def cache_window(self, seq_len: int) -> int:
        """Ring-buffer size: capped at the sliding window only past 65,536
        positions, on every layer, the global ones too (the reference's
        sliding-window cache variant, kept for parity)."""
        if self.cfg.sliding_window and seq_len > 65536:
            return self.cfg.sliding_window
        return seq_len

    def cache_shapes(self, batch: int, seq_len: int) -> dict[str, Any]:
        cfg = self.cfg
        W = self.cache_window(seq_len)
        Lb = self.n_blocks
        kv = ((Lb, batch, cfg.n_kv_heads, W, cfg.hd), torch.bfloat16)
        return {
            "attn": {"k": kv, "v": kv, "pos": ((Lb, batch, W), torch.int32)},
            # fp32, where the reference declares bf16: its serve steps
            # return the conv window in the compute dtype, so an fp32 run
            # carries it unrounded; fp32 holds a bf16 window exactly
            "ssm": {"conv": ((Lb, batch, cfg.conv_kernel - 1, self.d_inner),
                             torch.float32),
                    "ssm": ((Lb, batch, self.d_inner, cfg.ssm_state),
                            torch.float32)},
        }

    def cache_fill(self) -> dict:
        """The value of each leaf in an empty cache: ``pos`` -1 (no slot
        filled), everything else zeros."""
        return {"attn": {"k": 0, "v": 0, "pos": -1},
                "ssm": {"conv": 0, "ssm": 0}}

    def prefill(self, pg, batch, cache):
        """The prompt ``batch["tokens"]`` (B, T) from position 0 (the Mamba
        state continuing from the cache's).  Returns (logits (B, 1, V) of
        the last position, cache)."""
        tokens = batch["tokens"]
        x, g = self._embed(pg, tokens)
        x = self._backbone(pg, x, self._positions(tokens, 0), cache, 0)
        return self._head(g, x[:, -1:]), cache

    def decode(self, pg, batch, cache, index):
        """One token a row at position ``index``: an int, or a (B,)
        integer tensor of per-row positions (continuous batching)."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            q_pos = index.to(device=tokens.device, dtype=torch.int64)[:, None]
        else:
            q_pos = torch.full((B, 1), int(index), dtype=torch.int64,
                               device=tokens.device)
        x, g = self._embed(pg, tokens)
        x = self._backbone(pg, x, q_pos, cache, index)
        return self._head(g, x), cache
