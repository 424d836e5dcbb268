"""Model-layer primitives of the dense decoder, for training and serving
(port of ``repro/models/layers.py``).

Conventions kept from the reference so the tests compare like with like:
  * linear weights are (d_in, d_out); y = x @ w
  * attention tensors are (B, T, H, hd) at rest, (B, H, T, hd) in flight
  * softmax/normalizer math runs in float32 whatever the compute dtype
  * attention is chunked over the keys with an online softmax, as the
    reference's ``lax.scan`` over KV blocks; it is plain tensor code in the
    reference too (no Pallas kernel), and SDPA cannot stand in for it: it
    has no logit softcap
  * tensor parallelism (``tp_axis``) is not ported: every collective of the
    reference's layers is the identity here, and the replicated-KV branch
    of ``attention`` (tp > n_kv_heads) comes with it (ROADMAP Queue 1 item
    18; ``DecoderLM`` refuses tp > 1 at construction)
  * serving: ``attention`` keeps a ring-buffer KV cache, updated in place;
    ``dense`` multiplies a gathered-but-still-int8 weight (``QuantTensor``)
    through ``ops.q8_matmul``

PARITY: ALLCLOSE -- fp32 compute agrees with the reference to float
rounding (transcendentals and matmul sums differ in the last bits); bf16
compute rounds at the same points but the two frameworks' bf16 kernels
differ, so bf16 agreement is looser (see tests/test_torch_model.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -1e30


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``y = x @ w`` with weight-format dispatch: a plain tensor is cast to
    the activation dtype; a ``QuantTensor`` (a gathered q8_block weight in
    the serve quant mode) goes through the int8 x int8 GEMM
    (``ops.q8_matmul``), so the dense weight never materializes."""
    if isinstance(w, ops.QuantTensor):
        return ops.q8_matmul(x, w.codes, w.scales, w.block)
    return x @ w.to(x.dtype)


def to_dense(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight in ``dtype``, for call sites that must slice or transpose
    the weight itself: a ``QuantTensor`` takes one per-tensor
    ``ops.dequantize_into``, a plain tensor is cast."""
    if isinstance(w, ops.QuantTensor):
        k, n = w.shape
        return ops.dequantize_into(w.codes.reshape(-1), w.scales, w.block,
                                   out_dtype=dtype).reshape(k, n)
    return w.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 RMS norm times ``(1 + scale)``, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, H, T, hd); positions: (B, T) int.  Rotates the first half of
    the head dim against the second half (not interleaved), fp32 angles."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[:, None, :, None].float() * freqs  # (B, 1, T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                      window=None, softcap=None,
                      chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax GQA attention over KV chunks.

    q: (B, Hq, Tq, hd); k, v: (B, Hkv, Tk, hd); q_pos: (B, Tq) and kv_pos:
    (B, Tk) int positions; ``kv_valid``: (B, Tk) bool or None (a KV cache's
    occupancy); ``window``: int or None.  Scores are fp32 (q and k cast
    before the product), scaled by 1/sqrt(hd), then soft-capped, then
    masked -- the reference's order.  The last chunk is cut short where
    the reference pads it with invalid keys (which weigh exactly 0)."""
    B, Hq, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Tk)

    qg = q.reshape(B, Hkv, group, Tq, hd).float()
    m = torch.full((B, Hkv, group, Tq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, group, Tq), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((B, Hkv, group, Tq, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, Tk, chunk):
        k_i = k[:, :, lo:lo + chunk].float()
        v_i = v[:, :, lo:lo + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_i) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        qp = q_pos[:, None, None, :, None]
        kp = kv_pos[:, lo:lo + chunk][:, None, None, None, :]
        mask = kp <= qp
        if kv_valid is not None:
            mask = mask & kv_valid[:, lo:lo + chunk][:, None, None, None, :]
        if window is not None:
            mask = mask & (qp - kp < window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v_i)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, Hq, Tq, hd).to(q.dtype)


def attention(cfg, p, x: torch.Tensor, *, q_pos: torch.Tensor,
              cache=None, cache_index=0, window=None, prefix: str = ""):
    """Causal self-attention (GQA, tp=1; with ``cfg.qkv_bias`` the q, k
    and v projections add their biases ``wq_b``/``wk_b``/``wv_b``) with an
    optional ring-buffer KV cache.  Returns ``(out, cache)``; ``cache`` is
    None without one.

    ``cache``: None (training) or ``{"k", "v": (B, Hkv, W, hd), "pos":
    (B, W) int32}`` with ``pos`` -1 where a slot is empty.  The new keys
    (after RoPE) and values are written at slot ``cache_index % W``:
    ``cache_index`` is an int (prefill at 0 with T <= W, or a decode step
    with T = 1; the write start clamps so the T entries fit, as
    ``lax.dynamic_update_slice`` does) or a (B,) integer tensor of per-row
    positions (continuous-batching decode: each row writes its own slot).
    Validity and causality then come from the stored positions.  The cache
    tensors are updated IN PLACE (the reference donates them to the decode
    step, ``core/fsdp.py:814``) and returned."""
    B, T, _ = x.shape
    hd = cfg.hd

    def proj(name, h):
        y = dense(x, p[prefix + name])
        if cfg.qkv_bias and prefix + name + "_b" in p:
            # after the product, in the serve quant mode too (the bias is
            # a 1-D tensor, so ``unpack_quant`` hands it over dense)
            y = y + p[prefix + name + "_b"].to(x.dtype)
        return y.reshape(B, T, h, hd).transpose(1, 2)

    q = rope(proj("wq", cfg.n_heads), q_pos, cfg.rope_theta)
    k = rope(proj("wk", cfg.n_kv_heads), q_pos, cfg.rope_theta)
    v = proj("wv", cfg.n_kv_heads)
    if cache is None:
        out = chunked_attention(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                                window=window, softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        W = ck.shape[2]
        if T > W:
            raise ValueError(f"{T} new positions do not fit a cache of {W}")
        new_pos = q_pos[:, :T].to(cpos.dtype)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            start = torch.clamp(cache_index.to(torch.int64) % W, max=W - T)
            cols = start[:, None] + torch.arange(T, device=start.device)
            rows = torch.arange(B, device=start.device)[:, None]
            ck[rows, :, cols] = k.transpose(1, 2).to(ck.dtype)
            cv[rows, :, cols] = v.transpose(1, 2).to(cv.dtype)
            cpos[rows, cols] = new_pos
        else:
            start = min(int(cache_index) % W, W - T)
            ck[:, :, start:start + T] = k.to(ck.dtype)
            cv[:, :, start:start + T] = v.to(cv.dtype)
            cpos[:, start:start + T] = new_pos
        out = chunked_attention(q, ck, cv, q_pos=q_pos, kv_pos=cpos,
                                kv_valid=cpos >= 0, window=window,
                                softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)
    return dense(out, p[prefix + "wo"]), cache


def mlp(cfg, p, x: torch.Tensor, *, prefix: str = "") -> torch.Tensor:
    """The dense feed-forward of ``cfg.mlp``: swiglu (silu gate), geglu
    (``jax.nn.gelu(approximate=True)`` is the tanh form) or squared_relu
    (nemotron-4, no gate projection)."""
    if cfg.mlp == "swiglu":
        h = F.silu(dense(x, p[prefix + "w1"])) * dense(x, p[prefix + "w3"])
    elif cfg.mlp == "geglu":
        h = (F.gelu(dense(x, p[prefix + "w1"]), approximate="tanh")
             * dense(x, p[prefix + "w3"]))
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(dense(x, p[prefix + "w1"])))
    else:
        raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
    return dense(h, p[prefix + "w2"])


def embed(tokens: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """emb: (V, D).  Out-of-range ids embed to zero, as the reference's
    masked take.  ``F.embedding``, not ``emb[ids]``: the gradient of an
    index is a parallel atomic ``index_put_`` on the CPU, whose sum order
    changes from run to run; the embedding's backward adds each row's
    contributions in token order on the CPU and deterministically on the
    card."""
    ok = (tokens >= 0) & (tokens < emb.shape[0])
    x = F.embedding(tokens.clamp(0, emb.shape[0] - 1), emb)
    return torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def lm_logits(x: torch.Tensor, head: torch.Tensor, *,
              softcap=None) -> torch.Tensor:
    """Logits in the compute dtype; the final softcap is applied in that
    dtype too, before the cross entropy casts to fp32."""
    logits = x @ head.to(x.dtype)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor):
    """fp32 cross entropy over (B, T, V) logits (the reference's
    ``tp_axis=None`` branch).  Returns (sum_loss, sum_weight)."""
    lg = logits.float()
    m = lg.amax(dim=-1).detach()  # stabilizer only: a constant shift
    sumexp = torch.exp(lg - m[..., None]).sum(dim=-1)
    ok = (labels >= 0) & (labels < lg.shape[-1])
    picked = torch.gather(lg, -1, labels.clamp(0, lg.shape[-1] - 1)
                          [..., None])[..., 0]
    label_logit = torch.where(ok, picked, torch.zeros_like(picked))
    nll = torch.log(sumexp) + m - label_logit
    return (nll * mask).sum(), mask.sum()
