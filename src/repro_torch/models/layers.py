"""Model-layer primitives of the dense training path (port of
``repro/models/layers.py``).

Conventions kept from the reference so the tests compare like with like:
  * linear weights are (d_in, d_out); y = x @ w
  * attention tensors are (B, T, H, hd) at rest, (B, H, T, hd) in flight
  * softmax/normalizer math runs in float32 whatever the compute dtype
  * attention is chunked over the keys with an online softmax, as the
    reference's ``lax.scan`` over KV blocks; it is plain tensor code in the
    reference too (no Pallas kernel), and SDPA cannot stand in for it: it
    has no logit softcap
  * tensor parallelism (``tp_axis``) is not ported: every collective of the
    reference's layers is the identity here (ROADMAP Queue 1 item 18)

PARITY: ALLCLOSE -- fp32 compute agrees with the reference to float
rounding (transcendentals and matmul sums differ in the last bits); bf16
compute rounds at the same points but the two frameworks' bf16 kernels
differ, so bf16 agreement is looser (see tests/test_torch_model.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` with the weight cast to the activation dtype."""
    return x @ w.to(x.dtype)


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


def chunked_attention(q, k, v, *, q_pos, kv_pos, window=None,
                      softcap=None, chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax GQA attention over KV chunks.

    q: (B, Hq, Tq, hd); k, v: (B, Hkv, Tk, hd); q_pos/kv_pos: (B, T) int
    positions; ``window``: int or None.  Scores are
    fp32 (q and k cast before the product), scaled by 1/sqrt(hd), then
    soft-capped, then masked -- the reference's order."""
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
              window=None, prefix: str = "") -> torch.Tensor:
    """Causal self-attention of the training path (no KV cache, tp=1)."""
    B, T, _ = x.shape
    hd = cfg.hd

    def proj(name, h):
        y = dense(x, p[prefix + name])
        return y.reshape(B, T, h, hd).transpose(1, 2)

    q = rope(proj("wq", cfg.n_heads), q_pos, cfg.rope_theta)
    k = rope(proj("wk", cfg.n_kv_heads), q_pos, cfg.rope_theta)
    v = proj("wv", cfg.n_kv_heads)
    out = chunked_attention(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                            window=window, softcap=cfg.attn_softcap,
                            chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)
    return dense(out, p[prefix + "wo"])


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
    masked take."""
    ok = (tokens >= 0) & (tokens < emb.shape[0])
    x = emb[tokens.clamp(0, emb.shape[0] - 1)]
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
