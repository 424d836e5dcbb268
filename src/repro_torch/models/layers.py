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
  * tensor parallelism: ``tp_group`` is the process group of the model
    axis or None (no collective runs).  The reference's collectives
    (``psum``, ``reduce_out``, ``gather_seq``) are written as autograd
    Functions in Megatron's conjugate pairs -- ``reduce_out``: all-reduce
    forward, identity backward (under sequence parallelism: reduce-scatter
    over the sequence forward, all-gather backward); ``gather_seq``, at the
    input of each column-parallel product: identity forward, all-reduce
    backward (all-gather forward, reduce-scatter backward) -- so every TP
    rank holds the one-device gradient of what it computes.  The
    reference's ``psum`` transposes to ``psum`` under its shard_map, which
    sums a replicated cotangent once per model rank (ROADMAP Queue 3); the
    port does not copy that
  * serving: ``attention`` keeps a ring-buffer KV cache, updated in place;
    ``dense`` multiplies a gathered-but-still-int8 weight (``QuantTensor``)
    through ``ops.q8_matmul``
  * ``chunked_ce``, the vocab-chunked cross entropy, never materializes
    the (B, T, V) logits: each chunk's head product runs inside an
    activation checkpoint

PARITY: ALLCLOSE -- fp32 compute agrees with the reference to float
rounding (transcendentals and matmul sums differ in the last bits); bf16
compute rounds at the same points but the two frameworks' bf16 kernels
differ, so bf16 agreement is looser (see tests/test_torch_model.py).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# tensor-parallel collectives (Megatron's conjugate pairs)
# ---------------------------------------------------------------------------

# the single-tensor collectives were renamed; take the current spelling
# where the installed torch has it (as core.wire does)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(B, t, ...) per rank -> (B, n * t, ...), rank-major on dim 1."""
    n = _tp_size(group)
    x = x.detach().contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _all_gather(out.view(-1), x.view(-1), group=group)
    return out.movedim(0, 1).reshape(
        (x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))


def _seq_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T, ...) per rank -> this rank's (B, T / n, ...) rows of dim 1,
    summed over the ranks."""
    n, B, T = _tp_size(group), x.shape[0], x.shape[1]
    if T % n:
        raise ValueError(f"sequence {T} does not split over {n} TP ranks")
    chunks = x.detach().reshape((B, n, T // n) + tuple(x.shape[2:])) \
        .movedim(1, 0).contiguous()
    out = torch.empty(chunks.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter(out.view(-1), chunks.view(-1), op=dist.ReduceOp.SUM,
                    group=group)
    return out


def _seq_slice(x: torch.Tensor, group) -> torch.Tensor:
    n = _tp_size(group)
    t = x.shape[1] // n
    return x.narrow(1, dist.get_rank(group) * t, t).contiguous()


class _ReduceOut(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _CopyIn(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter over the sequence forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _seq_all_gather(ct, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """All-gather over the sequence forward; backward reduce-scatters a
    partial cotangent (``reduce``) or takes this rank's rows of a whole
    one."""

    @staticmethod
    def forward(ctx, x, group, reduce):
        ctx.group, ctx.reduce = group, reduce
        return _seq_all_gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        if ctx.reduce:
            return _seq_reduce_scatter(ct, ctx.group), None, None
        return _seq_slice(ct, ctx.group), None, None


class _ShareGrad(torch.autograd.Function):
    """Identity forward; backward divides the gradient by the TP size."""

    @staticmethod
    def forward(ctx, w, n):
        ctx.n = n
        return w.view_as(w)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the TP ranks (all-reduce forward, identity backward: each
    rank's cotangent is already the whole one)."""
    return x if group is None else _ReduceOut.apply(x, group)


def reduce_out(x: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """Row-parallel output reduction: ``psum``, or under sequence
    parallelism a reduce-scatter over the sequence (dim 1), so activations
    between blocks stay split over the TP ranks."""
    if group is None:
        return x
    return _ScatterSeq.apply(x, group) if sp else _ReduceOut.apply(x, group)


def gather_seq(x: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """The conjugate of ``reduce_out`` at the input of column-parallel
    products: under sequence parallelism an all-gather of the sequence
    whose backward reduce-scatters the ranks' partial cotangents; without
    it, the identity whose backward all-reduces them."""
    if group is None:
        return x
    return _GatherSeq.apply(x, group, True) if sp else _CopyIn.apply(x, group)


def gather_seq_whole(x: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """All-gather the sequence where the cotangent that comes back is the
    same whole one on every rank (before the final norm, whose output
    enters the head through ``gather_seq``): backward takes this rank's
    rows."""
    if group is None or not sp:
        return x
    return _GatherSeq.apply(x, group, False)


def share_grad(w: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """A replicated weight applied to the same replicated activations on
    every TP rank (no sequence parallelism) gets the same whole gradient
    on each; the runtime all-reduces a ``layers_rep`` gradient over the
    model axis (each rank's part of it), so such a weight enters through
    here and each rank's gradient is divided by the TP size."""
    if group is None or sp:
        return w
    return _ShareGrad.apply(w, _tp_size(group))


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Max over the TP ranks, no gradient (a stabilizer)."""
    if group is None:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.MAX)


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


def chunked_attention(q, k, v, *, q_pos=None, kv_pos=None, kv_valid=None,
                      window=None, softcap=None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax GQA attention over KV chunks: causal, or with
    ``q_pos`` None non-causal (the encoder's self-attention and the
    cross-attention: no positional mask, the reference's form).

    q: (B, Hq, Tq, hd); k, v: (B, Hkv, Tk, hd); q_pos: (B, Tq) and kv_pos:
    (B, Tk) int positions; ``kv_valid``: (B, Tk) bool or None (a KV cache's
    occupancy); ``window``: int or None, applied with the positions.
    Scores are fp32 (q and k cast before the product), scaled by
    1/sqrt(hd), then soft-capped, then masked -- the reference's order.
    The last chunk is cut short where the reference pads it with invalid
    keys (which weigh exactly 0)."""
    B, Hq, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Tk)
    causal = q_pos is not None and kv_pos is not None

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
        mask = None
        if causal:
            qp = q_pos[:, None, None, :, None]
            kp = kv_pos[:, lo:lo + chunk][:, None, None, None, :]
            mask = kp <= qp
            if window is not None:
                mask = mask & (qp - kp < window)
        if kv_valid is not None:
            ok = kv_valid[:, lo:lo + chunk][:, None, None, None, :]
            mask = ok if mask is None else mask & ok
        if mask is not None:
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


def tp_head_counts(n_heads: int, n_kv: int, tp: int
                   ) -> tuple[int, int, bool]:
    """Local (q heads, KV heads in the weight, KV replicated).  tp <= n_kv:
    the KV projections are split over the TP ranks like Q (n_kv / tp heads
    each).  tp > n_kv: the KV weights are replicated (the ``layers_rep``
    group) and each rank computes the one KV head its q heads read, from
    a column slice of the weight.  The reference's rule and messages."""
    if n_heads % tp:
        raise ValueError(f"n_heads={n_heads} not divisible by tp={tp}")
    if tp <= n_kv:
        if n_kv % tp:
            raise ValueError(f"n_kv_heads={n_kv} not divisible by tp={tp}")
        return n_heads // tp, n_kv // tp, False
    if tp % n_kv:
        raise ValueError(f"tp={tp} not divisible by n_kv_heads={n_kv}")
    return n_heads // tp, n_kv, True


def attention(cfg, p, x: torch.Tensor, *, q_pos: torch.Tensor,
              cache=None, cache_index=0, window=None, prefix: str = "",
              tp_group=None, sp: bool = False, causal: bool = True):
    """Self-attention (GQA; with ``cfg.qkv_bias`` the q, k and v
    projections add their biases ``wq_b``/``wk_b``/``wv_b``) with an
    optional ring-buffer KV cache.  Causal, or with ``causal=False`` and
    no cache bidirectional (the encoder's; RoPE is applied all the same,
    as the reference does).  Returns ``(out, cache)``; ``cache`` is None
    without one.  ``prefix`` names a VLM self layer's tensors
    (``s{i}_wq``, ...).

    Under tensor parallelism (``tp_group``) ``x`` is the input the caller
    passed through ``gather_seq`` and the weights are this rank's: its
    ``n_heads / tp`` q heads, its KV heads (or, past ``n_kv_heads`` ranks,
    the replicated KV weights, of which it takes the columns of the one KV
    head its q heads read: an int8 slice through ``ops.q8_slice_cols`` in
    the serve quant mode); the output goes through ``reduce_out``.

    ``cache``: None (training) or ``{"k", "v": (B, Hkv, W, hd), "pos":
    (B, W) int32}`` with ``pos`` -1 where a slot is empty.  The new keys
    (after RoPE) and values are written at slot ``cache_index % W``:
    ``cache_index`` is an int (prefill at 0 with T <= W, or a decode step
    with T = 1; the write start clamps so the T entries fit, as
    ``lax.dynamic_update_slice`` does) or a (B,) integer tensor of per-row
    positions (continuous-batching decode: each row writes its own slot).
    Validity and causality then come from the stored positions.  The cache
    tensors are updated IN PLACE (``cache_write``; the reference donates
    them to the decode step, ``core/fsdp.py:814``) and returned."""
    B, T, _ = x.shape
    hd = cfg.hd
    tp = 1 if tp_group is None else dist.get_world_size(tp_group)
    hq, hkv, kv_rep = tp_head_counts(cfg.n_heads, cfg.n_kv_heads, tp)
    col = None
    if kv_rep:
        group_size = cfg.n_heads // cfg.n_kv_heads
        col = (dist.get_rank(tp_group) * hq) // group_size * hd
        hkv = 1

    def proj(name, h, kv=False):
        w = p[prefix + name]
        b = p.get(prefix + name + "_b") if cfg.qkv_bias else None
        if kv and kv_rep:
            # this rank's KV head: a column slice of the replicated weight,
            # kept int8 where the scale layout allows it (the reference's),
            # else densified
            sl = (ops.q8_slice_cols(w, col, hd)
                  if isinstance(w, ops.QuantTensor) else None)
            w = sl if sl is not None else to_dense(w, x.dtype).narrow(
                1, col, hd)
            b = None if b is None else b.narrow(0, col, hd)
        y = dense(x, w)
        if b is not None:
            # after the product, in the serve quant mode too (the bias is
            # a 1-D tensor, so ``unpack_quant`` hands it over dense)
            y = y + b.to(x.dtype)
        return y.reshape(B, T, h, hd).transpose(1, 2)

    q = rope(proj("wq", hq), q_pos, cfg.rope_theta)
    k = rope(proj("wk", hkv, kv=True), q_pos, cfg.rope_theta)
    v = proj("wv", hkv, kv=True)
    if cache is None:
        pos = q_pos if causal else None
        out = chunked_attention(q, k, v, q_pos=pos, kv_pos=pos,
                                window=window, softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    else:
        cache_write(cache, k, v, q_pos, cache_index)
        out = chunked_attention(q, cache["k"], cache["v"], q_pos=q_pos,
                                kv_pos=cache["pos"],
                                kv_valid=cache["pos"] >= 0, window=window,
                                softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, T, hq * hd)
    return reduce_out(dense(out, p[prefix + "wo"]), tp_group, sp), cache


def cross_attention(cfg, p, x: torch.Tensor, memory: torch.Tensor, *,
                    tp_group=None, sp: bool = False,
                    prefix: str = "x_") -> torch.Tensor:
    """Cross-attention of the residual stream ``x`` (B, T, D) onto an
    encoder's or a vision stub's ``memory`` (B, M, D): q from
    ``rms_norm(x, x_lnq)``, k and v from the memory, no RoPE, no mask
    (the reference's ``cross_attention``; its default 1,024-key chunks).
    In the serve quant mode the k and v products are int8 GEMMs over all
    B x M memory rows, recomputed at every call as the reference does.

    Under tensor parallelism the weights are this rank's heads; the
    normed stream enters through ``gather_seq`` (under sequence
    parallelism the sequence is gathered whole), the memory, the same on
    every rank, through the identity whose backward all-reduces, and the
    output leaves through ``reduce_out``: Megatron's pairs, as
    ``attention`` (the reference sums the output with a bare ``psum``,
    which under sequence parallelism adds different tokens' outputs;
    ROADMAP Queue 3).  The norm's weight is replicated over the model
    axis and enters through ``share_grad``.  A model axis wider than the
    KV heads raises, as the reference does."""
    B, T, _ = x.shape
    M = memory.shape[1]
    hd = cfg.hd
    tp = _tp_size(tp_group)
    hq, hkv, kv_rep = tp_head_counts(cfg.n_heads, cfg.n_kv_heads, tp)
    if kv_rep:
        raise ValueError("cross-attention with tp > n_kv is not supported")
    lnq = share_grad(p[prefix + "lnq"], tp_group, sp)
    h = gather_seq(rms_norm(x, lnq, cfg.norm_eps), tp_group, sp)
    mem = gather_seq(memory, tp_group, False)
    Tq = h.shape[1]
    q = dense(h, p[prefix + "wq"]).reshape(B, Tq, hq, hd).transpose(1, 2)
    k = dense(mem, p[prefix + "wk"]).reshape(B, M, hkv, hd).transpose(1, 2)
    v = dense(mem, p[prefix + "wv"]).reshape(B, M, hkv, hd).transpose(1, 2)
    out = chunked_attention(q, k, v)
    out = out.transpose(1, 2).reshape(B, Tq, hq * hd)
    return reduce_out(dense(out, p[prefix + "wo"]), tp_group, sp)


def cache_write(cache, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, cache_index) -> None:
    """Write the new keys and values (B, Hkv, T, hd) and their positions
    into a ring-buffer KV cache ``{"k", "v": (B, Hkv, W, hd), "pos": (B,
    W)}`` in place, at slot ``cache_index % W``: an int (the write start
    clamps so the T entries fit, as ``lax.dynamic_update_slice`` does) or
    a (B,) integer tensor of per-row positions."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    B, T = k.shape[0], k.shape[2]
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


def mlp(cfg, p, x: torch.Tensor, *, prefix: str = "", tp_group=None,
        sp: bool = False) -> torch.Tensor:
    """The dense feed-forward of ``cfg.mlp``: swiglu (silu gate), geglu
    (``jax.nn.gelu(approximate=True)`` is the tanh form) or squared_relu
    (nemotron-4, no gate projection).  Under tensor parallelism ``x`` came
    through ``gather_seq``, the weights are this rank's columns of w1/w3
    and rows of w2, and the output goes through ``reduce_out``."""
    if cfg.mlp == "swiglu":
        h = F.silu(dense(x, p[prefix + "w1"])) * dense(x, p[prefix + "w3"])
    elif cfg.mlp == "geglu":
        h = (F.gelu(dense(x, p[prefix + "w1"]), approximate="tanh")
             * dense(x, p[prefix + "w3"]))
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(dense(x, p[prefix + "w1"])))
    else:
        raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
    return reduce_out(dense(h, p[prefix + "w2"]), tp_group, sp)


def embed(tokens: torch.Tensor, emb: torch.Tensor,
          vocab_start: int = 0) -> torch.Tensor:
    """emb: (V_local, D), the rows ``[vocab_start, vocab_start + V_local)``
    of the table (vocab-parallel: the caller combines the ranks' parts
    with ``reduce_out``).  Ids outside them embed to zero, as the
    reference's masked take.  ``F.embedding``, not ``emb[ids]``: the
    gradient of an index is a parallel atomic ``index_put_`` on the CPU,
    whose sum order changes from run to run; the embedding's backward adds
    each row's contributions in token order on the CPU and
    deterministically on the card."""
    ids = tokens - vocab_start if vocab_start else tokens
    ok = (ids >= 0) & (ids < emb.shape[0])
    x = F.embedding(ids.clamp(0, emb.shape[0] - 1), emb)
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
                      mask: torch.Tensor, *, tp_group=None,
                      vocab_start: int = 0):
    """fp32 cross entropy over (B, T, V_local) logits, the columns
    ``[vocab_start, vocab_start + V_local)`` of the vocab: the max, the sum
    of exponentials and the label's logit are combined over the TP ranks
    (``pmax``, ``psum``; without ``tp_group`` the reference's
    ``tp_axis=None`` branch).  Returns (sum_loss, sum_weight)."""
    lg = logits.float()
    m = pmax(lg.amax(dim=-1).detach(), tp_group)  # stabilizer: a constant
    sumexp = psum(torch.exp(lg - m[..., None]).sum(dim=-1), tp_group)
    ids = labels - vocab_start if vocab_start else labels
    ok = (ids >= 0) & (ids < lg.shape[-1])
    picked = torch.gather(lg, -1, ids.clamp(0, lg.shape[-1] - 1)
                          [..., None])[..., 0]
    label_logit = psum(torch.where(ok, picked, torch.zeros_like(picked)),
                       tp_group)
    nll = torch.log(sumexp) + m - label_logit
    return (nll * mask).sum(), mask.sum()


def _ce_chunk_step(x, head_c, labels, m, s, picked, lo: int, chunk: int,
                   softcap):
    """One vocab chunk of ``chunked_ce``: the logits of the columns
    ``head_c`` holds, ``[lo, lo + chunk)``, in fp32 (softcapped in fp32;
    the columns past the vocab masked to NEG_INF), folded into the running
    max ``m``, the rescaled sum of exponentials ``s`` and the picked label
    logit."""
    lg = (x @ head_c.to(x.dtype)).float()
    if softcap is not None:
        lg = softcap * torch.tanh(lg / softcap)
    if head_c.shape[1] < chunk:
        lg = F.pad(lg, (0, chunk - head_c.shape[1]), value=NEG_INF)
    m_new = torch.maximum(m, lg.detach().amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
    loc = labels - lo
    ok = (loc >= 0) & (loc < chunk)
    got = torch.gather(lg, -1, loc.clamp(0, chunk - 1)[..., None])[..., 0]
    picked = picked + torch.where(ok, got, torch.zeros_like(got))
    return m_new, s, picked


def chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, *, vocab_chunk: int = 8192, softcap=None,
               tp_group=None, vocab_start: int = 0):
    """Cross entropy without the (B, T, V) logits (the reference's
    ``chunked_ce``, ``tp_axis=None``): an online max / logsumexp over vocab
    chunks of ``vocab_chunk`` columns, the last one padded to NEG_INF past
    the vocab.  Each chunk's head product and fp32 softcap run inside a
    non-reentrant checkpoint, so backward recomputes the chunk (one more
    head product) and no chunk's logits live past its step, as the
    reference's remat'd scan body.  The head is split into its chunks once
    (``torch.split``), so backward concatenates the chunks' gradients in
    one pass rather than adding a head-sized gradient per chunk.  x:
    (B, T, D) in the compute dtype, head: (D, V), or under tensor
    parallelism this rank's (D, V_local) columns from ``vocab_start``,
    whose running max, sum and picked logit are then combined over the TP
    ranks (the reference's ``tp_axis`` composition).  Returns (sum_loss,
    sum_weight).

    PARITY: ALLCLOSE -- the same online recurrence; the sums run in
    PyTorch's order, not XLA's (tests/test_torch_chunked_ce.py states the
    bounds)."""
    B, T, _ = x.shape
    dev = x.device
    m = torch.full((B, T), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B, T), dtype=torch.float32, device=dev)
    picked = torch.zeros((B, T), dtype=torch.float32, device=dev)
    ids = labels - vocab_start if vocab_start else labels
    for i, head_c in enumerate(head.split(vocab_chunk, dim=1)):
        m, s, picked = checkpoint(
            _ce_chunk_step, x, head_c, ids, m, s, picked, i * vocab_chunk,
            vocab_chunk, softcap, use_reentrant=False,
            preserve_rng_state=False)
    if tp_group is not None:
        # vocab-parallel composition: each rank covered its vocab part
        m_glob = pmax(m, tp_group)
        s = psum(s * torch.exp(m - m_glob), tp_group)
        picked = psum(picked, tp_group)
        m = m_glob
    nll = torch.log(s) + m - picked
    return (nll * mask).sum(), mask.sum()
