"""State-space and recurrent mixers (port of ``repro/models/ssm.py``): the
Mamba-style selective SSM (S6) and the xLSTM pair -- mLSTM (matrix
memory, chunkwise parallel) and sLSTM (scalar memory, a sequential scan)
[arXiv:2405.04517, arXiv:2312.00752].

Every function is plain tensor code on the reference's shapes and
parameter names; each returns ``(out, new_state)``, the state the next
call continues from (the serve cache's leaves).

  * ``diagonal_scan`` -- ``h_t = a_t * h_{t-1} + b_t`` in chunks of 256: an
    inclusive log-depth (Hillis-Steele) scan inside every chunk at once (8
    passes for 256), then the carry across the chunks, one fused multiply-
    add a chunk.  The reference runs ``lax.associative_scan`` inside a
    chunk and ``lax.scan`` across them; PyTorch has no associative scan,
    and a loop over T would launch per position.
  * ``mlstm_mix`` -- the chunkwise form (chunk ``min(128, T)``) as batched
    fp32 matmuls, a loop over the chunks carrying ``(C, n)``.
  * ``slstm_mix`` -- a loop over T of elementwise ops, as the reference's
    ``lax.scan``; the gate transforms that do not depend on the carry
    (``log sigmoid(f)``, ``tanh(z)``, ``sigmoid(o)``) run once over all T
    outside it, and ``c`` and ``n`` advance as one stacked tensor: 8
    kernels a position forward (again in the layer's recompute, and about
    twice that in backward).

PARITY: ALLCLOSE at fp32 -- the scans associate in another order than
XLA's (``diagonal_scan``: log-depth against the reference's odd/even
recursion), matmul sums run in PyTorch's order, and the masked entries of
the mLSTM decay matrix are set before the ``exp`` (the reference's
``where`` after it; the same values, a gradient without ``0 * inf``).
tests/test_torch_ssm.py states the bounds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 256          # diagonal_scan's chunk (the reference's default)
MLSTM_CHUNK = 128    # mlstm_mix's chunk
SLSTM_M0 = -1e30     # the sLSTM stabiliser's start (the reference's)


# ---------------------------------------------------------------------------
# generic diagonal linear recurrence  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def diagonal_scan(a: torch.Tensor, b: torch.Tensor, h0=None,
                  chunk: int = CHUNK):
    """a, b: (B, T, ...) with matching trailing dims.  Returns (h (B, T,
    ...), h_last (B, ...)); ``h0`` (B, ...) the state before position 0
    (zeros when None).  T is padded to whole chunks with ``a = 1``, ``b =
    0`` (the reference's padding), which leave the state unchanged."""
    B, T = a.shape[:2]
    tail = tuple(a.shape[2:])
    chunk = min(chunk, T)
    nc = -(-T // chunk)
    pad = nc * chunk - T
    if pad:
        widths = (0, 0) * len(tail) + (0, pad)
        a = F.pad(a, widths, value=1.0)
        b = F.pad(b, widths)
    pa = a.reshape((B, nc, chunk) + tail)
    pb = b.reshape((B, nc, chunk) + tail)
    # inclusive scan along dim 2: after the pass of stride s, position t
    # holds the composition of positions (t - 2s, t]
    s = 1
    while s < chunk:
        pb = torch.cat([pb[:, :, :s],
                        pb[:, :, :-s] * pa[:, :, s:] + pb[:, :, s:]], dim=2)
        pa = torch.cat([pa[:, :, :s], pa[:, :, :-s] * pa[:, :, s:]], dim=2)
        s *= 2
    h = h0 if h0 is not None else torch.zeros((B,) + tail, dtype=a.dtype,
                                               device=a.device)
    outs = []
    for pa_c, pb_c in zip(pa.unbind(1), pb.unbind(1)):
        h_c = pa_c * h[:, None] + pb_c
        outs.append(h_c)
        h = h_c[:, -1]
    hs = torch.stack(outs, 1).reshape((B, nc * chunk) + tail)[:, :T]
    return hs, h


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (diagonal A, input-dependent dt/B/C)
# ---------------------------------------------------------------------------

def mamba_mix(cfg, p, x: torch.Tensor, *, state=None, prefix: str = "ssm_",
              d_inner=None):
    """x: (B, T, D).  Returns (out (B, T, D), new_state); ``state`` (a
    continuation): ``{"conv": (B, K-1, d_in), "ssm": (B, d_in, N) fp32}``,
    the new one in the same form (``conv`` in x's dtype)."""
    B, T, D = x.shape
    N = cfg.ssm_state
    d_in = d_inner or cfg.ssm_expand * D
    K = cfg.conv_kernel

    xz = x @ p[prefix + "in_proj"].to(x.dtype)           # (B, T, 2 d_in)
    xi, z = xz.chunk(2, dim=-1)

    # depthwise causal conv1d
    conv_w = p[prefix + "conv"].to(x.dtype)               # (K, d_in)
    if state is None:
        xpad = F.pad(xi, (0, 0, K - 1, 0))
        new_conv = (xpad[:, -(K - 1):] if K > 1
                    else x.new_zeros((B, 0, d_in)))
    else:
        xpad = torch.cat([state["conv"].to(x.dtype), xi], dim=1)
        new_conv = xpad[:, -(K - 1):] if K > 1 else state["conv"]
    xc = sum(xpad[:, i:i + T] * conv_w[i] for i in range(K))
    xc = F.silu(xc)

    # input-dependent dt, B, C
    dt = F.softplus(xc @ p[prefix + "dt_w"].to(x.dtype)
                    + p[prefix + "dt_b"].to(x.dtype)).float()  # (B,T,d_in)
    bc = xc @ p[prefix + "bc_w"].to(x.dtype)              # (B, T, 2N)
    Bm, Cm = bc.float().chunk(2, dim=-1)                  # (B, T, N)
    A = -torch.exp(p[prefix + "A_log"].float())           # (d_in, N)

    a = torch.exp(dt[..., None] * A)                      # (B,T,d_in,N)
    bterm = (dt * xc.float())[..., None] * Bm[:, :, None, :]

    h0 = state["ssm"].float() if state is not None else None
    hs, h_last = diagonal_scan(a, bterm, h0)
    y = torch.einsum("btdn,btn->btd", hs, Cm).to(x.dtype)
    y = y + xc * p[prefix + "skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p[prefix + "out_proj"].to(x.dtype)
    return out, {"conv": new_conv.to(x.dtype), "ssm": h_last.float()}


def mamba_param_shapes(cfg, D: int, prefix: str = "ssm_", d_inner=None):
    N = cfg.ssm_state
    d_in = d_inner or cfg.ssm_expand * D
    K = cfg.conv_kernel
    return {
        prefix + "in_proj": (D, 2 * d_in),
        prefix + "conv": (K, d_in),
        prefix + "dt_w": (d_in, d_in),
        prefix + "dt_b": (d_in,),
        prefix + "bc_w": (d_in, 2 * N),
        prefix + "A_log": (d_in, N),
        prefix + "skip": (d_in,),
        prefix + "out_proj": (d_in, D),
    }


# ---------------------------------------------------------------------------
# mLSTM: matrix-memory LSTM, chunkwise parallel (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_mix(cfg, p, x: torch.Tensor, *, state=None, prefix: str = "m_"):
    """Matrix-memory cell ``C_t = f_t C_{t-1} + i_t k_t v_t^T``, ``h = q C /
    max(|q n|, 1)``, with the reference's stabilised sigmoid gates (the
    forget gate's +4 bias).  x: (B, T, D).  ``state``: ``{"C": (B, H, hd,
    hd), "n": (B, H, hd)}`` fp32; returns (out (B, T, D), new state)."""
    B, T, D = x.shape
    H = cfg.n_heads
    hd = D // H
    chunk = min(MLSTM_CHUNK, T)

    def heads(name):
        return (x @ p[prefix + name].to(x.dtype)).reshape(
            B, T, H, hd).transpose(1, 2)

    q = heads("wq").float() / (hd ** 0.5)
    k = heads("wk").float()
    v = heads("wv").float()
    gates = x @ p[prefix + "wgate"].to(x.dtype)           # (B, T, 2H)
    f = torch.sigmoid(gates[..., :H].float() + 4.0).transpose(1, 2)
    i = torch.sigmoid(gates[..., H:].float()).transpose(1, 2)  # (B, H, T)

    nc = -(-T // chunk)
    pad = nc * chunk - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        f = F.pad(f, (0, pad), value=1.0)
        i = F.pad(i, (0, pad))

    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C, n = state["C"].float(), state["n"].float()

    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    hs = []
    for q_i, k_i, v_i, f_i, i_i in zip(*(t.split(chunk, dim=2)
                                         for t in (q, k, v, f, i))):
        logf = torch.log(torch.clamp(f_i, min=1e-8))
        cum = torch.cumsum(logf, dim=-1)                  # (B, H, c)
        # inter-chunk: the carried state decayed to each position
        d = torch.exp(cum)
        h_inter = (q_i @ C) * d[..., None]
        n_inter = torch.einsum("bhtd,bhd->bht", q_i, n) * d
        # intra-chunk: A[t, s] = (q_t . k_s) exp(cum_t - cum_s) i_s, s <= t
        ratio = cum[..., :, None] - cum[..., None, :]     # (B, H, c, c)
        w = torch.exp(ratio.masked_fill(~causal, float("-inf"))) \
            * i_i[..., None, :]
        scores = (q_i @ k_i.transpose(-1, -2)) * w
        h_intra = scores @ v_i
        n_intra = scores.sum(dim=-1)
        # the new carry
        dc = torch.exp(cum[..., -1])
        rd = torch.exp(cum[..., -1:] - cum)               # decay s -> end
        kw = k_i * (rd * i_i)[..., None]
        C = C * dc[..., None, None] + kw.transpose(-1, -2) @ v_i
        n = n * dc[..., None] + kw.sum(dim=2)
        hs.append((h_inter + h_intra) / torch.clamp(
            torch.abs(n_inter + n_intra), min=1.0)[..., None])
    h = torch.cat(hs, dim=2)[:, :, :T]
    out = h.transpose(1, 2).reshape(B, T, D).to(x.dtype)
    out = out * F.silu(x @ p[prefix + "wog"].to(x.dtype))
    out = out @ p[prefix + "wo"].to(x.dtype)
    return out, {"C": C, "n": n}


def mlstm_param_shapes(cfg, D: int, prefix: str = "m_"):
    H = cfg.n_heads
    return {
        prefix + "wq": (D, D),
        prefix + "wk": (D, D),
        prefix + "wv": (D, D),
        prefix + "wgate": (D, 2 * H),
        prefix + "wog": (D, D),
        prefix + "wo": (D, D),
    }


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory LSTM with exponential gating (sequential)
# ---------------------------------------------------------------------------

def slstm_mix(cfg, p, x: torch.Tensor, *, state=None, prefix: str = "s_"):
    """A sequential scan over T; per-head scalar memory ``c``, normaliser
    ``n`` and stabiliser ``m`` [arXiv:2405.04517 eq. 16-24, simplified: no
    block-diagonal recurrent R].  x: (B, T, D).  ``state``: ``{"c", "n",
    "m": (B, H, hd)}`` fp32, ``m`` starting at -1e30; returns (out (B, T,
    D), new state)."""
    B, T, D = x.shape
    H = cfg.n_heads
    hd = D // H

    zifo = (x @ p[prefix + "w_zifo"].to(x.dtype)).float().reshape(
        B, T, 4, H, hd)
    z, i_g, f_g, o_g = zifo.unbind(2)                     # (B, T, H, hd)

    if state is None:
        c = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        m = torch.full_like(c, SLSTM_M0)
    else:
        c, n, m = (state[k].float() for k in ("c", "n", "m"))

    logf = -F.softplus(-f_g)                              # log sigmoid(f)
    # c and n advance together: (c, n) <- fg (c, n) + ig (tanh z, 1), and
    # both gates are one exp of (i, log f + m) - m_new
    cn = torch.stack([c, n])
    u = torch.stack([torch.tanh(z), torch.ones_like(z)])  # (2, B, T, ..)
    cns = []
    for lf_t, i_t, u_t in zip(logf.unbind(1), i_g.unbind(1), u.unbind(2)):
        lm = lf_t + m
        m = torch.maximum(lm, i_t)
        ig, fg = torch.exp(torch.stack([i_t, lm]) - m)
        cn = fg * cn + ig * u_t
        cns.append(cn)
    c_all, n_all = torch.stack(cns, 2)                    # (B, T, H, hd)
    h = torch.sigmoid(o_g) * c_all / torch.clamp(n_all, min=1.0)
    out = h.reshape(B, T, D).to(x.dtype) @ p[prefix + "wo"].to(x.dtype)
    c, n = cn
    return out, {"c": c, "n": n, "m": m}


def slstm_param_shapes(cfg, D: int, prefix: str = "s_"):
    return {
        prefix + "w_zifo": (D, 4 * D),
        prefix + "wo": (D, D),
    }
