"""Mixture-of-Experts FFN with top-k routing and expert parallelism (port
of ``repro/models/moe.py``).

GShard-style capacity dispatch [Lepikhin et al. 2020]: tokens are ranked
within their expert by a sort-based position count (no (N*k, E, C) one-hot
tensors), copied into an (E * cap, D) buffer, run through the experts'
SwiGLU as one batched product, and combined with the router weights.  It is
plain tensor code, as in the reference (no Pallas kernel).  Under expert
parallelism (``ep`` > 1) each rank of the model axis holds ``E / ep``
experts (their outer split, ``ShardDim(0, "model")``, then RaggedShard:
the paper's Fig. 5 composition); the dispatch buffer's expert rows travel
to their owners and the outputs back by two ``all_to_all_single``
exchanges over the model axis (``_Exchange``, whose backward is the
inverse exchange).

Determinism on the card: every scatter of the reference is written so that
no two contributions meet in an atomic add.  The dispatch is an index copy
(kept assignments have distinct slots; dropped ones go to a spare row that
is cut off), its backward sums a token's k copies over a fixed (N, k, D)
axis, and the combine adds a token's k contributions in the reference's
order 0..k-1 (``out.at[flat_tok].add`` runs over ``repeat(arange(N), k)``).

PARITY vs the reference at fp32: ALLCLOSE (matmul sums and the softmax in
another order), routing identical unless two router probabilities of a
token tie to within that rounding (``torch.topk`` and ``lax.top_k`` may
then pick differently; the tests choose inputs without such near-ties and
state what they see).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .layers import dense


def _positions_within_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each assignment among the assignments to the same expert, in
    assignment order (a stable sort, then the distance to the start of each
    run of equal experts; a running max over the run starts stands in for
    the reference's associative scan)."""
    m = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(m, dtype=torch.int64, device=flat_e.device)
    is_start = torch.ones(m, dtype=torch.bool, device=flat_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` over the EP group: row block j of the
    ``(ep * n, ...)`` input goes to rank j, and row block i of the output
    came from rank i (the reference's ``lax.all_to_all`` with
    ``split_axis=concat_axis=0``).  Its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_ffn(cfg, p, x: torch.Tensor, *, ep: int = 1, ep_group=None,
            prefix: str = "moe_"):
    """x: (B, T, D) tokens.  Returns ``(out (B, T, D), aux)`` with ``aux``
    the fp32 Switch load-balance loss ``E * sum_e me_e * ce_e * coef``
    (``ce`` is a count and carries no gradient).

    ``p[prefix + "router"]``: (D, E); ``p[prefix + "w1"/"w3"]``: (E_local,
    D, F), ``p[prefix + "w2"]``: (E_local, F, D), ``E_local = E / ep``
    (``ep_group`` the model axis's process group when ``ep`` > 1)."""
    if ep > 1 and (ep_group is None or dist.get_world_size(ep_group) != ep):
        raise ValueError(f"ep={ep} needs an EP process group of {ep} ranks")
    B, T, D = x.shape
    N = B * T
    E, k = cfg.n_experts, cfg.top_k

    xf = x.reshape(N, D)
    # through ``dense``: a serve-path QuantTensor router takes the int8
    # GEMM (the reference's ``.astype`` raises on one)
    logits = dense(xf, p[prefix + "router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # (N, k), descending
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() / (N * k)
    aux = E * torch.sum(me * ce) * cfg.moe_aux_coef

    cap = max(1, int(cfg.capacity_factor * N * k / E))
    if T == 1:
        # decode: dropless, as the reference (generation must not depend on
        # which other requests share the batch)
        cap = max(cap, N)
    flat_e = top_e.reshape(-1)                       # (N*k,), token-major
    flat_w = top_p.reshape(-1).to(x.dtype)
    rank = _positions_within_expert(flat_e)
    keep = rank < cap
    slot = flat_e * cap + torch.clamp(rank, max=cap - 1)

    # dispatch: one kept assignment per slot; dropped ones to a spare row
    spare = E * cap
    x_rep = xf[:, None, :].expand(N, k, D).reshape(N * k, D)
    buf = xf.new_zeros(spare + 1, D).index_put(
        (torch.where(keep, slot, spare),), x_rep)[:spare]

    e_loc = E // ep
    if ep > 1:
        # (ep, e_loc * cap, D): block j to rank j; back, block i came from
        # rank i -> (e_loc, ep * cap, D), each local expert's slots from
        # every source rank
        h = _Exchange.apply(buf, ep_group).reshape(ep, e_loc, cap, D) \
            .transpose(0, 1).reshape(e_loc, ep * cap, D)
    else:
        h = buf.reshape(E, cap, D)

    # expert SwiGLU batched over the local experts
    w1 = p[prefix + "w1"].to(x.dtype)
    w2 = p[prefix + "w2"].to(x.dtype)
    if prefix + "w3" in p:
        h = F.silu(torch.bmm(h, w1)) * torch.bmm(h, p[prefix + "w3"]
                                                 .to(x.dtype))
    else:
        h = F.silu(torch.bmm(h, w1))
    out_e = torch.bmm(h, w2)
    if ep > 1:
        out_e = _Exchange.apply(
            out_e.reshape(e_loc, ep, cap, D).transpose(0, 1)
            .reshape(E * cap, D), ep_group)
    out_flat = out_e.reshape(E * cap, D)

    # combine: each token's k weighted contributions, added in order
    gathered = (out_flat[slot] * (flat_w * keep)[:, None]).reshape(N, k, D)
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    return out.reshape(B, T, D), aux
