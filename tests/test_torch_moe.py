"""The port's MoE decoder against the JAX reference on the CPU: the expert
layer ``moe_ffn`` (forward and gradients), ``DecoderLM.loss`` and its
gradients on ``qwen3-moe-235b-a22b.reduced()`` from the same init and
batch, and the qwen3 plans.

Parity classes, measured:
  * routing: the same top-k experts and capacity slots on these inputs
    (fp32; no two router probabilities of a token within rounding of each
    other), checked index for index; the ranks within experts BITWISE.
  * ``moe_ffn`` at fp32: ALLCLOSE (matmul sums and the softmax round in
    another order) -- bounds per test.
  * the plans: BITWISE (placements, shard sizes, padding).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.policy import plan as jax_plan
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.models import moe as JM

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime, _ParamGetter
from repro_torch.core.policy import plan
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group
from repro_torch.models import moe as TM

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_positions_within_expert_bitwise():
    r = np.random.default_rng(0)
    for m, E in ((1, 4), (64, 4), (300, 7), (1024, 128)):
        e = r.integers(0, E, m).astype(np.int32)
        want = np.asarray(JM._positions_within_expert(jnp.asarray(e), E))
        got = TM._positions_within_expert(torch.from_numpy(e).long())
        assert np.array_equal(got.numpy(), want)


# (B, T, E, k, capacity factor): capacity binds in the first two (tokens
# are dropped), the third is a decode step (T == 1: dropless)
MOE_CASES = [(2, 32, 4, 2, 1.0), (1, 48, 8, 3, 0.5), (3, 1, 4, 2, 1.25)]


def _moe_setup(B, T, E, k, cf, seed):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_experts=E,
                              top_k=k, capacity_factor=cf, d_model=64,
                              d_ff=48)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), n_experts=E,
                               top_k=k, capacity_factor=cf, d_model=64,
                               d_ff=48)
    r = np.random.default_rng(seed)
    D, F = 64, 48
    p = {"moe_router": r.standard_normal((D, E)) * 0.5,
         "moe_w1": r.standard_normal((E, D, F)) / np.sqrt(D),
         "moe_w3": r.standard_normal((E, D, F)) / np.sqrt(D),
         "moe_w2": r.standard_normal((E, F, D)) / np.sqrt(F)}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = r.standard_normal((B, T, D)).astype(np.float32)
    cot = r.standard_normal((B, T, D)).astype(np.float32)
    return cfg, jcfg, p, x, cot


def _dropped(logits, k, cap):
    """Assignments beyond their expert's capacity, in the reference's
    token-major order."""
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :k].reshape(-1)
    seen, dropped = {}, 0
    for e in top:
        seen[e] = seen.get(e, 0) + 1
        dropped += seen[e] > cap
    return dropped


@pytest.mark.parametrize("B,T,E,k,cf", MOE_CASES,
                         ids=["cap_binds", "cap_binds_hard", "decode"])
def test_moe_ffn_matches_reference(B, T, E, k, cf):
    """Forward output and aux loss, and the gradients of
    ``sum(out * cot) + aux`` with respect to the input and every weight.
    Measured (fp32): output relative L2 2.6e-7, aux rtol 9.2e-8,
    gradients relative L2 5.6e-7; asserted 5e-6.  The same experts are
    chosen on both sides."""
    cfg, jcfg, p, x, cot = _moe_setup(B, T, E, k, cf, seed=B * T + E)
    N = B * T

    def jfn(params, x):
        out, aux = JM.moe_ffn(jcfg, params, x)
        return jnp.sum(out * jnp.asarray(cot)) + aux, (out, aux)

    (jl, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout, taux = TM.moe_ffn(cfg, tp, tx)
    (torch.sum(tout * torch.from_numpy(cot)) + taux).backward()

    # routing: the same experts (and so the same capacity drops)
    logits = x.reshape(N, -1) @ p["moe_router"]
    jtop = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                    k)[1])
    ttop = torch.topk(torch.softmax(torch.from_numpy(logits), -1), k)[1]
    assert np.array_equal(ttop.numpy(), jtop)
    cap = max(1, int(cf * N * k / E))
    if T > 1:
        assert _dropped(logits, k, cap) > 0

    assert _rel(tout.detach(), jout) < 5e-6
    assert abs(taux.item() - float(jaux)) <= 5e-6 * abs(float(jaux))
    assert _rel(tx.grad, jgx) < 5e-6
    for n in p:
        assert _rel(tp[n].grad, jgp[n]) < 5e-6, n


def test_moe_ffn_expert_parallel_raises():
    cfg, _, p, x, _ = _moe_setup(1, 4, 4, 2, 1.0, seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        TM.moe_ffn(cfg, {n: torch.from_numpy(a) for n, a in p.items()},
                   torch.from_numpy(x), ep=2)


def _jax_loss_and_grads(cfg, dtype, tokens):
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=dtype)
    params = rt.init_params(0)
    batch = {"tokens": jnp.asarray(tokens)}

    def fn(params, batch):
        return rt.model.loss(rt._getter(params), batch)

    f = shard_map(fn, mesh=rt.mesh,
                  in_specs=(rt._param_specs(), rt.batch_pspec(batch)),
                  out_specs=(P(), P()))
    (nll, w), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, batch)
    return float(nll), float(w), {n: np.asarray(g) for n, g in grads.items()}


def _torch_loss_and_grads(cfg, dtype, tokens):
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     compute_dtype=dtype, device="cpu")
    params = rt.init_params(0)
    for p in params.values():
        p.grad = torch.zeros_like(p)
    nll, w = rt.model.loss(_ParamGetter(rt, params),
                           {"tokens": torch.tensor(tokens, dtype=torch.long)})
    nll.backward()
    return float(nll.detach()), float(w), {n: p.grad.numpy() for n, p in
                                  params.items()}


@pytest.mark.parametrize("dtype,rtol,grad_rtol",
                         [("float32", 1e-6, 5e-5), ("bfloat16", 1e-3, 5e-2)])
def test_moe_decoder_loss_and_grads_match_reference(dtype, rtol, grad_rtol):
    """``qwen3-moe-235b-a22b.reduced()`` (2 layers, 4 experts top-2, quant
    block 64) at init on one batch: the loss (NLL plus the load-balance
    term) and each group's gradient buffer.  Measured: fp32 loss rtol
    1.2e-7, gradients relative L2 4.5e-6; bf16 loss rtol 9.8e-5,
    gradients relative L2 2.7e-2 (the two frameworks' bf16 kernels round
    differently at every layer)."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tokens = np.asarray(JaxStream(JaxDataConfig(jcfg.vocab, 64, 8), None)
                        .batch(0)["tokens"])
    jn, jw, jg = _jax_loss_and_grads(jcfg, getattr(jnp, dtype), tokens)
    tn, tw, tg = _torch_loss_and_grads(tcfg, getattr(torch, dtype), tokens)
    assert tw == jw == 8 * 63
    np.testing.assert_allclose(tn / tw, jn / jw, rtol=rtol)
    assert list(tg) == ["layers", "layers_experts", "globals"]
    assert sorted(jg) == sorted(tg)
    for name in jg:
        assert tg[name].shape == jg[name].shape
        assert _rel(tg[name], jg[name]) < grad_rtol, name


def _placements(gplan):
    return [(p.spec.name, p.spec.shape, p.spec.granularity, p.offset)
            for p in gplan.placements]


def _one_rank(cfg):
    """The config on one rank: ep=1, its fsdp axes kept."""
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, ep=1))


@pytest.mark.parametrize("case", ["reduced-m1", "reduced-m4",
                                  "reduced-q8-m2", "full-1layer-m1"])
def test_qwen3_plans_match_reference(case):
    """Placements, shard sizes, totals and padding BITWISE the reference's
    (adam8bit: quant-block granularity and align on every group).  Full
    width at one layer on one rank gives the shards the chip smoke
    trains."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if case.startswith("reduced"):
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    else:
        jcfg = dataclasses.replace(_one_rank(jcfg), n_layers=1)
        tcfg = dataclasses.replace(_one_rank(tcfg), n_layers=1)
    m = int(case.split("-m")[-1])
    sched = dict(param_store="q8_block") if "q8" in case else {}
    mesh = {"data": m, "model": 1}
    ref = jax_plan(jax_build_model(jcfg), mesh, JaxSchedule(**sched))
    got = plan(build_model(tcfg), mesh, CommSchedule(**sched))
    assert list(got.groups) == list(ref.groups) == \
        ["layers", "layers_experts", "globals"]
    for name, e in ref.groups.items():
        g = got.groups[name]
        assert _placements(g.plan) == _placements(e.plan), name
        assert (g.plan.shard_size, g.plan.total, g.plan.padding) == \
            (e.plan.shard_size, e.plan.total, e.plan.padding), name
        assert g.plan.shard_size % tcfg.quant_block == 0
        assert g.n_layers == e.n_layers
    if case.startswith("full"):
        assert {n: e.plan.shard_size for n, e in got.groups.items()} == {
            "layers": 71_835_648, "layers_experts": 2_415_919_104,
            "globals": 1_244_663_808}


def test_moe_groups_match_reference():
    """Same communication groups, tensor names, shapes and granularities
    (the router in ``layers``, the experts in ``layers_experts``)."""
    jm = jax_build_model(jax_get_config(ARCH).reduced())
    tm = build_model(get_config(ARCH).reduced())
    jg, tg = jm.groups(), tm.groups()
    assert list(jg) == list(tg)
    for name in jg:
        assert [(s.name, s.shape, s.granularity) for s in jg[name].specs] \
            == [(s.name, s.shape, s.granularity) for s in tg[name].specs]
        assert jg[name].n_layers == tg[name].n_layers
        assert dict(jg[name].outer) == dict(tg[name].outer) == {}
