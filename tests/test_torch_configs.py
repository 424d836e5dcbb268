"""The five configs this port adds -- qwen2.5-14b, qwen1.5-32b, llama3-70b,
gpt-oss-120b (at ep=1) and granite-moe-1b-a400m -- against the JAX
reference on the CPU: their groups and plans at published width (one
layer), five AdamW steps of each ``.reduced()`` config, and the q/k/v
projection bias (``qkv_bias``) in the loss, its gradients and the serve
steps (dense and int8) of ``qwen2.5-14b.reduced()``.

Parity classes, measured (bounds stated per test):
  * configs, groups and plans: EXACT (every field, placement, shard size).
  * the AdamW streams, the qkv-bias loss and attention: ALLCLOSE, fp32
    rounding (``q8_matmul`` is bitwise the reference's, and the bias is
    added after it on both sides).
  * the serve steps: ALLCLOSE within the serve tests' bounds -- the bf16
    KV cache's rounding flips, amplified by the int8 mode's row
    quantization.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_train_worker as W
from _torch_ref_step import first_step
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime, _ParamGetter
from repro_torch.core.policy import plan
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

NEW = ("qwen2.5-14b", "qwen1.5-32b", "llama3-70b", "gpt-oss-120b",
       "granite-moe-1b-a400m")
QWEN = "qwen2.5-14b"
STEPS = 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ep1(cfg):
    """A config at ep=1 (one rank's model axis)."""
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, ep=1))


def _placements(gplan):
    return [(p.spec.name, p.spec.shape, p.spec.granularity, p.offset)
            for p in gplan.placements]


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    """Every field of the port's config equals the reference's (gpt-oss-120b
    too, its expert-parallel degree 16 since expert parallelism is
    ported); the id is registered and its model builds."""
    t, j = get_config(arch), jax_get_config(arch)
    assert arch in ARCH_IDS
    tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
    for k, v in tf.items():
        assert k in jf and v == jf[k], k
    assert t.source and t.source in (build_model(t).cfg.source,)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("arch", NEW)
def test_full_width_plans_match_reference(arch, m):
    """Published width, one layer, on ``m`` ranks: the same groups and
    tensor specs, and the same placements, shard sizes, totals and
    padding, on the fp32 store and on the q8_block store (quant-block
    aligned)."""
    jcfg = dataclasses.replace(_ep1(jax_get_config(arch)), n_layers=1)
    tcfg = dataclasses.replace(_ep1(get_config(arch)), n_layers=1)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    assert list(jm.groups()) == list(tm.groups())
    for name, g in jm.groups().items():
        assert [(s.name, s.shape, s.granularity) for s in g.specs] == \
            [(s.name, s.shape, s.granularity)
             for s in tm.groups()[name].specs], name
    mesh = {"data": m, "model": 1}
    for sched in ({}, {"param_store": "q8_block"}):
        ref = jax_plan(jm, mesh, JaxSchedule(**sched))
        got = plan(tm, mesh, CommSchedule(**sched))
        assert list(got.groups) == list(ref.groups)
        for name, e in ref.groups.items():
            g = got.groups[name]
            assert _placements(g.plan) == _placements(e.plan), (name, sched)
            assert (g.plan.shard_size, g.plan.total, g.plan.padding) == \
                (e.plan.shard_size, e.plan.total, e.plan.padding), name
            assert g.n_layers == e.n_layers


def test_qwen_full_width_shards():
    """The shards ``chip_smoke.py``'s ``train_muon_q8`` and
    ``train_shampoo`` train: qwen2.5-14b at published width on one rank,
    q8_block store (block 1024) at 2 layers and fp32 store at 1 (every
    tensor is a multiple of the block: no alignment padding)."""
    cfg = get_config(QWEN)
    want = {"layers": 275_268_608, "globals": 1_557_140_480}
    for layers, sched in ((2, {"param_store": "q8_block"}), (1, {})):
        p = plan(build_model(dataclasses.replace(cfg, n_layers=layers)),
                 {"data": 1, "model": 1}, CommSchedule(**sched))
        assert {n: e.plan.shard_size for n, e in p.groups.items()} == want


# ---------------------------------------------------------------------------
# five AdamW steps of each reduced config
# ---------------------------------------------------------------------------

def _jax_stream(arch, steps=STEPS):
    cfg = dataclasses.replace(jax_get_config(arch).reduced(),
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32)
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = first_step(rt)
    losses, norms = [], []
    for i in range(steps):
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (np.asarray(losses), np.asarray(norms),
            {k: np.asarray(v) for k, v in params.items()})


@pytest.mark.parametrize("arch", NEW)
def test_adamw_streams_match_reference(arch):
    """Five AdamW steps of ``arch.reduced()`` (2 layers, d_model 256,
    quant block 64; the MoE configs at 4 experts top-2, ep=1 on both sides)
    in fp32: loss within rtol 1e-5, grad norm within 1e-4, the final
    masters within 1e-3 relative L2.  Measured: loss 1.4e-7-7.1e-7, grad
    norm 2.7e-7-2.3e-6, masters 3.9e-6-1.3e-4 (Adam maps near-zero
    gradients to about their sign)."""
    jl, jn, jp = _jax_stream(arch)
    tl, tn, rt, tp, _ = W.train(init_local_group("gloo"), torch.float32,
                                STEPS, arch=arch)
    assert rt.cfg.optimizer == "adamw"
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    for name, want in jp.items():
        assert _rel(tp[name].detach().numpy(), want) < 1e-3, name


# ---------------------------------------------------------------------------
# qkv_bias: loss, gradients, serve
# ---------------------------------------------------------------------------

def _tokens(vocab, B=4, T=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def _bias_init(cfg, params_np, layouts, seed=1):
    """Non-zero biases (the init makes them zero, which would not test the
    add): N(0, 0.5) into every ``*_b`` tensor of the layer buffer."""
    r = np.random.default_rng(seed)
    lo = layouts["layers"]
    buf = params_np["layers"].copy()
    for i in range(cfg.n_layers):
        for pl in lo.plan.placements:
            if pl.spec.name.endswith("_b"):
                buf[i, pl.offset:pl.end] = r.normal(
                    0, 0.5, pl.end - pl.offset).astype(np.float32)
    return {**params_np, "layers": buf}


def test_qkv_bias_loss_and_grads_match_reference():
    """``qwen2.5-14b.reduced()`` with non-zero biases on one batch: the loss
    and every tensor's gradient, fp32, the biases' non-zero.  The bias
    specs sit after ``wv`` as in the reference.  Measured: loss rtol
    1.2e-7, gradients relative L2 up to 4.8e-6.  Asserted:
    1e-5 and 5e-5."""
    jcfg, tcfg = jax_get_config(QWEN).reduced(), get_config(QWEN).reduced()
    names = [s.name for s in build_model(tcfg).groups()["layers"].specs]
    assert names[:8] == ["ln1", "wq", "wk", "wv", "wq_b", "wk_b", "wv_b",
                         "wo"]
    tokens = _tokens(tcfg.vocab)
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     compute_dtype=torch.float32, device="cpu")
    base = {n: np.asarray(v) for n, v in jrt.init_params(0).items()}
    pnp = _bias_init(tcfg, base, rt.layouts)

    def jfn(params, batch):
        return jrt.model.loss(jrt._getter(params), batch)

    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    f = shard_map(jfn, mesh=jrt.mesh,
                  in_specs=(jrt._param_specs(), jrt.batch_pspec(batch)),
                  out_specs=(P(), P()))
    (jn, jw), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {n: jnp.asarray(a) for n, a in pnp.items()}, batch)
    params = {n: torch.from_numpy(a.copy()).requires_grad_()
              for n, a in pnp.items()}
    for p in params.values():
        p.grad = torch.zeros_like(p)
    tn, tw = rt.model.loss(_ParamGetter(rt, params),
                           {"tokens": torch.from_numpy(tokens)})
    tn.backward()
    assert float(tw) == float(jw)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    lo = rt.layouts["layers"]
    for name in jg:
        got, want = params[name].grad.numpy(), np.asarray(jg[name])
        if name != "layers":
            assert _rel(got, want) < 5e-5, name
            continue
        for i in range(tcfg.n_layers):
            gu, wu = lo.buffer.unpack_np(got[i]), lo.buffer.unpack_np(want[i])
            for t in wu:
                assert _rel(gu[t], wu[t]) < 5e-5, (i, t)
                if t.endswith("_b"):
                    assert np.abs(wu[t]).max() > 0, (i, t)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_qkv_bias_attention_matches_reference(quant):
    """``layers.attention`` of qwen2.5-14b.reduced() with non-zero q, k, v
    biases and no cache (fp32), on plain weights and on ``QuantTensor``
    weights (the int8 serve mode: the bias is added to ``q8_matmul``'s
    output), against the reference's: within 1e-6 relative L2 (measured
    4.6e-7 dense, 1.4e-7 int8)."""
    from repro.models import layers as JL
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL

    jcfg, tcfg = jax_get_config(QWEN).reduced(), get_config(QWEN).reduced()
    r = np.random.default_rng(5)
    D, hd, Hq, Hkv = tcfg.d_model, tcfg.hd, tcfg.n_heads, tcfg.n_kv_heads
    shapes = {"wq": (D, Hq * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
              "wo": (Hq * hd, D)}
    block = tcfg.quant_block
    jp, tp = {}, {}
    for k, s in shapes.items():
        if quant:
            codes = r.integers(-127, 128, s).astype(np.int8)
            scales = r.uniform(1e-3, 2e-2, s[0] * s[1] // block).astype(
                np.float32)
            jp[k] = JL.ops.QuantTensor(jnp.asarray(codes),
                                       jnp.asarray(scales), block)
            tp[k] = ops.QuantTensor(torch.from_numpy(codes),
                                    torch.from_numpy(scales), block)
        else:
            w = (r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            jp[k], tp[k] = jnp.asarray(w), torch.from_numpy(w)
        if k != "wo":
            b = r.normal(0, 0.5, s[1]).astype(np.float32)
            jp[k + "_b"], tp[k + "_b"] = jnp.asarray(b), torch.from_numpy(b)
    x = r.standard_normal((2, 12, D)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(12), (2, 12))
    jout, _ = JL.attention(jcfg, jp, jnp.asarray(x),
                           q_pos=jnp.asarray(qpos, jnp.int32))
    tout, _ = TL.attention(tcfg, tp, torch.from_numpy(x),
                           q_pos=torch.from_numpy(np.ascontiguousarray(qpos)))
    assert _rel(tout.numpy(), np.asarray(jout)) < 1e-6
    # the biases take part: without them the output moves
    nob = {k: v for k, v in tp.items() if not k.endswith("_b")}
    tout0, _ = TL.attention(tcfg, nob, torch.from_numpy(x),
                            q_pos=torch.from_numpy(np.ascontiguousarray(qpos)))
    assert _rel(tout0.numpy(), tout.numpy()) > 1e-2


@pytest.mark.parametrize("store", ["fp32", "q8_matmul"])
def test_qkv_bias_serve_matches_reference(store):
    """A prefill of ``qwen2.5-14b.reduced()`` (4 x 16 tokens, fp32) with
    non-zero biases, then one decode step, each package with its own bf16
    cache: dense on the fp32 store, and the int8 serve mode (q8_block
    store, ``serve_quant_matmul``).  As in tests/test_torch_serve.py, a
    cached key or value within rounding of a bf16 midpoint rounds the other
    way (measured 59 of 8,192 key entries here); the int8 mode's row
    quantization amplifies those flips.  Measured logits relative L2:
    2.4e-5 / 1.8e-4 (prefill / decode) dense,
    5.4e-3 / 6.1e-3 int8, and 5.4e-2 / 4.8e-2 from the dense q8 serve.  Asserted: 1.5e-3 dense and 4e-2 int8 (the serve tests'
    bounds), and the int8 logits within 0.15 of the reference's dense q8
    serve (the reference's own check)."""
    sched = {} if store == "fp32" else {"param_store": "q8_block",
                                        "serve_quant_matmul": True}
    bound = 1.5e-3 if store == "fp32" else 4e-2
    jcfg, tcfg = jax_get_config(QWEN).reduced(), get_config(QWEN).reduced()
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     compute_dtype=torch.float32, device="cpu",
                     schedule=CommSchedule(**sched))
    fp32 = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1))
    base = {n: np.asarray(v) for n, v in fp32.init_params(0).items()}
    pnp = _bias_init(tcfg, base, rt.layouts)
    toks = _tokens(tcfg.vocab, B=4, T=17, seed=3)

    def jax_serve(sched):
        jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                         compute_dtype=jnp.float32,
                         schedule=JaxSchedule(**sched))
        jparams = {n: jrt.layouts[n].store.create(a) for n, a in pnp.items()}
        cache = jrt.model.init_cache(4, 32)
        lg, cache = jrt.make_prefill_step()(
            jparams, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)}, cache)
        lg2, _ = jrt.make_decode_step()(
            jparams, {"tokens": jnp.asarray(toks[:, 16:], jnp.int32)}, cache,
            jnp.int32(16))
        return [np.asarray(lg, np.float32), np.asarray(lg2, np.float32)]

    params = {n: rt.layouts[n].store.create(torch.from_numpy(a.copy()))
              for n, a in pnp.items()}
    cache = rt.model.init_cache(4, 32, device="cpu")
    lg, cache = rt.make_prefill_step()(
        params, {"tokens": torch.from_numpy(toks[:, :16])}, cache)
    lg2, _ = rt.make_decode_step()(
        params, {"tokens": torch.from_numpy(toks[:, 16:])}, cache, 16)
    got = [lg.numpy(), lg2.numpy()]
    assert got[0].shape == (4, 1, tcfg.vocab)
    for g, w in zip(got, jax_serve(sched)):
        assert _rel(g, w) < bound
    if store != "fp32":
        dense = jax_serve({"param_store": "q8_block"})
        for g, w in zip(got, dense):
            assert 0 < _rel(g, w) < 0.15
