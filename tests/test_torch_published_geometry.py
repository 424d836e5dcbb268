"""The published geometry of the five configurations the card first runs
at published width (``chip_smoke.py``'s ``train_granite``,
``serve_granite``, ``train_qwen32b``, ``train_llama70b``, ``train_gptoss``
and nemotron-4-340b's ``kernel_q8mm_nemotron``) against the JAX reference
on the CPU.  ``.reduced()`` caps heads at 4, sets ``head_dim`` to
``d_model / heads`` and caps experts at 4 and top-k at 2, so the other
tests never ran these: gpt-oss-120b's 128 experts top-4 with 64 query
heads of 64, granite's 32 experts top-8, qwen1.5-32b's 40-head
multi-head attention with bias, llama3-70b's 64/8 heads of 128,
nemotron's 96/8 heads of 192 and its squared-ReLU MLP.

Each config keeps every published field -- ``n_heads``, ``n_kv_heads``,
``head_dim``, ``n_experts``, ``top_k``, ``mlp``, ``qkv_bias``,
``rope_theta``, the quant block -- but ``d_model`` 256, ``d_ff`` 64, the
vocab 512 and one layer, on one rank (ep 1; nemotron at tp 1 and one
microbatch), batch 2 x 32, fp32.

Parity classes, measured (bounds stated per test):
  * one train step (the port's ``make_train_step`` with the config's
    optimizer against the reference's step core at one rank): ALLCLOSE,
    fp32 rounding -- loss rel 3.7e-9 to 2.2e-7, grad norm rel 1.3e-8 to
    2.0e-7;
  * the gradients of the loss at init, per group: ALLCLOSE -- relative L2
    1.5e-6 to 2.4e-6;
  * nemotron-4-340b's step through the reference's own ``train_step``
    (8-bit Adam): ALLCLOSE -- loss rel 1.1e-7, grad norm rel 0, masters
    rel L2 5.4e-9 and 4.1e-8, the step's update rel L2 1.5e-4 and 6.5e-4
    (the masters' fp32 rounding of a 3e-6 step);
  * granite's serve from the q8_block store (prefill and four
    teacher-forced decode steps, each package with its own bf16 cache):
    ALLCLOSE -- relative L2 a call 1.5e-6 to 7.1e-5 dense-dequant, 4.2e-7
    to 5.2e-7 with ``serve_quant_matmul`` (the reference's router through
    its own ``dense``, as the port's).  Planted faults in the port's
    router read, a call: its logits rounded to bf16 (near-tie tokens pick
    other experts) 1.7e-3 to 7.1e-3 in both modes; its expert columns
    rolled by one 1.2 to 1.4; the int8 router's block scales reversed
    4.6e-2 to 1.9e-1.
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
from repro.configs.base import ParallelConfig as JaxParallel
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

from repro_torch.configs import build_model, get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.fsdp import FSDPRuntime, _ParamGetter
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

ARCHS = ("llama3-70b", "qwen1.5-32b", "gpt-oss-120b",
         "granite-moe-1b-a400m", "nemotron-4-340b")
GRANITE = "granite-moe-1b-a400m"
D_MODEL, D_FF, VOCAB, BATCH, SEQ = 256, 64, 512, 2, 32
KEPT = ("n_heads", "n_kv_heads", "head_dim", "n_experts", "top_k", "mlp",
        "qkv_bias", "rope_theta", "quant_block")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _geometry(cfg, parallel_cls):
    """``cfg`` cut in width and depth only, on one rank of a data axis."""
    return dataclasses.replace(
        cfg, d_model=D_MODEL, d_ff=D_FF, vocab=VOCAB, n_layers=1,
        parallel=parallel_cls(fsdp_axes=("data",), batch_axes=("data",)))


def _configs(arch):
    return (_geometry(jax_get_config(arch), JaxParallel),
            _geometry(get_config(arch), ParallelConfig))


def _tokens(seed=0, T=SEQ, B=BATCH):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, T))


@pytest.fixture(scope="module")
def group():
    return init_local_group("gloo")


def test_geometry_keeps_the_published_fields():
    """The cut touches width, depth and the mesh only: every field the
    card's phases exercise keeps its published value, and no config
    here is a ``.reduced()`` one."""
    for arch in ARCHS:
        full, (jcfg, tcfg) = get_config(arch), _configs(arch)
        for k in KEPT:
            assert getattr(tcfg, k) == getattr(full, k) == getattr(jcfg, k)
        assert (tcfg.parallel.tp, tcfg.parallel.ep,
                tcfg.parallel.microbatches) == (1, 1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_and_grads_match_reference(arch, group):
    """One fp32 step from the reference's init (``init_params(0)``, handed
    to the port as numpy) on the same 2 x 32 tokens.  The reference's side
    is re-derived here from its train step's core at one rank (one JAX
    compile an architecture): ``value_and_grad`` of its runtime's loss
    through its parameter getter under ``shard_map``; the 1 / tokens
    scaling, the loss (the NLL over the tokens) and the grad norm (the
    global norm of the scaled gradients) are this test's arithmetic, as
    the reference's step does it.  The port's is ``make_train_step`` with
    the config's optimizer, and ``model.loss`` backward for the
    gradients.  The reference's own step -- its scaling, norm and update
    -- is held by ``test_reference_train_step_matches`` below for
    nemotron-4-340b (8-bit Adam) and, at ``.reduced()`` geometry, for the
    other four (AdamW) by ``test_torch_configs.py``'s
    ``test_adamw_streams_match_reference``.  Loss within rtol 1e-5, grad
    norm within 1e-4, each group's gradient within 1e-4 relative L2 (a
    per-layer group layer row by layer row); measured in the module
    docstring."""
    jcfg, tcfg = _configs(arch)
    tokens = _tokens()
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    pnp = {n: np.array(v) for n, v in jrt.init_params(0).items()}
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}

    def jfn(params, b):
        return jrt.model.loss(jrt._getter(params), b)

    f = shard_map(jfn, mesh=jrt.mesh,
                  in_specs=(jrt._param_specs(), jrt.batch_pspec(batch)),
                  out_specs=(P(), P()))
    (jn, jw), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {n: jnp.asarray(a) for n, a in pnp.items()}, batch)
    jg = {n: np.asarray(g, np.float64) / float(jw) for n, g in jg.items()}
    j_loss = float(jn) / float(jw)
    j_norm = float(np.sqrt(sum(np.sum(g * g) for g in jg.values())))

    rt = FSDPRuntime(build_model(tcfg), group, compute_dtype=torch.float32,
                     device="cpu")
    assert set(rt.layouts) == set(pnp)
    opt = make_optimizer(tcfg)
    params = {n: rt.layouts[n].store.create(
        torch.from_numpy(a.copy()).requires_grad_(True))
        for n, a in pnp.items()}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    _, _, _, tm = rt.make_train_step(opt)(params, opt.init(rt), 0, tbatch)
    assert float(tm["tokens"]) == float(jw)
    np.testing.assert_allclose(float(tm["loss"]), j_loss, rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), j_norm, rtol=1e-4)

    leaves = {n: torch.from_numpy(a.copy()).requires_grad_()
              for n, a in pnp.items()}
    for p in leaves.values():
        p.grad = torch.zeros_like(p)
    nll, w = rt.model.loss(_ParamGetter(rt, leaves), tbatch)
    nll.backward()
    assert float(w) == float(jw)
    for name, want in jg.items():
        got = leaves[name].grad.numpy() / float(w)
        assert got.shape == want.shape, name
        rows = zip(got, want) if rt.layouts[name].n_layers else [(got, want)]
        for gr, wr in rows:
            assert np.abs(wr).max() > 0, name
            assert _rel(gr, wr) < 1e-4, name


@pytest.mark.parametrize("arch", ["nemotron-4-340b"])
def test_reference_train_step_matches(arch, group):
    """One fp32 step through the reference's own ``make_train_step`` with
    the config's optimizer (8-bit Adam for nemotron-4-340b, at 96/8 heads
    of 192 and the squared-ReLU MLP) against the port's, from the same
    init and 2 x 32 tokens: the loss within rtol 1e-5, the grad norm within
    1e-4, each group's master within 1e-6 relative L2 of the reference's
    and the step's update (master after less before) within 1e-2 relative
    L2; measured in the module docstring."""
    jcfg, tcfg = _configs(arch)
    tokens = _tokens()
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    jparams = jrt.init_params(0)
    before = {n: np.array(v) for n, v in jparams.items()}
    jopt = jax_make_optimizer(jcfg)
    jnew, _, _, jm = jrt.make_train_step(jopt)(
        jparams, jopt.init(jrt), jnp.int32(0),
        {"tokens": jnp.asarray(tokens, jnp.int32)})

    rt = FSDPRuntime(build_model(tcfg), group, compute_dtype=torch.float32,
                     device="cpu")
    opt = make_optimizer(tcfg)
    params = {n: rt.layouts[n].store.create(
        torch.from_numpy(a.copy()).requires_grad_(True))
        for n, a in before.items()}
    new, _, _, tm = rt.make_train_step(opt)(
        params, opt.init(rt), 0, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for name, w0 in before.items():
        got = new[name].detach().numpy()
        want = np.asarray(jnew[name])
        assert np.abs(want - w0).max() > 0, name
        assert _rel(got, want) < 1e-6, name
        assert _rel(got - w0, want - w0) < 1e-2, name


def _serve_stream(rt, params, toks, decode_arg, cache):
    """A prefill of ``toks[:, :16]``, then teacher-forced decode steps of
    the rest: each call's logits as fp32 numpy."""
    lg, cache = rt.make_prefill_step()(params, {"tokens": toks[:, :16]},
                                       cache)
    out = [np.asarray(lg, np.float32)]
    decode = rt.make_decode_step()
    for i in range(16, toks.shape[1]):
        lg, cache = decode(params, {"tokens": toks[:, i:i + 1]}, cache,
                           decode_arg(i))
        out.append(np.asarray(lg, np.float32))
    return out


class _IntRouter:
    """The reference's int8 router through its own ``layers.dense``: its
    ``moe_ffn`` spells the router product ``xf @ router.astype(dtype)``,
    which a ``QuantTensor`` lacks (an ``AttributeError`` in its int8 serve
    mode); the port's ``moe_ffn`` calls ``dense(xf, router)``, bitwise
    that spelling on a plain array and the int8 GEMM on a
    ``QuantTensor``."""

    def __init__(self, q):
        self.q = q

    def astype(self, dtype):
        return self

    def __rmatmul__(self, x):
        from repro.models.layers import dense

        return dense(x, self.q)


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_granite_q8_serve_matches_reference(mode, group, monkeypatch):
    """granite-moe-1b-a400m's geometry (16/8 heads of 64, 32 experts
    top-8) served from the q8_block store, dense-dequant and with
    ``serve_quant_matmul``: a prefill of 2 x 16 tokens and four
    teacher-forced decode steps, fp32 compute, each package with its own
    bf16 cache, from the reference's q8 init (the port's state built from
    its fp32 masters, its codes checked bitwise the reference's).  In the
    int8 mode the reference's router goes through its own ``dense``
    (``_IntRouter``, in this process: the port's one departure), so both
    sides route with the same int8 GEMM.  Each call's logits within 1e-5
    relative L2 of the reference's in the int8 mode, 5e-4 in the dense
    one: between the sound readings and the least planted fault's (a
    router rounded to bf16, 1.7e-3), all in the module docstring."""
    from repro.kernels import ops as jax_ops
    from repro.models import transformer as jax_transformer

    jcfg, tcfg = _configs(GRANITE)
    sched = {"param_store": "q8_block"}
    if mode == "int8":
        sched["serve_quant_matmul"] = True
        plain = jax_transformer.moe_ffn

        def moe_ffn(cfg, p, x, **kw):
            key = kw.get("prefix", "moe_") + "router"
            if isinstance(p[key], jax_ops.QuantTensor):
                p = {**p, key: _IntRouter(p[key])}
            return plain(cfg, p, x, **kw)

        monkeypatch.setattr(jax_transformer, "moe_ffn", moe_ffn)
    bound = 5e-4 if mode == "dense" else 1e-5
    toks = _tokens(seed=3, T=20)
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32,
                     schedule=JaxSchedule(**sched))
    jparams = jrt.init_params(0)
    want = _serve_stream(jrt, jparams, jnp.asarray(toks, jnp.int32),
                         jnp.int32, jrt.model.init_cache(BATCH, 32))
    rt = FSDPRuntime(build_model(tcfg), group, compute_dtype=torch.float32,
                     device="cpu", schedule=CommSchedule(**sched))
    params = {n: rt.layouts[n].store.create(torch.from_numpy(
        np.array(s["master"]))) for n, s in jparams.items()}
    for n, s in jparams.items():
        assert np.array_equal(params[n]["codes"].numpy(),
                              np.asarray(s["codes"])), n
    got = _serve_stream(rt, params, torch.from_numpy(toks), int,
                        rt.model.init_cache(BATCH, 32, device="cpu"))
    assert got[0].shape == (BATCH, 1, VOCAB)
    for g, w in zip(got, want):
        assert _rel(g, w) < bound
