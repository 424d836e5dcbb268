"""The port's dense decoder against the JAX reference: layer primitives and
``DecoderLM.loss`` on ``gemma2-2b.reduced()`` from the same init and batch.

Parity class: ALLCLOSE.
  * fp32 compute: the two agree to float rounding (transcendentals and
    matmul sums round differently); measured loss rtol 1.1e-6, asserted
    rtol 1e-5.
  * bf16 compute: both round to bf16 at the same points, but the two
    frameworks' bf16 kernels (gelu, tanh, matmul accumulation) differ in
    the last bf16 bits; measured loss rtol 2.4e-4, asserted 2e-3.
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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL

from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime, _ParamGetter
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group
from repro_torch.models import layers as TL

torch.set_num_threads(2)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_rms_norm_matches():
    r = _rng(1)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    s = (r.standard_normal(64) * 0.1).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    _close(got, want, 1e-6, 1e-6)


def test_rope_matches():
    r = _rng(2)
    x = r.standard_normal((2, 3, 40, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10000.0)
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("window,chunk", [(None, 64), (16, 64), (16, 24)],
                         ids=["causal", "window", "window_chunked"])
def test_chunked_attention_matches(window, chunk):
    r = _rng(3)
    B, Hq, Hkv, T, hd = 2, 4, 2, 64, 16
    q = r.standard_normal((B, Hq, T, hd)).astype(np.float32)
    k = r.standard_normal((B, Hkv, T, hd)).astype(np.float32)
    v = r.standard_normal((B, Hkv, T, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    want = JL.chunked_attention(
        *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), window=window, softcap=50.0, chunk=chunk)
    tp = torch.from_numpy(pos).long()
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), q_pos=tp,
                               kv_pos=tp, window=window, softcap=50.0,
                               chunk=chunk)
    _close(got, want, 1e-5, 1e-5)


def test_geglu_mlp_matches():
    cfg = get_config("gemma2-2b").reduced()
    r = _rng(4)
    x = r.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    p = {n: (r.standard_normal(s) * 0.05).astype(np.float32) for n, s in
         (("w1", (cfg.d_model, cfg.d_ff)), ("w3", (cfg.d_model, cfg.d_ff)),
          ("w2", (cfg.d_ff, cfg.d_model)))}
    want = JL.mlp(jax_get_config("gemma2-2b").reduced(),
                  {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x))
    got = TL.mlp(cfg, {k: torch.from_numpy(a) for k, a in p.items()},
                 torch.from_numpy(x))
    _close(got, want, 1e-5, 1e-6)


def test_softcapped_ce_matches():
    r = _rng(5)
    x = r.standard_normal((2, 9, 32)).astype(np.float32)
    head = (r.standard_normal((32, 100)) * 0.3).astype(np.float32)
    labels = r.integers(0, 100, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.float32)
    jl = JL.lm_logits(jnp.asarray(x), jnp.asarray(head), softcap=30.0)
    want = JL.vocab_parallel_ce(jl, jnp.asarray(labels), jnp.asarray(mask))
    tl = TL.lm_logits(torch.from_numpy(x), torch.from_numpy(head),
                      softcap=30.0)
    got = TL.vocab_parallel_ce(tl, torch.from_numpy(labels).long(),
                               torch.from_numpy(mask))
    _close(got[0], want[0], 1e-6, 0)
    assert float(got[1]) == float(want[1])


def test_embed_grad_is_the_token_order_sum():
    """Forward bitwise the reference's masked take (ids out of range embed
    to zero).  The gradient is bitwise the token-order sum (``np.add.at``)
    on every run -- the gradient of ``emb[ids]`` is a parallel atomic
    ``index_put_`` on the CPU whose sum order changes between runs -- and
    within rtol 1e-6 of the reference's."""
    r = _rng(6)
    V, D = 40, 1024
    tokens = r.integers(-3, V + 3, (8, 256))
    emb = r.standard_normal((V, D)).astype(np.float32)
    ct = r.standard_normal((8, 256, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda e: JL.embed(jnp.asarray(tokens), e),
                        jnp.asarray(emb))
    (want_grad,) = vjp(jnp.asarray(ct))
    ok = (tokens >= 0) & (tokens < V)
    order_sum = np.zeros_like(emb)
    np.add.at(order_sum, np.clip(tokens, 0, V - 1).reshape(-1),
              (ct * ok[..., None]).reshape(-1, D))
    for _ in range(3):
        e = torch.from_numpy(emb).requires_grad_()
        got = TL.embed(torch.from_numpy(tokens), e)
        got.backward(torch.from_numpy(ct))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(e.grad.numpy(), order_sum)
    _close(e.grad, want_grad, 1e-6, 1e-6)


def _jax_loss(cfg, dtype, tokens):
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=dtype)
    params = rt.init_params(0)
    batch = {"tokens": jnp.asarray(tokens)}

    def fn(params, batch):
        return rt.model.loss(rt._getter(params), batch)

    f = shard_map(fn, mesh=rt.mesh,
                  in_specs=(rt._param_specs(), rt.batch_pspec(batch)),
                  out_specs=(P(), P()))
    nll, w = jax.jit(f)(params, batch)
    return float(nll), float(w)


def _torch_loss(cfg, dtype, tokens):
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     compute_dtype=dtype, device="cpu")
    params = rt.init_params(0)
    for p in params.values():
        p.grad = torch.zeros_like(p)
    with torch.no_grad():
        batch = {"tokens": torch.tensor(tokens, dtype=torch.long)}
        nll, w = rt.model.loss(_ParamGetter(rt, params), batch)
    return float(nll), float(w)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-3)])
def test_decoder_loss_matches_reference(dtype, rtol):
    jcfg = jax_get_config("gemma2-2b").reduced()
    tcfg = get_config("gemma2-2b").reduced()
    tokens = JaxStream(JaxDataConfig(jcfg.vocab, 64, 8), None).batch(0)
    tokens = np.asarray(tokens["tokens"])
    assert np.array_equal(
        tokens, SyntheticStream(DataConfig(tcfg.vocab, 64, 8)).batch(0)
        ["tokens"])
    want = _jax_loss(jcfg, getattr(jnp, dtype), tokens)
    got = _torch_loss(tcfg, getattr(torch, dtype), tokens)
    assert got[1] == want[1] == 8 * 63
    _close(got[0] / got[1], want[0] / want[1], rtol, 0)


def test_decoder_groups_match_reference():
    """Same communication groups, tensor names, shapes and windows."""
    for reduce in (False, True):
        jcfg = jax_get_config("gemma2-2b")
        tcfg = get_config("gemma2-2b")
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jm, tm = jax_build_model(jcfg), build_model(tcfg)
        jg, tg = jm.groups(), tm.groups()
        assert list(jg) == list(tg)
        for name in jg:
            assert [(s.name, s.shape, s.granularity) for s in jg[name].specs] \
                == [(s.name, s.shape, s.granularity) for s in tg[name].specs]
            assert jg[name].n_layers == tg[name].n_layers
        assert np.asarray(jm._layer_windows()).tolist() == tm._layer_windows()


def test_unported_model_options_raise():
    """VLM cross-attention (ported) builds the reference's groups on any
    decoder config, and a depth its interval does not divide raises the
    reference's error; ``ce_chunk`` (ported) builds."""
    from repro.configs import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config

    base = get_config("gemma2-2b").reduced()
    kw = dict(cross_attn_interval=2, n_layers=4)
    tm = build_model(dataclasses.replace(base, **kw))
    jm = jax_build_model(dataclasses.replace(
        jax_get_config("gemma2-2b").reduced(), **kw))
    assert (tm.n_blocks, tm.selfs_per_block) == (jm.n_blocks,
                                                 jm.selfs_per_block) == (2, 1)
    for name, g in jm.groups().items():
        assert [(s.name, s.shape) for s in g.specs] == \
            [(s.name, s.shape) for s in tm.groups()[name].specs], name
    with pytest.raises(ValueError, match="not divisible by "
                       "cross_attn_interval=2"):
        build_model(dataclasses.replace(base, cross_attn_interval=2,
                                        n_layers=3))
    assert build_model(dataclasses.replace(base, ce_chunk=64)).cfg.ce_chunk \
        == 64
