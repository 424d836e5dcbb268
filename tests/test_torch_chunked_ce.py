"""The vocab-chunked cross entropy (``ModelConfig.ce_chunk``) in the port
against the JAX reference: ``layers.chunked_ce`` on the same numpy inputs
(loss, d/dx and d/dhead; with and without a softcap; a vocab that is a
multiple of the chunk and two that are not), against the port's own
unchunked loss, and five quickstart steps of gemma2-2b.reduced() with
``ce_chunk`` set.

Parity class: ALLCLOSE.  Measured, fp32: losses within rtol 1.7e-7 of the
reference's and 0 of the unchunked loss, gradients within relative L2
2.1e-7 (reference) and 2.8e-7 (unchunked); asserted 1e-6 everywhere.  The
train streams' bounds are in their test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_train_worker as W
from _torch_ref_step import first_step
from repro_torch.launch.mesh import init_local_group
from repro_torch.models import layers as L

torch.set_num_threads(2)

CASES = [(256, 64), (250, 64), (512, 96)]   # (vocab, chunk)
SOFTCAPS = [None, 30.0, 2.0]
TRAIN_CHUNK = 96    # 512 = 5 x 96 + 32: the last chunk padded by 64


def _inputs(V, seed=0, B=2, T=16, D=32):
    rng = np.random.default_rng([seed, V])
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    return x, head, labels, np.ones((B, T), np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _port(fn, x, head, labels, mask, **kw):
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    loss, w = fn(tx, th, torch.from_numpy(labels).long(),
                 torch.from_numpy(mask), **kw)
    loss.backward()
    return float(loss.detach()), float(w), tx.grad.numpy(), th.grad.numpy()


@pytest.mark.parametrize("softcap", SOFTCAPS)
@pytest.mark.parametrize("V,chunk", CASES)
def test_chunked_ce_matches_reference(V, chunk, softcap):
    x, head, labels, mask = _inputs(V)

    def jf(x, h):
        return JL.chunked_ce(x, h, jnp.asarray(labels), jnp.asarray(mask),
                             vocab_chunk=chunk, softcap=softcap)[0]

    jl, (jgx, jgh) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    loss, w, gx, gh = _port(L.chunked_ce, x, head, labels, mask,
                            vocab_chunk=chunk, softcap=softcap)
    assert w == mask.sum()
    np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
    assert _rel_l2(gx, np.asarray(jgx)) < 1e-6
    assert _rel_l2(gh, np.asarray(jgh)) < 1e-6


@pytest.mark.parametrize("softcap", SOFTCAPS)
@pytest.mark.parametrize("V,chunk", CASES)
def test_chunked_ce_matches_unchunked(V, chunk, softcap):
    """Against materialized fp32 logits (``lm_logits`` +
    ``vocab_parallel_ce``): the same function in another sum order."""
    x, head, labels, mask = _inputs(V, seed=1)
    loss, _, gx, gh = _port(L.chunked_ce, x, head, labels, mask,
                            vocab_chunk=chunk, softcap=softcap)

    def unchunked(x, h, labels, mask):
        return L.vocab_parallel_ce(L.lm_logits(x, h, softcap=softcap),
                                   labels, mask)

    uloss, _, ugx, ugh = _port(unchunked, x, head, labels, mask)
    np.testing.assert_allclose(loss, uloss, rtol=1e-6)
    assert _rel_l2(gx, ugx) < 1e-6
    assert _rel_l2(gh, ugh) < 1e-6


def test_chunked_ce_keeps_no_chunk_logits():
    """Backward recomputes each chunk: autograd holds no (B, T, chunk)
    tensor between forward and backward (only the head's (D, chunk)
    views, the checkpoints' inputs)."""
    x, head, labels, mask = _inputs(512)
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = L.chunked_ce(tx, th, torch.from_numpy(labels).long(),
                               torch.from_numpy(mask), vocab_chunk=64)
    n_chunk = [s for s in saved if len(s) == 3 and s[-1] == 64]
    assert not n_chunk, n_chunk
    loss.backward()
    assert th.grad is not None and bool(torch.isfinite(th.grad).all())


def _jax_stream(chunk, steps):
    cfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                              learning_rate=W.LR, ce_chunk=chunk)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32, donate=False)
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = first_step(rt)
    out = []
    for i in range(steps):
        params, state, step, m = step_fn(params, state, step,
                                         stream.shard(stream.batch(i), rt))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return np.asarray(out), {k: np.asarray(v) for k, v in params.items()}


def test_ce_chunk_train_matches_reference():
    """Five quickstart steps with ``ce_chunk`` = 96 (six chunks, the last
    padded by 64), fp32: the port's streams against the reference's with
    the same chunk, and against the port's unchunked run.  Measured:
    loss rtol 4.0e-7, grad norm 1.5e-6, masters relative L2 6.0e-6 against
    the reference; 6.7e-8 and 3.5e-7 against the unchunked run.
    Asserted: the bounds tests/test_torch_train.py states for the default
    (streams rtol 1e-4, masters relative L2 5e-5)."""
    steps = 5
    ref, ref_final = _jax_stream(TRAIN_CHUNK, steps)
    group = init_local_group("gloo")
    losses, norms, _, params, _ = W.train(
        group, torch.float32, steps, overrides={"ce_chunk": TRAIN_CHUNK})
    np.testing.assert_allclose(losses, ref[:, 0], rtol=1e-4)
    np.testing.assert_allclose(norms, ref[:, 1], rtol=1e-4)
    for k, want in ref_final.items():
        assert _rel_l2(params[k].detach().numpy(), want) < 5e-5, k
    ul, un, _, _, _ = W.train(group, torch.float32, steps)
    np.testing.assert_allclose(losses, ul, rtol=1e-4)
    np.testing.assert_allclose(norms, un, rtol=1e-4)
