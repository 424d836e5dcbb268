"""The encoder-decoder family -- seamless-m4t-medium (``arch_type="audio"``)
-- in the port (``repro_torch.models.encdec``) against the JAX reference
(``repro.models.encdec``): the config, the model's groups and the plans
(``.reduced()`` and at published width), the stream's frames, the loss
and gradients at init, the layer gathers of a step over the two stacks,
five AdamW steps, and the prefill and decode logits.  fp32 compute;
tokens and frames from a numpy seed go to both packages; weights are
both packages' seeded init (bitwise the same).

Parity classes, measured (bounds asserted per test):
  * config, groups, plans, cache layout, frames: EXACT (plans
    string-equal; frames bitwise: both round the same fp64 draws to bf16);
  * loss at init: rtol 1.2e-7; gradients relative L2 up to 1.6e-5 a
    group.  Asserted: 1e-6 and 5e-5;
  * gathers a step: EQUAL the reference's schedule (each stack's layers
    forward and again in the recompute, ``globals`` once);
  * train stream (lr 1e-2, 8 x 64 tokens with 16 frames): loss up to
    7.7e-6 relative, grad norm 1.7e-4 (each Adam step normalises every
    gradient element, so the elements near zero turn fp32 rounding into
    whole steps, as for Hymba in tests/test_torch_recurrent.py), final
    masters within relative L2 8.2e-5.  Asserted: 2e-5, 5e-4, 2e-4;
  * serve: the bf16 memory the prefill leaves within relative L2 5.0e-5
    of the reference's (a value within rounding of a bf16 midpoint
    rounds the other way; asserted 1e-3); the logits within 5.9e-4, the
    class of the bf16 KV cache and memory.  Asserted: 1.5e-3.
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
from repro.core import policy as jax_policy
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_train_worker as W
from repro_torch.configs import build_model, get_config, with_tp
from repro_torch.core import policy
from repro_torch.core.fsdp import FSDPRuntime, _ParamGetter
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group, production_axis_sizes
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
STEPS = 5
LOSS_RTOL, GRAD_BOUND = 1e-6, 5e-5
STREAM_RTOL = (2e-5, 5e-4)
MASTER_BOUND = 2e-4
SERVE_BOUND = 1.5e-3
B, PROMPT, DECODES, S = 2, 12, 5, 24


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def group():
    return init_local_group("gloo")


# ---------------------------------------------------------------------------
# config, groups, plans, frames
# ---------------------------------------------------------------------------

def test_config_groups_and_cache_match_reference():
    """Every config field; the groups (two stacks and ``globals``), their
    tensor specs in order and depths; the cache's shapes, dtypes, batch
    dims and empty values, at published width and ``.reduced()``."""
    for t, j in ((get_config(ARCH), jax_get_config(ARCH)),
                 (get_config(ARCH).reduced(), jax_get_config(ARCH).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        tm, jm = build_model(t), jax_build_model(j)
        assert list(tm.groups()) == list(jm.groups()) == [
            "enc_layers", "dec_layers", "globals"]
        for name, g in jm.groups().items():
            tg = tm.groups()[name]
            assert [(s.name, s.shape, s.granularity) for s in g.specs] == \
                [(s.name, s.shape, s.granularity) for s in tg.specs], name
            assert g.n_layers == tg.n_layers, name
        want = jm.cache_shapes(3, S)
        for k, (shape, dtype) in tm.cache_shapes(3, S).items():
            assert tuple(shape) == tuple(want[k][0]), k
            assert str(dtype).split(".")[-1] == str(np.dtype(want[k][1])), k
        assert tm.cache_batch_dims() == jm.cache_batch_dims()
    ref = jm.init_cache(3, S)
    for k, t in tm.init_cache(3, S, device="cpu").items():
        assert np.array_equal(t.float().numpy(), np.asarray(ref[k],
                                                            np.float32)), k
    with pytest.raises(ValueError, match="without a model axis"):
        build_model(with_tp(get_config(ARCH), 2))


@pytest.mark.parametrize("width", ["reduced", "published"])
def test_plans_string_equal(width):
    """The ShardingPlan on one rank, on 8 and on the production mesh (16
    x 16) is string-equal to the reference's."""
    t, j = get_config(ARCH), jax_get_config(ARCH)
    if width == "reduced":
        t, j = t.reduced(), j.reduced()
    tm, jm = build_model(t), jax_build_model(j)
    for mesh in ({"data": 1, "model": 1}, {"data": 8, "model": 1},
                 production_axis_sizes()):
        got = policy.plan(tm, mesh)
        want = jax_policy.make_plan(jm, mesh, None)
        assert got.dumps() == want.dumps(), mesh
        assert got.describe() == want.describe(), mesh


def test_stream_frames_bitwise():
    """The batch's tokens and its bf16 frames (B, min(n_frames, T), D),
    drawn after the tokens, bitwise the reference's at three steps and
    two sequence lengths (shorter and longer than n_frames)."""
    for seq in (8, 64):
        t = SyntheticStream(DataConfig(512, seq, 4), get_config(ARCH)
                            .reduced())
        j = JaxStream(JaxDataConfig(512, seq, 4), jax_get_config(ARCH)
                      .reduced())
        for step in (0, 1, 7):
            got, want = t.batch(step), j.batch(step)
            assert sorted(got) == sorted(want) == ["frames", "tokens"]
            assert np.array_equal(got["tokens"], np.asarray(want["tokens"]))
            f = got["frames"]
            assert f.dtype == torch.bfloat16
            assert tuple(f.shape) == (4, min(16, seq), 256)
            assert np.array_equal(f.view(torch.int16).numpy(),
                                  np.asarray(want["frames"]).view(np.int16))


# ---------------------------------------------------------------------------
# loss and gradients at init; the layer gathers of a step
# ---------------------------------------------------------------------------

def _batch(cfg, seq=64, rows=8):
    return SyntheticStream(DataConfig(cfg.vocab, seq, rows), cfg).batch(0)


def test_loss_and_grads_at_init_match_reference(group):
    """The reduced config at init on one batch of 8 x 64 tokens and 16
    frames: the summed NLL and each group's gradient buffer."""
    jc, tc = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    host = _batch(tc)
    rt = FSDPRuntime(build_model(tc), group, compute_dtype=torch.float32,
                     device="cpu")
    params = rt.init_params(0)
    for p in params.values():
        p.grad = torch.zeros_like(p)   # the gathers' gradient sinks
    batch = {"tokens": torch.from_numpy(host["tokens"]).long(),
             "frames": host["frames"]}
    nll, w = rt.model.loss(_ParamGetter(rt, params), batch)
    nll.backward()
    got = {n: p.grad.numpy() for n, p in params.items()}

    jrt = JaxRuntime(jax_build_model(jc), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    jb = JaxStream(JaxDataConfig(jc.vocab, 64, 8), jc).batch(0)

    def fn(params, batch):
        return jrt.model.loss(jrt._getter(params), batch)

    f = shard_map(fn, mesh=jrt.mesh,
                  in_specs=(jrt._param_specs(), jrt.batch_pspec(jb)),
                  out_specs=(P(), P()))
    (jn, jw), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jrt.init_params(0), jb)
    assert float(w) == float(jw) == 8 * 63
    np.testing.assert_allclose(float(nll.detach()), float(jn),
                               rtol=LOSS_RTOL)
    assert sorted(got) == sorted(jg)
    for name, want in jg.items():
        assert got[name].shape == want.shape
        assert _rel(got[name], want) < GRAD_BOUND, name


@pytest.mark.parametrize("sched", [{}, {"prefetch": True},
                                   {"keep_last_gathered": True}],
                         ids=["default", "prefetch", "keep_last"])
def test_gathers_per_step_follow_the_reference_schedule(sched, group,
                                                        monkeypatch):
    """Two stacks in one step: the layer loop resolves its schedule per
    stack (``plan_layers`` of each stack's depth), so a step gathers each
    stack's layers forward and, where the schedule reshards, again in the
    recompute, and ``globals`` once: the reference's ``plan_layers`` of
    each stack.  At 3 encoder and 2 decoder layers a pair and a tail."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), encoder_layers=3)
    calls = []
    gather = _ParamGetter._gather

    def counted(self, name, layer=None, started=None):
        calls.append((name, layer))
        return gather(self, name, layer, started)

    monkeypatch.setattr(_ParamGetter, "_gather", counted)
    rt = FSDPRuntime(build_model(cfg), group, compute_dtype=torch.float32,
                     device="cpu", schedule=CommSchedule(**sched))
    opt = make_optimizer(cfg)
    stream = SyntheticStream(DataConfig(cfg.vocab, 16, 2), cfg)
    rt.make_train_step(opt)(rt.init_params(0), opt.init(rt), 0,
                            stream.shard(stream.batch(0), rt))
    ref = JaxSchedule(**sched)
    for name, n in (("enc_layers", 3), ("dec_layers", 2)):
        want = n + ref.plan_layers(n).main
        assert sum(c[0] == name for c in calls) == want, name
        assert sorted({c[1] for c in calls if c[0] == name}) == \
            list(range(n))
    assert calls.count(("globals", None)) == 1


# ---------------------------------------------------------------------------
# five AdamW steps
# ---------------------------------------------------------------------------

def test_train_stream_matches_reference(group):
    """Five AdamW steps of 8 x 64 tokens with 16 frames: the loss and
    grad-norm streams and the final masters within the module
    docstring's bounds; the loss falls."""
    jc = dataclasses.replace(jax_get_config(ARCH).reduced(),
                             learning_rate=W.LR)
    jrt = JaxRuntime(jax_build_model(jc), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    params = jrt.init_params(0)
    opt = jax_make_optimizer(jc)
    state = opt.init(jrt)
    step_fn = jrt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(jc.vocab, W.SEQ, W.BATCH), jc)
    step = jnp.int32(0)
    want = []
    for i in range(STEPS):
        params, state, step, m = step_fn(params, state, step,
                                         stream.shard(stream.batch(i), jrt))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    want = np.asarray(want)
    losses, norms, _, got, _ = W.train(group, torch.float32, STEPS,
                                       arch=ARCH)
    np.testing.assert_allclose(losses, want[:, 0], rtol=STREAM_RTOL[0])
    np.testing.assert_allclose(norms, want[:, 1], rtol=STREAM_RTOL[1])
    assert losses[-1] < losses[0]
    for name, p in got.items():
        assert _rel(p.detach().numpy(), np.asarray(params[name])) \
            < MASTER_BOUND, name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(group):
    """A prefill of 2 x 12 tokens over 16 frames into a 24-slot cache
    (the encoder's output written into the cache's memory), then five
    teacher-forced decode steps reading the bf16 memory back: each
    call's logits against the reference's, and the memory the prefill
    left against the reference's cache."""
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + DECODES))
    frames = torch.from_numpy(rng.normal(
        size=(B, cfg.n_frames, cfg.d_model))).to(torch.bfloat16)

    rt = FSDPRuntime(build_model(cfg), group, compute_dtype=torch.float32,
                     device="cpu")
    params = rt.init_params(0)
    cache = rt.init_cache(B, S)
    memory = cache["memory"]
    t = torch.from_numpy(toks)
    lg, cache = rt.make_prefill_step()(
        params, {"tokens": t[:, :PROMPT], "frames": frames}, cache)
    assert cache["memory"] is memory and bool(memory.abs().sum() > 0)
    got = [lg.numpy()]
    decode = rt.make_decode_step()
    for i in range(PROMPT, PROMPT + DECODES - 1):
        lg, cache = decode(params, {"tokens": t[:, i:i + 1]}, cache, i)
        got.append(lg.numpy())

    jm = jax_build_model(jax_get_config(ARCH).reduced())
    jrt = JaxRuntime(jm, make_local_mesh(1, 1), compute_dtype=jnp.float32)
    jparams = jrt.init_params(0)
    jt = jnp.asarray(toks, jnp.int32)
    jf = jnp.asarray(frames.view(torch.int16).numpy().view(jnp.bfloat16))
    lg, jcache = jrt.make_prefill_step()(
        jparams, {"tokens": jt[:, :PROMPT], "frames": jf}, jm.init_cache(B, S))
    assert _rel(memory.float().numpy(), np.asarray(jcache["memory"],
                                                   np.float32)) < 1e-3
    want = [np.asarray(lg, np.float32)]
    jdecode = jrt.make_decode_step()
    for i in range(PROMPT, PROMPT + DECODES - 1):
        lg, jcache = jdecode(jparams, {"tokens": jt[:, i:i + 1]}, jcache,
                             jnp.int32(i))
        want.append(np.asarray(lg, np.float32))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (B, 1, cfg.vocab)
        assert _rel(a, b) < SERVE_BOUND, i
