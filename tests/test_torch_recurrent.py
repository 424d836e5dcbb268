"""The recurrent families -- xLSTM-125m (``arch_type="ssm"``) and
Hymba-1.5b (``"hybrid"``) -- in the port (``repro_torch.models.recurrent``)
against the JAX reference (``repro.models.recurrent``): configs and
published-width plans, the serve cache's layout, five AdamW steps, a
reference state carried across, two gloo ranks against one, prefill and
decode logits, the incremental decode against a prefill of the same
prefix, and the serve engine's slot reset.  fp32 compute; tokens from a
numpy seed go to both packages; weights are both packages' seeded init
(bitwise the same).

Both configs are ``.reduced()``; Hymba's at 4 layers rather than 2, so
that layer 1 is a windowed one (window 16; layers 0, 2 and 3 global) and
the sequences (64 tokens to train, 20 to prefill) reach past its window.

Parity classes, measured (bounds asserted per test):
  * configs, plans, cache layout: EXACT (the plans string-equal); the one
    departure is Hymba's conv window, fp32 in the port where the
    reference declares bf16 (its serve steps return it in the compute
    dtype: ``models/recurrent.py``);
  * train streams: ALLCLOSE, the mixers' class (tests/test_torch_ssm.py)
    carried through five AdamW steps at lr 1e-2.  xLSTM reads loss 2.3e-7,
    grad norm 1.0e-7 (relative); Hymba 3.4e-6 and 3.4e-5: each Adam step
    normalises every gradient element, so the elements near zero turn
    fp32 rounding into whole steps (at lr 3e-4 the same run reads 1.2e-7
    and 3.9e-6); final masters within relative L2 1.2e-7 (xLSTM) and
    8.2e-5 (Hymba).  Asserted: 1e-5 / 1e-5 / 1e-5 (xLSTM), 2e-5 / 2e-4 /
    5e-4 (Hymba); two gloo ranks against one read 4.5e-5 (Hymba's grad
    norm) and 9.0e-6 (masters), under the same stream bounds and 1e-4;
  * serve logits: ALLCLOSE.  xLSTM (all fp32 state) within 1.4e-6
    relative L2; Hymba within 4.0e-4, its bf16 KV cache's class (a key
    or value within rounding of a bf16 midpoint rounds the other way, as
    in tests/test_torch_serve.py).  Asserted: 1e-5 and 1.5e-3;
  * the incremental decode against a fresh prefill of each longer prefix
    (the port alone): up to 5.5e-7 (xLSTM) and 1.4e-5 (Hymba).
    Asserted: 1e-4;
  * the engine: EXACT tokens.
"""
import dataclasses
import multiprocessing

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core import policy as jax_policy
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine

import _torch_train_worker as W
from repro_torch.configs import build_model, get_config, with_tp
from repro_torch.core import policy
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.launch.mesh import init_local_group, production_axis_sizes
from repro_torch.models.cache import leaves
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

ARCHS = {"xlstm-125m": {}, "hymba-1.5b": {"n_layers": 4}}
STEPS, SNAP = 5, 3
STREAM_RTOL = {"xlstm-125m": (1e-5, 1e-5), "hymba-1.5b": (2e-5, 2e-4)}
MASTER_BOUND = {"xlstm-125m": 1e-5, "hymba-1.5b": 5e-4}
SERVE_BOUND = {"xlstm-125m": 1e-5, "hymba-1.5b": 1.5e-3}
INCREMENTAL_BOUND = 1e-4
B, P, K, S = 2, 20, 6, 32


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _configs(arch):
    """(reference config, port config): ``.reduced()``, Hymba at 4
    layers."""
    ov = ARCHS[arch]
    return (dataclasses.replace(jax_get_config(arch).reduced(), **ov),
            dataclasses.replace(get_config(arch).reduced(), **ov))


@pytest.fixture(scope="module")
def group():
    return init_local_group("gloo")


# ---------------------------------------------------------------------------
# configs, plans, the cache's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_and_model_match_reference(arch):
    """Every field of the port's config equals the reference's; the model
    has the reference's groups and tensor specs, in order."""
    t, j = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    tm, jm = build_model(t), jax_build_model(j)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.n_blocks == jm.n_blocks
    for name, g in jm.groups().items():
        assert [(s.name, s.shape, s.granularity, g.n_layers)
                for s in g.specs] == \
            [(s.name, s.shape, s.granularity, tm.groups()[name].n_layers)
             for s in tm.groups()[name].specs], name
    assert list(tm.groups()) == list(jm.groups())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_published_width_plans_string_equal(arch):
    """The ShardingPlan of the config at published width and depth is
    string-equal to the reference's on one rank, on 8 and on the
    production mesh (16 x 16)."""
    tm, jm = build_model(get_config(arch)), jax_build_model(
        jax_get_config(arch))
    for mesh in ({"data": 1, "model": 1}, {"data": 8, "model": 1},
                 production_axis_sizes()):
        got = policy.plan(tm, mesh)
        want = jax_policy.make_plan(jm, mesh, None)
        assert got.dumps() == want.dumps(), mesh
        assert got.describe() == want.describe(), mesh


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_layout_and_fill(arch, group):
    """The cache's nesting, shapes, batch dims and empty values are the
    reference's (Hymba's conv window fp32 where the reference declares
    bf16); the runtime's cache equals the model's at one rank; the sLSTM
    stabiliser starts at -1e30."""
    jc, tc = _configs(arch)
    jm, tm = jax_build_model(jc), build_model(tc)
    want = jm.cache_shapes(3, S)
    got = tm.cache_shapes(3, S)
    assert sorted(p for p, _ in leaves(got)) == sorted(
        p for p, _ in leaves(want))
    for path, (shape, dtype) in leaves(got):
        ref = want
        for k in path:
            ref = ref[k]
        assert tuple(shape) == tuple(ref[0]), path
        if path == ("ssm", "conv"):
            assert dtype == torch.float32
            assert str(np.dtype(ref[1])) == "bfloat16"
        else:
            assert str(dtype).split(".")[-1] == str(np.dtype(ref[1])), path
    assert tm.cache_batch_dims() == jm.cache_batch_dims()
    ref_cache = jm.init_cache(3, S)
    cache = tm.init_cache(3, S, device="cpu")
    for path, t in leaves(cache):
        ref = ref_cache
        for k in path:
            ref = ref[k]
        assert np.array_equal(t.float().numpy(),
                              np.asarray(ref, np.float32)), path
    rt = FSDPRuntime(tm, group, compute_dtype=torch.float32, device="cpu")
    for (p1, a), (p2, b) in zip(leaves(rt.init_cache(3, S)), leaves(cache)):
        assert p1 == p2 and a.dtype == b.dtype and torch.equal(a, b)
    if arch == "xlstm-125m":
        assert bool((cache["s"]["m"] == -1e30).all())


def test_recurrent_models_refuse_a_model_axis():
    for arch in ARCHS:
        with pytest.raises(ValueError, match="without a model axis"):
            build_model(with_tp(get_config(arch), 2))


# ---------------------------------------------------------------------------
# five AdamW steps
# ---------------------------------------------------------------------------

def _jax_stream(arch):
    """Five reference steps; snapshots (params, m, v) after SNAP steps."""
    jc, _ = _configs(arch)
    cfg = dataclasses.replace(jc, learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32)
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = jnp.int32(0)
    losses, norms, snap = [], [], None
    for i in range(STEPS):
        if i == SNAP:
            snap = ({k: np.asarray(v) for k, v in params.items()},
                    {s: {k: np.asarray(v) for k, v in state[s].items()}
                     for s in ("m", "v")})
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final={k: np.asarray(v) for k, v in params.items()},
                snap=snap)


@pytest.fixture(scope="module")
def ref_streams():
    return {arch: _jax_stream(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def port_streams(group):
    out = {}
    for arch, ov in ARCHS.items():
        losses, norms, _, params, _ = W.train(group, torch.float32, STEPS,
                                              arch=arch, overrides=ov)
        out[arch] = dict(losses=np.asarray(losses), norms=np.asarray(norms),
                         final={k: p.detach().numpy()
                                for k, p in params.items()})
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_stream_matches_reference(arch, ref_streams, port_streams):
    """Five AdamW steps of 8 x 64 tokens: the loss and grad-norm streams
    and the final masters within the module docstring's bounds."""
    ref, got = ref_streams[arch], port_streams[arch]
    loss_rtol, norm_rtol = STREAM_RTOL[arch]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol)
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=norm_rtol)
    assert got["losses"][-1] < got["losses"][0]
    for name, want in ref["final"].items():
        assert _rel(got["final"][name], want) < MASTER_BOUND[arch], name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_load_reference_state_resumes(arch, ref_streams, group):
    """The reference's state after three steps (parameters, AdamW's m and
    v as numpy arrays), carried into the port bitwise, then the last two
    steps: the reference's steps four and five within the stream
    bounds."""
    params_np, opt_np = ref_streams[arch]["snap"]

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for name in params_np:
            assert np.array_equal(params[name].detach().numpy(),
                                  params_np[name])
        return params, opt_state

    losses, norms, *_ = W.train(group, torch.float32, STEPS - SNAP,
                                first_step=SNAP, state=state, arch=arch,
                                overrides=ARCHS[arch])
    loss_rtol, norm_rtol = STREAM_RTOL[arch]
    np.testing.assert_allclose(losses, ref_streams[arch]["losses"][SNAP:],
                               rtol=loss_rtol)
    np.testing.assert_allclose(norms, ref_streams[arch]["norms"][SNAP:],
                               rtol=norm_rtol)


def test_two_ranks_match_one_rank(tmp_path, port_streams):
    """Both families on two gloo ranks (one spawn): each rank holds half of
    every group's columns and half the batch, and the gradients are summed
    in another order.  Streams within the bounds against the reference
    (``STREAM_RTOL``: Hymba's grad norm read 4.5e-5 at step five, the
    Adam amplification the module docstring describes) and masters within
    relative L2 1e-4 of the one-rank runs."""
    ctx = multiprocessing.get_context("spawn")
    runs = [(arch, arch, ov) for arch, ov in ARCHS.items()]
    prefix = str(tmp_path / "run_")
    procs = [ctx.Process(target=W.rank_main_runs,
                         args=(r, 2, str(tmp_path / "store"), prefix, STEPS,
                               runs))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0, 0]
    for arch in ARCHS:
        one = port_streams[arch]
        outs = [np.load(f"{prefix}{arch}_{r}.npz") for r in range(2)]
        loss_rtol, norm_rtol = STREAM_RTOL[arch]
        for o in outs:
            np.testing.assert_allclose(o["losses"], one["losses"],
                                       rtol=loss_rtol)
            np.testing.assert_allclose(o["norms"], one["norms"],
                                       rtol=norm_rtol)
        for name, want in one["final"].items():
            got = np.concatenate([o[name] for o in outs], axis=-1)
            assert got.shape == want.shape
            assert _rel(got, want) < 1e-4, (arch, name)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, P + K))


def _port_serve(arch, group):
    _, tc = _configs(arch)
    model = build_model(tc)
    rt = FSDPRuntime(model, group, compute_dtype=torch.float32, device="cpu")
    return model, rt, rt.init_params(0)


def _port_stream(rt, params, toks):
    """Prefill of P tokens, then K - 1 teacher-forced decode steps: the
    logits of each call."""
    cache = rt.init_cache(B, S)
    t = torch.from_numpy(toks)
    lg, cache = rt.make_prefill_step()(params, {"tokens": t[:, :P]}, cache)
    out = [lg.numpy()]
    decode = rt.make_decode_step()
    for i in range(P, P + K - 1):
        lg, cache = decode(params, {"tokens": t[:, i:i + 1]}, cache, i)
        out.append(lg.numpy())
    return out


def _jax_serve(arch):
    jc, _ = _configs(arch)
    model = jax_build_model(jc)
    rt = JaxRuntime(model, make_local_mesh(1, 1), compute_dtype=jnp.float32)
    return model, rt, rt.init_params(0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch, group):
    """A prefill of 2 x 20 tokens into a 32-slot cache, then five decode
    steps from the state it left: each call's logits against the
    reference's."""
    toks = _tokens(_configs(arch)[1].vocab)
    _, rt, params = _port_serve(arch, group)
    got = _port_stream(rt, params, toks)
    jm, jrt, jparams = _jax_serve(arch)
    cache = jm.init_cache(B, S)
    t = jnp.asarray(toks, jnp.int32)
    lg, cache = jrt.make_prefill_step()(jparams, {"tokens": t[:, :P]}, cache)
    want = [np.asarray(lg, np.float32)]
    decode = jrt.make_decode_step()
    for i in range(P, P + K - 1):
        lg, cache = decode(jparams, {"tokens": t[:, i:i + 1]}, cache,
                           jnp.int32(i))
        want.append(np.asarray(lg, np.float32))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (B, 1, rt.cfg.vocab)
        assert _rel(a, b) < SERVE_BOUND[arch], (arch, i)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_incremental_decode_matches_prefill(arch, group):
    """Decoding token by token from the cache equals a fresh prefill of each
    longer prefix (ref ``tests/test_decode_consistency.py``): the state the
    serve steps leave in the cache is the state a longer prompt reaches."""
    toks = _tokens(_configs(arch)[1].vocab, seed=1)
    _, rt, params = _port_serve(arch, group)
    inc = _port_stream(rt, params, toks)
    prefill = rt.make_prefill_step()
    for j, t in enumerate(range(P, P + K)):
        lg, _ = prefill(params, {"tokens": torch.from_numpy(toks[:, :t])},
                        rt.init_cache(B, S))
        assert _rel(inc[j], lg.numpy()) < INCREMENTAL_BOUND, (arch, j)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (5,)) for _ in range(3)]


def _engine_tokens(make_engine, make_request, prompts):
    """(tokens of the three requests through one engine of a pool of 1,
    tokens of each served alone by an engine of its own)."""
    eng = make_engine()
    reqs = [make_request(i, p) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    alone = []
    for i, p in enumerate(prompts):
        e = make_engine()
        r = make_request(i, p)
        e.submit(r)
        e.run()
        alone.append(list(r.out))
    return [list(r.out) for r in reqs], alone


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_slot_reuse_resets_the_state(arch, group):
    """Three requests through a pool of one slot: in the port each gets the
    tokens it gets alone (the slot's row returns to the empty cache on
    admission); in the reference the second and third continue from the
    previous occupant's recurrent state and differ.  The first request,
    which finds an empty slot, gets the same tokens in both packages."""
    model, rt, params = _port_serve(arch, group)
    prompts = _prompts(model.cfg.vocab)
    got, alone = _engine_tokens(
        lambda: ServeEngine(rt, model, params, pool=1, max_len=S),
        lambda i, p: Request(uid=i, prompt=p, max_new=6), prompts)
    assert all(len(t) == 6 for t in got)
    assert got == alone

    jm, jrt, jparams = _jax_serve(arch)
    decode = jrt.make_decode_step()

    def jax_engine():
        eng = JaxEngine(jrt, jm, jparams, pool=1, max_len=S)
        eng._decode = decode        # one compiled step for every engine
        return eng

    ref_got, ref_alone = _engine_tokens(
        jax_engine, lambda i, p: JaxRequest(uid=i, prompt=p, max_new=6),
        prompts)
    assert ref_got[0] == ref_alone[0] == alone[0]
    assert ref_got[1] != ref_alone[1] and ref_got[2] != ref_alone[2]
