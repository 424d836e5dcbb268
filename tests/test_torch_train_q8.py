"""Block-wise quantized training of the port against the JAX reference:
the quickstart loop (gemma2-2b.reduced(), quant block 64, batch 8 x 64,
AdamW at learning rate 1e-2) for five steps on one rank under the
reference's ``q8_store``, ``q8_reduce`` and ``q8_both_wires`` schedules,
in fp32 and bf16 compute; the state after the first step, leaf by leaf;
and a reference q8 state carried across.

Parity class: ALLCLOSE, bounds measured and stated per test.  Each side's
codes and scales are exact functions of its own master, and its residual
of its own cotangent; a code flips by one where the two masters straddle a
rounding boundary, and the residual -- a quantization error, at most half a
quant step -- moves by a whole step where the cotangents straddle one.
"""
import dataclasses
import multiprocessing

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

import _torch_q8_worker as QW
import _torch_train_worker as W
from repro_torch.configs import build_model
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)

STEPS, SNAP = 5, 3
VARIANTS = {
    "q8_store": dict(param_store="q8_block"),
    "q8_reduce": dict(reduce_wire="q8_block"),
    "q8_both_wires": dict(param_store="q8_block", reduce_wire="q8_block"),
}
# asserted bounds per compute dtype (measured values in the test docstring)
BOUNDS = {
    "f32": dict(loss=3e-4, norm=2e-3, codes_frac=1e-5, master=1e-5,
                scales=1e-4, ef=0.1, ef_norm=0.01, final=1e-3),
    "bf16": dict(loss=5e-3, norm=3e-2, codes_frac=5e-3, master=1e-3,
                 scales=1e-3, ef=None, ef_norm=0.05, final=1e-2),
}


def _np_state(params):
    return {n: ({k: np.array(v.detach() if isinstance(v, torch.Tensor)
                             else v) for k, v in s.items()}
                if isinstance(s, dict)
                else np.array(s.detach() if isinstance(s, torch.Tensor)
                              else s))
            for n, s in params.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _master(state):
    return state["master"] if isinstance(state, dict) else state


def _jax_run(variant, dtype, steps=STEPS):
    cfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=dtype, schedule=JaxSchedule(**VARIANTS[variant]))
    params = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = jnp.int32(0)
    losses, norms, snaps = [], [], {}
    for i in range(steps):
        if i == SNAP:
            snaps["state"] = (_np_state(params),
                              {s: {k: np.asarray(v) for k, v in
                                   state[s].items()} for s in ("m", "v")})
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        if i == 0:
            snaps["first"] = _np_state(params)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final=_np_state(params), **snaps)


@pytest.fixture(scope="module")
def ref_both_fp32():
    return _jax_run("q8_both_wires", jnp.float32)


def _check_first_step(got, want, b):
    """The state after one step, leaf by leaf."""
    for name, w in want.items():
        g = got[name]
        assert sorted(g) == sorted(w), name  # jit returns keys sorted
        for k in w:
            a, r = g[k], w[k]
            assert a.shape == r.shape and a.dtype == r.dtype, (name, k)
            if k == "codes":
                d = np.abs(a.astype(np.int64) - r)
                assert d.max() <= 1, name
                assert np.count_nonzero(d) <= b["codes_frac"] * d.size, name
            elif k == "reduce_ef":
                # quantization noise of the first cotangent on both sides
                na, nr = np.linalg.norm(a), np.linalg.norm(r)
                assert abs(na - nr) <= b["ef_norm"] * nr, name
                if b["ef"] is not None:
                    assert _rel_l2(a, r) < b["ef"], name
            else:
                assert _rel_l2(a, r) < b[k], (name, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_q8_train_matches_reference(variant, dtype, request):
    """Five steps.  Measured (fp32 / bf16, worst of the three variants):
    loss rtol 3.0e-5 / 3.8e-4, grad-norm rtol 2.6e-4 / 3.9e-3; after one
    step codes differing (by one) in 2 of 1.3M / 0.16% of elements,
    master relative L2 1.7e-6 / 2.4e-4, scales 4.3e-6 / 1.0e-4, residual
    relative L2 0.055 / 1.41 (bf16: the residual is bf16 rounding noise;
    its norm agrees); final masters relative L2 1.1e-4 / 1.1e-3."""
    b = BOUNDS[dtype]
    if variant == "q8_both_wires" and dtype == "f32":
        ref = request.getfixturevalue("ref_both_fp32")
    else:
        ref = _jax_run(variant, jnp.float32 if dtype == "f32"
                       else jnp.bfloat16)
    first = {}

    def on_step(i, params):
        if i == 0:
            first.update(_np_state(params))

    losses, norms, rt, params, _ = W.train(
        init_local_group("gloo"),
        torch.float32 if dtype == "f32" else torch.bfloat16, STEPS,
        schedule=CommSchedule(**VARIANTS[variant]), on_step=on_step)
    np.testing.assert_allclose(losses, ref["losses"], rtol=b["loss"])
    np.testing.assert_allclose(norms, ref["norms"], rtol=b["norm"])
    _check_first_step(first, ref["first"], b)
    final = _np_state(params)
    for name, want in ref["final"].items():
        assert _rel_l2(_master(final[name]), _master(want)) < b["final"], name


def test_load_reference_q8_state_round_trip(ref_both_fp32):
    """A q8_both_wires reference state after three steps (codes, master,
    scales, residual; m and v), carried into the port: the placed leaves
    equal it bitwise, and two more steps match the reference's steps four
    and five within the fp32 bounds of the five-step test."""
    params_np, opt_np = ref_both_fp32["state"]
    sched = CommSchedule(**VARIANTS["q8_both_wires"])

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for name, leaves in params_np.items():
            assert sorted(params[name]) == sorted(leaves)
            for k, want in leaves.items():
                got = params[name][k].detach().numpy()
                assert got.dtype == want.dtype and np.array_equal(got, want)
            assert params[name]["master"].requires_grad
            assert not params[name]["codes"].requires_grad
        return params, opt_state

    b = BOUNDS["f32"]
    losses, norms, rt, params, _ = W.train(
        init_local_group("gloo"), torch.float32, STEPS - SNAP,
        first_step=SNAP, state=state, schedule=sched)
    np.testing.assert_allclose(losses, ref_both_fp32["losses"][SNAP:],
                               rtol=b["loss"])
    np.testing.assert_allclose(norms, ref_both_fp32["norms"][SNAP:],
                               rtol=b["norm"])
    for name, want in ref_both_fp32["final"].items():
        assert _rel_l2(params[name]["master"].detach().numpy(),
                       want["master"]) < b["final"], name
    bad = {n: dict(s) for n, s in params_np.items()}
    bad["globals"]["scales"] = bad["globals"]["scales"][:-1]
    with pytest.raises(ValueError, match="layout needs"):
        load_reference_state(rt, bad)
    bad["globals"] = params_np["globals"]["master"]
    with pytest.raises(ValueError, match="store needs"):
        load_reference_state(rt, bad)


def test_q8_runtime_state_and_unported_options():
    """init_params builds the q8 states on the runtime's device with the
    reference's leaves; microbatches > 1 (deferred error feedback) still
    raises, naming its ROADMAP item."""
    cfg = W.quickstart_config()
    group = init_local_group("gloo")
    rt = FSDPRuntime(build_model(cfg), group, device="cpu",
                     schedule=CommSchedule(**VARIANTS["q8_both_wires"]))
    params = rt.init_params(0)
    for name, lo in rt.layouts.items():
        s = params[name]
        assert list(s) == ["codes", "master", "scales", "reduce_ef"]
        S = lo.plan.shard_size
        lead = lo.local_shape()[:-1]
        assert tuple(s["codes"].shape) == lead + (S,)
        assert s["codes"].dtype == torch.int8
        assert tuple(s["scales"].shape) == lead + (S // cfg.quant_block,)
        assert tuple(s["reduce_ef"].shape) == lead + (S,)  # one rank: m = 1
        assert not s["reduce_ef"].any()
        assert s["master"].requires_grad
    micro = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, microbatches=2, reduce_wire="q8_block"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        FSDPRuntime(build_model(micro), group, device="cpu")


def test_q8_two_ranks_track_one_rank(tmp_path):
    """q8_both_wires on two gloo ranks: each rank holds half of every
    group's columns and a residual two shards long, encodes its own
    half-batch cotangent, and the match route sums the decoded halves in
    rank order.  That quantizes other values than one rank does, so the
    runs agree within quantization noise, not bitwise.  Measured over three
    steps: loss rtol 2.6e-4, grad-norm rtol 1.3e-3.  Asserted: 2e-3 and
    1e-2."""
    world, steps = 2, 3
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=QW.train_rank_main,
                         args=(r, world, str(tmp_path / "store"), prefix,
                               steps))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * world
    losses, norms, rt, _, _ = W.train(
        init_local_group("gloo"), torch.float32, steps,
        schedule=CommSchedule(**VARIANTS["q8_both_wires"]))
    S = rt.layouts["layers"].plan.shard_size
    for r in range(world):
        out = np.load(f"{prefix}{r}.npz")
        np.testing.assert_allclose(out["losses"], losses, rtol=2e-3)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-2)
        # m = 2: the residual is the rank's whole gathered layer buffer
        assert out["ef"].shape == (rt.layouts["layers"].n_layers, S)
        assert np.abs(out["ef"]).max() > 0
