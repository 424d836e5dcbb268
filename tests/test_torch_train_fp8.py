"""Training on the bf16 and fp8 parameter stores, and over fp8 cast wires,
against the JAX reference: the quickstart loop (gemma2-2b.reduced(), batch
8 x 64, learning rate 1e-2) for five steps on one rank, in fp32 and bf16
compute, under AdamW and Adam8bit; the state after the first step; the
codes against the encode of the master after every step; reference states
carried across; the fp8 store with the q8 gradient wire; two gloo ranks
against one.

Parity class: ALLCLOSE, bounds measured and stated per test (``BOUNDS``;
measured values in the tests' docstrings).  On both sides the fp8 codes are
exactly the encode of the master (``quant.fp8`` is bitwise the
reference's), so a code moves by one step where the two masters straddle an
fp8 rounding boundary; a bf16 store's weights move by one bf16 step where
the fp32 updates straddle a bf16 one.
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

import _torch_fp8_worker as FW
import _torch_train_worker as W
from _torch_ref_step import first_step
from repro_torch.configs import build_model
from repro_torch.core.fsdp import FSDPRuntime, load_reference_state
from repro_torch.core.schedule import CommSchedule
from repro_torch.launch.mesh import init_local_group
from repro_torch.quant.fp8 import FP8_DTYPES, fp8_encode

torch.set_num_threads(2)

STEPS, SNAP = 5, 3
# name -> (schedule, optimizer)
VARIANTS = {
    "fp8_e4m3": (dict(param_store="fp8_e4m3"), "adamw"),
    "fp8_e5m2": (dict(param_store="fp8_e5m2"), "adamw"),
    "fp8_e4m3_adam8": (dict(param_store="fp8_e4m3"), "adam8bit"),
    "bf16": (dict(param_store="bf16"), "adamw"),
    "bf16_adam8": (dict(param_store="bf16"), "adam8bit"),
    "fp8_wires": (dict(gather_dtype="fp8_e4m3", reduce_wire="fp8_e5m2"),
                  "adamw"),
}
# asserted bounds per compute dtype (measured values in
# test_store_train_matches_reference): loss and grad-norm rtol; after the
# first step the share of fp8 codes (or bf16 weights) that differ, the
# largest absolute weight difference (Adam's first update is +-lr wherever
# a gradient is not tiny, so a sign that differs moves a weight by 2 lr,
# lr = 1e-4 at step 0) and the masters' relative L2; the masters' relative
# L2 after the last step
BOUNDS = {
    "f32": dict(loss=3e-4, norm=1e-3, step_frac=1e-4, abs=2.5e-4,
                master=1e-5, final=1e-3),
    "bf16": dict(loss=2e-3, norm=2e-2, step_frac=1e-2, abs=2.5e-4,
                 master=1e-3, final=5e-3),
}


def _np(x):
    """Host copy of a leaf: bf16 widened to fp32, fp8 codes as uint8."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in FP8_DTYPES.values():
            x = x.view(torch.uint8)
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
    a = np.asarray(x)
    if "float8" in a.dtype.name:
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _np_state(params):
    return {n: ({k: _np(v) for k, v in s.items()} if isinstance(s, dict)
                else _np(s)) for n, s in params.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _master(state):
    return state["master"] if isinstance(state, dict) else state


def _cfg_kw(opt):
    return dict(learning_rate=W.LR, optimizer=opt)


def _jax_run(variant, dtype, steps=STEPS):
    sched, opt = VARIANTS[variant]
    cfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                              **_cfg_kw(opt))
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=dtype, schedule=JaxSchedule(**sched))
    params = rt.init_params(0)
    optimizer = jax_make_optimizer(cfg)
    state = optimizer.init(rt)
    step_fn = rt.make_train_step(optimizer)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    step = first_step(rt)
    # host copies (the step donates its inputs): ml_dtypes arrays for the
    # reference's own bf16 and float8 leaves
    losses, norms, snaps = [], [], {"init": _np_state(params)}
    for i in range(steps):
        if i == SNAP:
            snaps["state"] = (
                {n: ({k: np.array(v) for k, v in s.items()}
                     if isinstance(s, dict) else np.array(s))
                 for n, s in params.items()},
                {k: {n: np.array(a) for n, a in v.items()}
                 for k, v in state.items()})
        batch = stream.shard(stream.batch(i), rt)
        params, state, step, m = step_fn(params, state, step, batch)
        if i == 0:
            snaps["first"] = _np_state(params)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                final=_np_state(params), **snaps)


def _port_run(variant, dtype, steps=STEPS, **kw):
    """The port's run; checks after every step that each fp8 state's codes
    are bitwise the encode of its master."""
    sched, opt = VARIANTS[variant]
    first = {}
    fmt = sched.get("param_store")

    def on_step(i, params):
        if i == 0:
            first.update(_np_state(params))
        if fmt in FP8_DTYPES:
            for s in params.values():
                assert np.array_equal(
                    _np(s["codes"]), _np(fp8_encode(s["master"], fmt)))

    out = W.train(init_local_group("gloo"), dtype, steps,
                  schedule=CommSchedule(**sched), on_step=on_step,
                  overrides=dict(optimizer=opt), **kw)
    return out, first


@pytest.fixture(scope="module")
def ref_fp8_f32():
    return _jax_run("fp8_e4m3", jnp.float32)


@pytest.fixture(scope="module")
def ref_bf16_f32():
    return _jax_run("bf16", jnp.float32)


def _ordinal(a):
    """Sign-magnitude bits as a signed count of steps from zero (+0 and -0
    both 0): fp8 codes given as uint8, bf16 values as fp32 widenings."""
    if a.dtype == np.uint8:
        mag, neg = (a & 0x7F).astype(np.int64), a >= 0x80
    else:
        bits = a.view(np.int32)
        mag, neg = (bits & 0x7FFFFFFF).astype(np.int64) >> 16, bits < 0
    return np.where(neg, -mag, mag)


def _steps_apart(a, b):
    """Per element, how many fp8 codes or bf16 values lie between ``a``
    and ``b``."""
    return np.abs(_ordinal(a) - _ordinal(b))


def _check_first_step(got, want, b, fmt):
    """The state after one step, leaf by leaf: fp8 codes and a bf16
    store's (widened) buffer differ on few elements (by one step at most in
    fp32 compute); the reference's codes are the encode of its own master,
    as the port's are (``_port_run``); weights by absolute difference, fp32
    masters by relative L2."""
    for name, w in want.items():
        g = got[name]
        if not isinstance(w, dict):
            g, w = {"master": g}, {"master": w}
        assert sorted(g) == sorted(w), name
        for k in w:
            a, r = g[k], w[k]
            assert a.shape == r.shape and a.dtype == r.dtype, (name, k)
            if k == "codes" or fmt == "bf16":
                d = _steps_apart(a, r)
                assert np.count_nonzero(d) <= b["step_frac"] * d.size, name
                if b is BOUNDS["f32"]:
                    assert d.max() <= 1, (name, k)
            if k == "codes":
                assert np.array_equal(r, _np(fp8_encode(
                    torch.from_numpy(w["master"]), fmt))), name
                continue
            assert np.abs(a.astype(np.float64) - r).max() <= b["abs"], name
            if fmt != "bf16":
                assert _rel_l2(a, r) < b["master"], (name, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_store_train_matches_reference(variant, dtype, request):
    """Five steps.  Measured (fp32 / bf16 compute, worst of the six
    variants): loss rtol 6.9e-5 / 5.5e-4, grad-norm rtol 4.1e-4 /
    5.6e-3; after one step fp8 codes differing on 0 / 0.056% of the
    elements, bf16 weights on 3 of 1.3M / 0.30%, weights at most 1.1e-4 /
    2.4e-4 apart, fp32 masters' relative L2 2.1e-6 / 2.4e-4; final
    masters' relative L2 1.3e-4 / 1.6e-3.  The port's codes equal the
    encode of its master after every step (``_port_run``)."""
    b = BOUNDS[dtype]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    if (variant, dtype) == ("fp8_e4m3", "f32"):
        ref = request.getfixturevalue("ref_fp8_f32")
    elif (variant, dtype) == ("bf16", "f32"):
        ref = request.getfixturevalue("ref_bf16_f32")
    else:
        ref = _jax_run(variant, jdt)
    (losses, norms, rt, params, _), first = _port_run(
        variant, torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_allclose(losses, ref["losses"], rtol=b["loss"])
    np.testing.assert_allclose(norms, ref["norms"], rtol=b["norm"])
    _check_first_step(first, ref["first"], b,
                      VARIANTS[variant][0].get("param_store"))
    final = _np_state(params)
    for name, want in ref["final"].items():
        assert _rel_l2(_master(final[name]), _master(want)) < b["final"], \
            name


@pytest.mark.parametrize("variant", ["fp8_e4m3", "fp8_e5m2", "bf16"])
def test_init_params_match_reference(variant):
    """``init_params`` on the bf16 and fp8 stores: the reference's leaves,
    dtypes and values bitwise (fp8 codes as uint8), on the runtime's device,
    the trainable leaf requiring grad."""
    sched, _ = VARIANTS[variant]
    ref = _jax_run(variant, jnp.float32, steps=0)["init"]
    rt = FSDPRuntime(build_model(W.quickstart_config()),
                     init_local_group("gloo"), device="cpu",
                     schedule=CommSchedule(**sched))
    params = rt.init_params(0)
    for name, want in ref.items():
        s = params[name]
        store = rt.layouts[name].store
        if isinstance(want, dict):
            assert list(s) == ["codes", "master"]
            assert s["codes"].dtype == store.fp8_dtype
            assert s["master"].requires_grad
            assert not s["codes"].requires_grad
            for k in want:
                assert np.array_equal(_np(s[k]), want[k]), (name, k)
        else:
            assert s.dtype == torch.bfloat16 and s.requires_grad
            assert np.array_equal(_np(s).view(np.int32),
                                  want.view(np.int32)), name


def test_load_reference_fp8_state_round_trip(ref_fp8_f32):
    """A reference fp8_e4m3 state after three steps (float8 codes, fp32
    master; m and v), carried into the port: the placed leaves equal it
    bitwise (codes as uint8), and two more steps match the reference's
    steps four and five within the fp32 bounds."""
    params_np, opt_np = ref_fp8_f32["state"]

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for name, leaves in params_np.items():
            for k, want in leaves.items():
                assert np.array_equal(_np(params[name][k]), _np(want))
            assert params[name]["codes"].dtype == torch.float8_e4m3fn
            assert params[name]["master"].requires_grad
        return params, opt_state

    b = BOUNDS["f32"]
    (losses, norms, rt, params, _), _ = _port_run(
        "fp8_e4m3", torch.float32, STEPS - SNAP, first_step=SNAP,
        state=state)
    np.testing.assert_allclose(losses, ref_fp8_f32["losses"][SNAP:],
                               rtol=b["loss"])
    np.testing.assert_allclose(norms, ref_fp8_f32["norms"][SNAP:],
                               rtol=b["norm"])
    # raw uint8 bytes are taken too; a float32 array for the codes is not
    raw = {n: {k: (np.asarray(v).view(np.uint8) if k == "codes"
                   else np.asarray(v)) for k, v in s.items()}
           for n, s in params_np.items()}
    placed, _ = load_reference_state(rt, raw)
    assert np.array_equal(_np(placed["globals"]["codes"]),
                          _np(params_np["globals"]["codes"]))
    raw["globals"]["codes"] = raw["globals"]["codes"].astype(np.float32)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        load_reference_state(rt, raw)


def test_load_reference_bf16_state_round_trip(ref_bf16_f32):
    """A reference bf16 state (bare bf16 buffers) after three steps: placed
    bitwise as the port's bf16 leaves, and two more steps match."""
    params_np, opt_np = ref_bf16_f32["state"]

    def state(rt):
        params, opt_state = load_reference_state(rt, params_np, opt_np)
        for name, want in params_np.items():
            got = params[name]
            assert got.dtype == torch.bfloat16 and got.requires_grad
            assert np.array_equal(_np(got).view(np.int32),
                                  _np(want).view(np.int32))
        return params, opt_state

    b = BOUNDS["f32"]
    (losses, norms, _, _, _), _ = _port_run(
        "bf16", torch.float32, STEPS - SNAP, first_step=SNAP, state=state)
    np.testing.assert_allclose(losses, ref_bf16_f32["losses"][SNAP:],
                               rtol=b["loss"])
    np.testing.assert_allclose(norms, ref_bf16_f32["norms"][SNAP:],
                               rtol=b["norm"])


def test_fp8_store_with_q8_reduce_wire_one_step():
    """``param_store="fp8_e4m3"`` with ``reduce_wire="q8_block"``: the state
    carries the residual beside codes and master, and one step matches the
    reference's (loss, grad norm, the residual's norm)."""
    sched = dict(param_store="fp8_e4m3", reduce_wire="q8_block")
    cfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                              learning_rate=W.LR)
    rt = JaxRuntime(jax_build_model(cfg), make_local_mesh(1, 1),
                    compute_dtype=jnp.float32, schedule=JaxSchedule(**sched))
    jp = rt.init_params(0)
    opt = jax_make_optimizer(cfg)
    stream = JaxStream(JaxDataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    jp, _, _, jm = rt.make_train_step(opt)(
        jp, opt.init(rt), jnp.int32(0), stream.shard(stream.batch(0), rt))
    losses, norms, prt, params, _ = W.train(
        init_local_group("gloo"), torch.float32, 1,
        schedule=CommSchedule(**sched))
    assert list(params["layers"]) == ["codes", "master", "reduce_ef"]
    np.testing.assert_allclose(losses, [float(jm["loss"])], rtol=1e-5)
    np.testing.assert_allclose(norms, [float(jm["grad_norm"])], rtol=1e-4)
    for name in params:
        a = np.linalg.norm(params[name]["reduce_ef"].numpy())
        r = np.linalg.norm(np.asarray(jp[name]["reduce_ef"]))
        assert abs(a - r) <= 0.01 * r, name
        fmt_codes = fp8_encode(params[name]["master"], "fp8_e4m3")
        assert np.array_equal(_np(params[name]["codes"]), _np(fmt_codes))


def test_fp8_two_ranks_track_one_rank(tmp_path):
    """The fp8_e4m3 store with the fp8_e5m2 gradient wire on two gloo
    ranks: each rank holds half of every group's columns, and the fp8
    route sums the two half-batch cotangents' codes (one rank's round trip
    encodes a whole-batch cotangent), so the runs agree within the wire's
    rounding, not bitwise.  Measured over three steps: loss rtol 2.4e-4,
    grad-norm rtol 2.3e-3.  Asserted: 2e-3 and 1e-2; each rank's codes
    are the encode of its master."""
    world, steps = 2, 3
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp_path / "rank")
    procs = [ctx.Process(target=FW.train_rank_main,
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
        schedule=CommSchedule(**FW.TRAIN_SCHEDULE))
    S = rt.layouts["layers"].plan.shard_size
    for r in range(world):
        out = np.load(f"{prefix}{r}.npz")
        np.testing.assert_allclose(out["losses"], losses, rtol=2e-3)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-2)
        assert out["codes"].shape == (rt.layouts["layers"].n_layers,
                                      S // world)
        assert np.array_equal(out["codes"], _np(fp8_encode(
            torch.from_numpy(out["master"]), "fp8_e4m3")))
