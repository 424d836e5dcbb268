"""Sharded checkpointing (format v2) in the port against the JAX reference,
on gemma2-2b.reduced() after two steps (fp32 compute, batch 4 x 16):

  * the reference saves and the port loads, bitwise on every parameter and
    optimizer leaf; the port's re-save is byte-identical file by file
    (``meta.json`` and ``plan.json`` equal as JSON too); the reference
    loads the port's files bitwise -- on the fp32, bf16, q8_block (with
    the q8 gradient wire's residual) and fp8_e4m3 stores with AdamW (the
    other optimizers and multi-rank saves: tests/test_torch_ckpt_optim.py);
  * three steps continued from the loaded state track the reference's
    continued stream within the AdamW parity class (tests/test_torch_train
    .py's bounds);
  * another planner, another store format (q8_block: codes requantized,
    residual zero -- bitwise the reference's cross-format load), another
    quant block, and a v1 ``state.npz``.

Parity class: BITWISE (file bytes, leaves) except the continued stream
(ALLCLOSE, stated in the test).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer

from repro_torch.checkpoint import ckpt
from repro_torch.configs import build_model, get_config
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)
SEQ, BATCH, STEPS = 16, 4, 2
MESH = make_local_mesh(1, 1)

CASES = {
    "fp32": ({}, None),
    "bf16": ({}, {"param_store": "bf16"}),
    "q8_ef": ({}, {"param_store": "q8_block", "reduce_wire": "q8_block"}),
    "fp8_e4m3": ({}, {"param_store": "fp8_e4m3"}),
    "adam8bit": ({"optimizer": "adam8bit"}, None),
    "muon": ({"optimizer": "muon"}, None),
    "shampoo": ({"optimizer": "shampoo"}, None),
}


def _configs(over):
    return (dataclasses.replace(jax_get_config("gemma2-2b").reduced(), **over),
            dataclasses.replace(get_config("gemma2-2b").reduced(), **over))


def _ref_run(over, sched, steps=STEPS, extra=0):
    """The reference after ``steps`` steps (and its state), plus the
    losses of ``extra`` more."""
    jc, _ = _configs(over)
    rt = JaxRuntime(jax_build_model(jc), MESH, compute_dtype=jnp.float32,
                    schedule=JaxSchedule(**sched) if sched else None)
    opt = jax_make_optimizer(jc)
    params, state = rt.init_params(0), opt.init(rt)
    fn = rt.make_train_step(opt)
    stream = JaxStream(JaxDataConfig(jc.vocab, SEQ, BATCH), jc)
    st, snap, losses = jnp.int32(0), None, []
    for i in range(steps + extra):
        if i == steps:
            snap = (jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state))
        params, state, st, m = fn(params, state, st,
                                  stream.shard(stream.batch(i), rt))
        losses.append(float(m["loss"]))
    if snap is None:
        snap = (jax.tree.map(np.asarray, params),
                jax.tree.map(np.asarray, state))
    return rt, opt, snap, losses


def _port_rt(over, sched, planner="ragged"):
    _, tc = _configs(over)
    rt = FSDPRuntime(build_model(tc), init_local_group("gloo"), device="cpu",
                     compute_dtype=torch.float32, planner=planner,
                     schedule=CommSchedule(**sched) if sched else None)
    return rt, make_optimizer(tc)


def _bits(a):
    """A host array or tensor as raw bytes (ml_dtypes and float8 too)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.contiguous().view(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def _same_tree(port, ref):
    """Every leaf of a port state (dicts of tensors) bitwise the
    reference's (dicts of arrays)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same_tree(port[k], ref[k])
    else:
        assert _bits(port).tobytes() == _bits(ref).tobytes()


def _same_files(a: Path, b: Path):
    fa = sorted(p.name for p in (a / "shards").iterdir())
    assert fa == sorted(p.name for p in (b / "shards").iterdir())
    for f in fa:
        assert (a / "shards" / f).read_bytes() == \
            (b / "shards" / f).read_bytes(), f
    for f in ("meta.json", "plan.json"):
        assert json.loads((a / f).read_text()) == \
            json.loads((b / f).read_text()), f


@pytest.fixture(scope="module")
def ref_fp32():
    """The reference's fp32-store AdamW run: its state after STEPS steps
    and the losses of three more."""
    return _ref_run({}, None, extra=3)


def _round_trip(case, tmp_path, ref=None):
    """Reference save -> port load (bitwise) -> port save (byte-identical
    files) -> reference load (bitwise); returns the port's runtime,
    optimizer and loaded state."""
    over, sched = CASES[case]
    jrt, jopt, (jp, js), _ = ref or _ref_run(over, sched)
    jax_ckpt.save(tmp_path / "ref", jrt, jp, js, step=STEPS)
    rt, opt = _port_rt(over, sched)
    params, step, state = ckpt.load(tmp_path / "ref", rt, opt.init(rt))
    assert step == STEPS
    _same_tree(params, jp)
    _same_tree(state, js)
    assert all(rt.layouts[n].store.trainable(p).requires_grad
               for n, p in params.items())
    ckpt.save(tmp_path / "port", rt, params, state, step=step)
    _same_files(tmp_path / "ref", tmp_path / "port")
    assert (tmp_path / "port" / "plan.json").read_text() == \
        (tmp_path / "ref" / "plan.json").read_text()
    back_p, back_step, back_s = jax_ckpt.load(tmp_path / "port", jrt,
                                              jopt.init(jrt))
    assert back_step == STEPS
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back_p)):
        assert _bits(a).tobytes() == _bits(b).tobytes()
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back_s)):
        assert _bits(a).tobytes() == _bits(b).tobytes()
    assert ckpt.load_plan(tmp_path / "port").dumps() == rt.plan.dumps()
    return rt, opt, params, state


@pytest.mark.parametrize("case", ["bf16", "q8_ef", "fp8_e4m3"])
def test_reference_checkpoint_round_trip(case, tmp_path):
    """The bf16, q8_block (with the residual) and fp8_e4m3 stores under
    AdamW (the optimizers: tests/test_torch_ckpt_optim.py)."""
    _round_trip(case, tmp_path)


def test_fp32_round_trip_and_continued_stream(ref_fp32, tmp_path):
    """The fp32 store's round trip; then three steps from the loaded
    reference state track the reference's own steps three to five.
    Measured: losses within rtol 1.3e-7.  Asserted: 1e-4, the five-step
    bound of tests/test_torch_train.py."""
    rt, opt, params, state = _round_trip("fp32", tmp_path, ref_fp32)
    cfg = rt.cfg
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH), cfg)
    losses = []
    for i in range(STEPS, STEPS + 3):
        params, state, _, m = fn(params, state, i,
                                 stream.shard(stream.batch(i), rt))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_fp32[3][STEPS:], rtol=1e-4)


def _per_tensor(rt, params):
    """{(tensor, layer): host array} of a runtime's (rank-0, one-rank)
    masters, unpacked through its layouts."""
    out = {}
    for name, lo in rt.layouts.items():
        p = params[name]
        a = (p["master"] if isinstance(p, dict) else p).detach().float()
        a = a.numpy()
        for li in (range(lo.n_layers) if lo.n_layers else [None]):
            for k, v in lo.buffer.unpack_np(
                    a[li] if li is not None else a).items():
                out[k, li] = v
    return out


def _same_tensors(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


def test_cross_planner_and_cross_format(tmp_path):
    """A ragged fp32 checkpoint loads under the fsdp2 and naive planners
    (bitwise on master, moments following their tensors), and into a
    ``q8_both_wires`` runtime: the master exact, codes and scales those of
    ``ops.quantize`` of it, the residual zero -- every leaf bitwise the
    reference's cross-format load of the same files; then a quant block
    change (1024 -> 64) requantizes."""
    rt, opt = _port_rt({}, None)
    params, state = rt.init_params(3), opt.init(rt)
    fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(rt.cfg.vocab, SEQ, BATCH), rt.cfg)
    for i in range(STEPS):
        params, state, _, _ = fn(params, state, i,
                                 stream.shard(stream.batch(i), rt))
    ckpt.save(tmp_path / "c", rt, params, state, step=STEPS)
    want = _per_tensor(rt, params)
    want_m = _per_tensor(rt, state["m"])
    for planner in ("fsdp2", "naive"):
        rt2, opt2 = _port_rt({}, None, planner)
        p2, _, s2 = ckpt.load(tmp_path / "c", rt2, opt2.init(rt2))
        _same_tensors(_per_tensor(rt2, p2), want)
        _same_tensors(_per_tensor(rt2, s2["m"]), want_m)

    q8 = {"param_store": "q8_block", "reduce_wire": "q8_block"}
    rtq, _ = _port_rt({}, q8)
    pq, _ = ckpt.load(tmp_path / "c", rtq)
    _same_tensors(_per_tensor(rtq, pq), want)
    jrt = JaxRuntime(jax_build_model(_configs({})[0]), MESH,
                     compute_dtype=jnp.float32, schedule=JaxSchedule(**q8))
    jpq, _ = jax_ckpt.load(tmp_path / "c", jrt)
    _same_tree(pq, jpq)
    for name, lo in rtq.layouts.items():
        codes, scales = ops.quantize(pq[name]["master"].detach(),
                                     lo.store.block)
        assert torch.equal(codes, pq[name]["codes"])
        assert torch.equal(scales, pq[name]["scales"])
        assert not pq[name]["reduce_ef"].count_nonzero()

    rtb, _ = _port_rt({"quant_block": 64}, {"param_store": "q8_block"})
    ckpt.save(tmp_path / "q", rtq, pq, step=STEPS)
    pb, _ = ckpt.load(tmp_path / "q", rtb)
    _same_tensors(_per_tensor(rtb, pb), want)
    for name, lo in rtb.layouts.items():
        codes, scales = ops.quantize(pb[name]["master"].detach(), 64)
        assert torch.equal(scales, pb[name]["scales"])
        assert pb[name]["scales"].shape[-1] * 64 == lo.plan.shard_size


def _write_v1(path: Path, jrt, params, state, step):
    """A format v1 checkpoint (one state.npz and a meta.json without a
    version), as the reference's legacy tests write one."""
    from repro.compat import tree_flatten_with_path
    from repro.core.ragged import checkpoint_index

    path.mkdir(parents=True)
    arrays, groups = {}, {}
    for name, lo in jrt.layouts.items():
        groups[name] = {"index": checkpoint_index(lo.plan),
                        "shard_size": lo.plan.shard_size,
                        "num_shards": lo.plan.num_shards,
                        "outer_size": lo.outer_size, "mode": lo.plan.mode}
        arrays[f"param__{name}"] = np.asarray(params[name])
    flat, _ = tree_flatten_with_path(state)
    for kp, v in flat:
        key = "opt__" + "__".join(getattr(p, "key", str(p)) for p in kp)
        arrays[key] = np.asarray(v)
    np.savez(path / "state.npz", **arrays)
    (path / "meta.json").write_text(json.dumps({"step": step,
                                                "groups": groups}))


def test_legacy_v1_restore(ref_fp32, tmp_path):
    """A v1 ``state.npz`` of the reference's state restores bitwise with
    its moments; under another planner the params restore through the
    repack and the moments refuse, as in the reference."""
    jrt, _, (jp, js), _ = ref_fp32
    _write_v1(tmp_path / "v1", jrt, jp, js, STEPS)
    assert ckpt.load_plan(tmp_path / "v1") is None
    rt, opt = _port_rt({}, None)
    params, step, state = ckpt.load(tmp_path / "v1", rt, opt.init(rt))
    assert step == STEPS
    _same_tree(params, jp)
    _same_tree(state, js)
    rtn, optn = _port_rt({}, None, "naive")
    with pytest.raises(ValueError, match="same-plan only"):
        ckpt.load(tmp_path / "v1", rtn, optn.init(rtn))
    pn, _ = ckpt.load(tmp_path / "v1", rtn)
    _same_tensors(_per_tensor(rtn, pn), _per_tensor(rt, params))
