"""Host metadata of the port against the JAX reference: planned layouts,
DBuffer packing, the data stream and the parameter init.

Parity class: BITWISE for all of it -- integer planning and numpy work.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.dbuffer import DBuffer as JaxDBuffer
from repro.core.policy import plan as jax_plan
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticStream as JaxStream

from repro_torch.configs import build_model, get_config
from repro_torch.core.dbuffer import DBuffer
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.core.planner import get_planner
from repro_torch.core.policy import plan
from repro_torch.core.schedule import CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)


def _cfgs(reduced: bool):
    jcfg, tcfg = jax_get_config("gemma2-2b"), get_config("gemma2-2b")
    return (jcfg.reduced(), tcfg.reduced()) if reduced else (jcfg, tcfg)


def _placements(gplan):
    return [(p.spec.name, p.spec.shape, p.spec.granularity, p.offset)
            for p in gplan.placements]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("m", [1, 2, 8])
def test_plan_matches_reference(reduced, m):
    jcfg, tcfg = _cfgs(reduced)
    mesh = {"data": m, "model": 1}
    ref = jax_plan(jax_build_model(jcfg), mesh)
    got = plan(build_model(tcfg), mesh)
    assert list(got.groups) == list(ref.groups)
    for name, e in ref.groups.items():
        g = got.groups[name]
        assert _placements(g.plan) == _placements(e.plan), name
        assert g.plan.shard_size == e.plan.shard_size, name
        assert g.plan.total == e.plan.total, name
        assert g.plan.padding == e.plan.padding, name
        assert g.fsdp_axes == e.fsdp_axes and g.n_layers == e.n_layers


Q8_SCHEDULES = {
    "q8_store": dict(param_store="q8_block"),
    "q8_reduce": dict(reduce_wire="q8_block"),
    "q8_both_wires": dict(param_store="q8_block", reduce_wire="q8_block"),
}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("variant", list(Q8_SCHEDULES))
def test_q8_plan_matches_reference(variant, reduced, m):
    """The q8 store and the q8 reduce wire align every tensor start and
    the shard size to the quant block; the plans equal the reference's."""
    from repro.core.schedule import CommSchedule as JaxSchedule

    jcfg, tcfg = _cfgs(reduced)
    mesh = {"data": m, "model": 1}
    ref = jax_plan(jax_build_model(jcfg), mesh,
                   JaxSchedule(**Q8_SCHEDULES[variant]))
    got = plan(build_model(tcfg), mesh, CommSchedule(**Q8_SCHEDULES[variant]))
    assert list(got.groups) == list(ref.groups)
    for name, e in ref.groups.items():
        g = got.groups[name]
        assert _placements(g.plan) == _placements(e.plan), name
        assert (g.plan.shard_size, g.plan.total, g.plan.padding) == \
            (e.plan.shard_size, e.plan.total, e.plan.padding), name
        assert g.plan.shard_size % tcfg.quant_block == 0
        assert g.store.state_keys() == e.store.state_keys()
        assert (g.store.fmt, g.store.block, g.store.ef_m) == \
            (e.store.fmt, e.store.block, e.store.ef_m)


def test_full_width_q8_shard_sizes():
    """The sizes the chip smoke's q8 phases rely on (one rank,
    align = quant_block = 1024)."""
    got = plan(build_model(get_config("gemma2-2b")), {"data": 1, "model": 1},
               CommSchedule(param_store="q8_block", reduce_wire="q8_block"))
    # aligned tensor starts pad the layer buffer by 3072 elements and the
    # globals by 768
    assert got.groups["layers"].plan.shard_size == 77_869_056
    assert got.groups["globals"].plan.shard_size == 589_827_072
    assert all(e.plan.shard_size % 1024 == 0 for e in got.groups.values())


def test_full_width_shard_sizes():
    """The sizes the chip smoke relies on (one rank: no padding)."""
    got = plan(build_model(get_config("gemma2-2b")), {"data": 1, "model": 1})
    assert got.groups["layers"].plan.shard_size == 77_865_984
    assert got.groups["globals"].plan.shard_size == 589_826_304
    assert all(e.plan.padding == 0 for e in got.groups.values())
    got8 = plan(build_model(get_config("gemma2-2b")), {"data": 8, "model": 1})
    assert got8.groups["layers"].plan.shard_size == 9_733_248
    assert got8.groups["globals"].plan.shard_size == 73_728_384


@pytest.mark.parametrize("m", [1, 2])
def test_dbuffer_pack_bitwise(m):
    jcfg, tcfg = _cfgs(True)
    mesh = {"data": m, "model": 1}
    ref = jax_plan(jax_build_model(jcfg), mesh)
    got = plan(build_model(tcfg), mesh)
    rng = np.random.default_rng(0)
    for name, e in ref.groups.items():
        arrays = {p.spec.name: rng.standard_normal(p.spec.shape)
                  .astype(np.float32) for p in e.plan.placements}
        want = JaxDBuffer(e.plan).pack(arrays)
        have = DBuffer(got.groups[name].plan).pack(arrays)
        assert have.dtype == want.dtype and have.shape == want.shape
        assert np.array_equal(have.view(np.int32), want.view(np.int32))
        back = DBuffer(got.groups[name].plan).unpack_np(have)
        for k, a in arrays.items():
            assert np.array_equal(back[k], a)


def test_dbuffer_unpack_returns_aliases():
    tcfg = get_config("gemma2-2b").reduced()
    gplan = plan(build_model(tcfg), {"data": 1, "model": 1}) \
        .groups["layers"].plan
    flat = torch.arange(gplan.total, dtype=torch.float32)
    views = DBuffer(gplan).unpack(flat)
    item = flat.element_size()
    for p in gplan.placements:
        t = views[p.spec.name]
        assert tuple(t.shape) == p.spec.shape
        assert t.untyped_storage().data_ptr() == flat.untyped_storage() \
            .data_ptr()
        assert t.data_ptr() == flat.data_ptr() + p.offset * item
    # a write through the buffer shows in the view: a real alias
    name = gplan.placements[1].spec.name
    flat[gplan.placements[1].offset] = -7.0
    assert views[name].reshape(-1)[0].item() == -7.0


@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_stream_bitwise(step):
    tcfg = get_config("gemma2-2b").reduced()
    ref = JaxStream(JaxDataConfig(tcfg.vocab, 64, 8), None).batch(step)
    got = SyntheticStream(DataConfig(tcfg.vocab, 64, 8), None).batch(step)
    assert got["tokens"].dtype == np.int32
    assert np.array_equal(np.asarray(ref["tokens"]), got["tokens"])


@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_bitwise(seed):
    import jax.numpy as jnp
    from repro.core.fsdp import FSDPRuntime as JaxRuntime
    from repro.launch.mesh import make_local_mesh

    jcfg, tcfg = _cfgs(True)
    jrt = JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                     compute_dtype=jnp.float32)
    want = jrt.init_params(seed)
    rt = FSDPRuntime(build_model(tcfg), init_local_group("gloo"),
                     device="cpu")
    got = rt.init_params(seed)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), name


@pytest.mark.parametrize("n", [1, 2, 4])
def test_default_layer_plan_matches_reference(n):
    from repro.core.schedule import CommSchedule as JaxSchedule

    assert dataclasses.asdict(CommSchedule().plan_layers(n)) == \
        dataclasses.asdict(JaxSchedule().plan_layers(n))


@pytest.mark.parametrize("knob,item", [
    (dict(prefetch=True), "Queue 1 item 10"),
    (dict(keep_last_gathered=True), "Queue 1 item 10"),
    (dict(gather_mode="ring"), "Queue 1 item 10"),
    (dict(reduce_mode="ring_acc"), "Queue 1 item 10"),
    (dict(ring_chunk_elems=1024), "Queue 1 item 10"),
    (dict(reduce_mode="ring_acc", reduce_wire="q8_block"), "Queue 1 item 10"),
    (dict(reshard_after_forward=False), "Queue 1 item 10"),
    (dict(sharded=False), "Queue 1 item 10"),
], ids=lambda x: str(x))
def test_unported_schedule_knobs_raise(knob, item):
    """The knobs ``item`` ported: each now constructs as the reference's
    does (its ``describe()``), or raises the reference's ``ValueError``
    (``ring_chunk_elems`` without a ring route)."""
    from repro.core.schedule import CommSchedule as JaxSchedule

    del item
    try:
        want = JaxSchedule(**knob)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            CommSchedule(**knob)
        assert str(got.value) == str(e)
        return
    assert CommSchedule(**knob).describe() == want.describe()


def test_unported_planners_and_configs_raise():
    from repro.core.planner import get_planner as jax_get_planner

    for mode in ("fsdp2", "megatron", "naive"):
        assert get_planner(mode).__name__ == jax_get_planner(mode).__name__
    # the cross-attention families are ported: seamless-m4t-medium
    # builds, and its plan at the production mesh is the reference's
    from repro.configs import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config
    from repro.core.policy import make_plan as jax_make_plan
    prod = {"data": 16, "model": 16}
    assert plan(build_model(get_config("seamless-m4t-medium")), prod) \
        .dumps() == jax_make_plan(jax_build_model(jax_get_config(
            "seamless-m4t-medium")), prod, None).dumps()
    moe = get_config("qwen3-moe-235b-a22b")  # the config's own ep=16
    # expert parallelism is ported: the model builds with its experts split
    # over the model axis, and a runtime without that axis refuses it
    # rather than run at ep=1
    model = build_model(moe)
    assert set(model.groups()["layers_experts"].outer) == {
        "moe_w1", "moe_w3", "moe_w2"}
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.launch.mesh import init_local_group
    with pytest.raises(ValueError, match="ep=16 runs over the mesh's model"):
        FSDPRuntime(model, init_local_group("gloo"), device="cpu")
    # policies="auto" is ported: the builtin roofline prices it
    auto = plan(build_model(get_config("gemma2-2b").reduced()),
                {"data": 1, "model": 1}, policies="auto")
    assert auto.profile_name == "builtin-roofline" and auto.pricing
