"""The plan and its artifact in the port against the JAX reference: the four
planners (ragged, fsdp2, megatron, naive), ``straddled_blocks`` and
``plan_exact``; the fsdp2 DBuffer layout; ``ShardingPlan`` JSON, ``diff``,
``describe`` and ``layout_changed_groups``; the ``tag=``/``where=`` policy
selectors and their errors.

Parity class: BITWISE throughout -- integer planning, numpy packing, data
movement and strings.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core import planner as jax_planner
from repro.core import policy as jax_policy
from repro.core.dbuffer import DBuffer as JaxDBuffer
from repro.core.ragged import TensorSpec as JaxSpec
from repro.core.schedule import CommSchedule as JaxSchedule

from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core import planner, policy
from repro_torch.core.dbuffer import DBuffer
from repro_torch.core.ragged import TensorSpec, checkpoint_index
from repro_torch.core.schedule import CommSchedule

torch.set_num_threads(2)

PLANNERS = ("ragged", "fsdp2", "megatron", "naive")
DUMPS_ARCHS = ("gemma2-2b", "qwen3-moe-235b-a22b", "qwen2.5-14b")


def _tp1(cfg):
    """The config at tp = ep = 1 (the port builds no outer sharding yet;
    the reference's plan of the same config is the comparison)."""
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, tp=1, ep=1, sequence_parallel=False))


_MODELS = {}


def _models(arch, reduced=False):
    key = (arch, reduced)
    if key not in _MODELS:
        jc, tc = _tp1(jax_get_config(arch)), _tp1(get_config(arch))
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        _MODELS[key] = (jax_build_model(jc), build_model(tc))
    return _MODELS[key]


def _placements(gplan):
    return [(p.spec.name, tuple(p.spec.shape), p.spec.granularity, p.offset)
            for p in gplan.placements]


def _same_plan(got, want):
    assert _placements(got) == _placements(want)
    assert (got.shard_size, got.num_shards, got.mode, got.padding) == \
        (want.shard_size, want.num_shards, want.mode, want.padding)


def _jax_specs(specs):
    return [JaxSpec(s.name, tuple(s.shape), s.dtype, s.granularity)
            for s in specs]


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planners_match_reference_at_published_width(arch, m):
    """Every registered config at published width: each group's local
    specs through the four planners (the ragged one at the runtime's
    g_coll and the 8-bit optimizers' align) give the reference's
    placements, shard size, padding and straddled-block count."""
    jm, tm = _models(arch)
    mesh = {"data": m, "model": 1}
    ref = jax_policy.plan(jm, mesh)
    got = policy.plan(tm, mesh)
    for name, e in ref.groups.items():
        specs = got.groups[name].local_specs
        assert _placements(got.groups[name].plan) == _placements(e.plan)
        for mode in PLANNERS[1:]:
            g = planner.get_planner(mode)(specs, m)
            w = jax_planner.get_planner(mode)(_jax_specs(specs), m)
            _same_plan(g, w)
            assert planner.straddled_blocks(g) == \
                jax_planner.straddled_blocks(w)
        assert planner.straddled_blocks(got.groups[name].plan) == 0


def _random_instances(seed, count):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(1, 4))
        specs = []
        for i in range(n):
            rows = int(rng.integers(1, 5))
            cols = int(rng.choice([1, 2, 3, 4]))
            g = int(rng.choice([1, cols, 2 * cols]))
            if (rows * cols) % g:
                g = cols
            specs.append(TensorSpec(f"t{i}", (rows, cols), granularity=g))
        yield specs, int(rng.integers(1, 4))


def test_plan_exact_and_heuristic_match_reference():
    """Tiny random instances (a fixed-seed sweep): the brute-force
    ``plan_exact`` and Algorithm 1 give the reference's plans, and the
    heuristic's shard size is never below the exact optimum."""
    for specs, m in _random_instances(11, 40):
        js = _jax_specs(specs)
        ex = planner.plan_exact(specs, m, g_coll=1)
        _same_plan(ex, jax_planner.plan_exact(js, m, g_coll=1))
        h = planner.plan_group(specs, m, g_coll=1)
        _same_plan(h, jax_planner.plan_group(js, m, g_coll=1))
        assert h.shard_size >= ex.shard_size
    with pytest.raises(ValueError, match="no feasible"):
        planner.plan_exact([TensorSpec("a", (4, 4), granularity=16)], 2,
                           max_S=8)


def test_get_planner_and_checkpoint_index():
    assert set(planner.PLANNERS) == set(jax_planner.PLANNERS)
    with pytest.raises(ValueError) as got:
        planner.get_planner("zero3")
    with pytest.raises(ValueError) as want:
        jax_planner.get_planner("zero3")
    assert str(got.value) == str(want.value)
    _, tm = _models("gemma2-2b", reduced=True)
    specs = list(tm.groups()["layers"].specs)
    for mode in PLANNERS:
        p = planner.get_planner(mode)(specs, 4)
        back = planner.plan_from_checkpoint_index(
            checkpoint_index(p), p.shard_size, p.num_shards, mode=p.mode)
        _same_plan(back, p)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("mode", PLANNERS)
def test_dbuffer_layouts_round_trip_like_reference(mode, m):
    """``pack``, ``unpack_np`` and the torch ``unpack`` of every planner's
    layout (the fsdp2 one interleaved rank-major) equal the reference's
    ``DBuffer`` bitwise; an fsdp2 unpack is a strided copy at m = 4 and a
    view at m = 1."""
    _, tm = _models("gemma2-2b", reduced=True)
    specs = list(tm.groups()["layers"].specs)
    p = planner.get_planner(mode)(specs, m)
    jp = jax_planner.get_planner(mode)(_jax_specs(specs), m)
    rng = np.random.default_rng(m)
    arrays = {s.name: rng.standard_normal(s.shape).astype(np.float32)
              for s in specs}
    buf, jbuf = DBuffer(p), JaxDBuffer(jp)
    packed = buf.pack(arrays)
    assert np.array_equal(packed, jbuf.pack(arrays))
    back = buf.unpack_np(packed)
    jback = jbuf.unpack_np(packed)
    flat = torch.from_numpy(packed)
    views = buf.unpack(flat)
    jviews = jbuf.unpack(jnp.asarray(packed))
    for s in specs:
        assert np.array_equal(back[s.name], arrays[s.name])
        assert np.array_equal(back[s.name], jback[s.name])
        assert np.array_equal(views[s.name].numpy(),
                              np.asarray(jviews[s.name]))
        aliases = views[s.name].data_ptr() >= flat.data_ptr() and \
            views[s.name].data_ptr() < flat.data_ptr() + flat.nbytes
        assert aliases == (mode != "fsdp2" or m == 1), s.name


def _policy_sets(par):
    """(label, port policies, reference policies) of the sets the dumps
    are compared under."""
    small = 50_000_000

    def small_group(info):
        return info.payload < small

    out = [("default", None, None),
           ("q8_block", CommSchedule(param_store="q8_block"),
            JaxSchedule(param_store="q8_block")),
           ("globals_unsharded",
            policy.PolicySet.from_parallel_config(
                par, group_schedules={"globals": {"sharded": False}}),
            jax_policy.PolicySet.from_parallel_config(
                par, group_schedules={"globals": {"sharded": False}})),
           ("tag_where",
            policy.PolicySet(rules=(
                policy.PolicyRule(tag="layers", policy=policy.ShardingPolicy(
                    gather_mode="ring", reduce_dtype="fp32")),
                policy.PolicyRule(where=small_group,
                                  policy=policy.ShardingPolicy(
                                      sharded=False)))),
            jax_policy.PolicySet(rules=(
                jax_policy.PolicyRule(tag="layers",
                                      policy=jax_policy.ShardingPolicy(
                                          gather_mode="ring",
                                          reduce_dtype="fp32")),
                jax_policy.PolicyRule(where=small_group,
                                      policy=jax_policy.ShardingPolicy(
                                          sharded=False)))))]
    return out


def _raises_alike(got_fn, want_fn):
    with pytest.raises(Exception) as want:
        want_fn()
    with pytest.raises(type(want.value)) as got:
        got_fn()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", PLANNERS)
@pytest.mark.parametrize("arch", DUMPS_ARCHS)
def test_plan_dumps_equal_reference(arch, mode):
    """``ShardingPlan.dumps()`` is string-equal to the reference's at
    published width (8 ranks, bf16 compute) for each planner under the
    default fp32 policy, a q8_block store, ``{"globals": {"sharded":
    False}}`` and a ``tag="layers"`` rule beside a ``where=`` rule; where
    the reference refuses (a q8 store off the ragged planner's align) the
    port raises the same error.  ``from_json(to_json())`` round trips and
    ``describe()`` is the reference's table."""
    jm, tm = _models(arch)
    mesh = {"data": 8, "model": 1}
    checked = 0
    for label, tpol, jpol in _policy_sets(tm.cfg.parallel):
        def got():
            return policy.plan(tm, mesh, tpol, planner=mode)

        def want():
            return jax_policy.plan(jm, mesh, jpol, planner=mode)

        try:
            ref = want()
        except ValueError:
            _raises_alike(got, want)
            continue
        p = got()
        assert p.dumps() == ref.dumps(), label
        assert p.describe() == ref.describe(), label
        back = policy.ShardingPlan.from_json(p.to_json())
        assert back.dumps() == p.dumps()
        assert back.diff(p) == []
        assert p.gather_wire_bytes() == ref.gather_wire_bytes()
        assert p.reduce_wire_bytes() == ref.reduce_wire_bytes()
        checked += 1
    assert checked >= 3 if mode == "ragged" else checked >= 2


def test_diff_and_layout_changed_groups_match_reference():
    """``diff`` lines and ``layout_changed_groups`` between pairs of plans
    (store format, planner, replication, a q8 reduce wire, the mesh)
    equal the reference's."""
    jm, tm = _models("gemma2-2b")
    cases = [
        (dict(), dict(policies=CommSchedule(param_store="q8_block")),
         dict(), dict(policies=JaxSchedule(param_store="q8_block"))),
        (dict(), dict(planner="fsdp2"), dict(), dict(planner="fsdp2")),
        (dict(), dict(policies=CommSchedule(reduce_wire="q8_block")),
         dict(), dict(policies=JaxSchedule(reduce_wire="q8_block"))),
        (dict(), dict(policies=CommSchedule(gather_mode="ring",
                                            prefetch=True)),
         dict(), dict(policies=JaxSchedule(gather_mode="ring",
                                           prefetch=True))),
    ]
    for ta, tb, ja, jb in cases:
        pa, pb = (policy.plan(tm, {"data": 8, "model": 1}, **kw)
                  for kw in (ta, tb))
        ra, rb = (jax_policy.plan(jm, {"data": 8, "model": 1}, **kw)
                  for kw in (ja, jb))
        assert pa.diff(pb) == ra.diff(rb)
        assert policy.layout_changed_groups(pa, pb) == \
            jax_policy.layout_changed_groups(ra, rb)
    p4 = policy.plan(tm, {"data": 4, "model": 1})
    r4 = jax_policy.plan(jm, {"data": 4, "model": 1})
    p8 = policy.plan(tm, {"data": 8, "model": 1})
    r8 = jax_policy.plan(jm, {"data": 8, "model": 1})
    assert p4.diff(p8) == r4.diff(r8) and p4.diff(p8)
    assert policy.layout_changed_groups(p4, p8) == {"layers", "globals"}


def test_policy_rule_selectors_and_errors_match_reference(monkeypatch):
    """``tag=``/``where=`` selection (first match wins, the rule's index
    reported), and the reference's errors: a rule without a selector, an
    unknown tag, a rule that matches no group, a scan-structure knob in a
    rule; ``policies="auto"`` resolves as the reference's (at its
    constants; tests/test_torch_profile.py covers every config)."""
    jm, tm = _models("qwen3-moe-235b-a22b", reduced=True)
    mesh = {"data": 2, "model": 1}
    q8 = policy.ShardingPolicy(store="q8_block")
    jq8 = jax_policy.ShardingPolicy(store="q8_block")
    pset = policy.PolicySet(rules=(
        policy.PolicyRule(tag="experts", policy=q8),
        policy.PolicyRule(match="layers*", policy=policy.ShardingPolicy(
            reduce_dtype="fp32"))))
    jset = jax_policy.PolicySet(rules=(
        jax_policy.PolicyRule(tag="experts", policy=jq8),
        jax_policy.PolicyRule(match="layers*",
                              policy=jax_policy.ShardingPolicy(
                                  reduce_dtype="fp32"))))
    p, r = policy.plan(tm, mesh, pset), jax_policy.plan(jm, mesh, jset)
    assert p.dumps() == r.dumps()
    assert p.groups["layers_experts"].policy == q8
    for name, gdef in tm.groups().items():
        info = policy.GroupInfo(name, policy.group_tag(name, gdef),
                                gdef.n_layers, gdef.specs)
        _, idx = pset.policy_for(info)
        assert idx == {"layers_experts": 0, "layers": 1,
                       "globals": None}[name]
    _raises_alike(lambda: policy.PolicyRule(policy=q8),
                  lambda: jax_policy.PolicyRule(policy=jq8))
    _raises_alike(lambda: policy.PolicyRule(tag="expert", policy=q8),
                  lambda: jax_policy.PolicyRule(tag="expert", policy=jq8))
    _raises_alike(
        lambda: policy.plan(tm, mesh, policy.PolicySet(rules=(
            policy.PolicyRule(match="lyers", policy=q8),))),
        lambda: jax_policy.plan(jm, mesh, jax_policy.PolicySet(rules=(
            jax_policy.PolicyRule(match="lyers", policy=jq8),))))
    _raises_alike(
        lambda: policy.PolicySet(rules=(policy.PolicyRule(
            tag="layers", policy=policy.ShardingPolicy(prefetch=True)),)),
        lambda: jax_policy.PolicySet(rules=(jax_policy.PolicyRule(
            tag="layers", policy=jax_policy.ShardingPolicy(prefetch=True)),
        )))
    _raises_alike(
        lambda: policy.plan(tm, mesh, policy.PolicySet(rules=(
            policy.PolicyRule(tag="globals", policy=policy.ShardingPolicy(
                sharded=False, reduce_wire="q8_block")),))),
        lambda: jax_policy.plan(jm, mesh, jax_policy.PolicySet(rules=(
            jax_policy.PolicyRule(tag="globals",
                                  policy=jax_policy.ShardingPolicy(
                                      sharded=False,
                                      reduce_wire="q8_block")),))))
    import repro.launch.mesh as jax_mesh
    import repro_torch.launch.mesh as mesh_mod

    for k in ("ICI_BW", "HBM_BW", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(mesh_mod, k, getattr(jax_mesh, k))
    assert policy.plan(tm, mesh, "auto").dumps() == \
        jax_policy.plan(jm, mesh, "auto").dumps()
