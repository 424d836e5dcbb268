"""The port's communication schedules on one rank: every ``VARIANTS``
entry, the ring twin of every xla variant, ``overlap_all`` at small
depths, per-group overrides (an unsharded ``globals``) and the fsdp2
layout train gemma2-2b.reduced() (fp32 compute, five quickstart steps)
exactly like the default -- the claims the reference makes for itself in
its ``tests/test_schedule.py``; the accounting (``gathered_peak_bytes``
and both wire-byte counts) against the reference's runtime; the measured
gathered-buffer peak against that bound; the knobs' construction rules.

Parity class: BITWISE within the port (loss and grad-norm streams and the
final masters); the accounting BITWISE against the reference; the fsdp2
layout against the ragged one ALLCLOSE (its grad norm sums another
layout).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core.fsdp import FSDPRuntime as JaxRuntime
from repro.core.schedule import APPROX_VARIANTS as JAX_APPROX
from repro.core.schedule import VARIANTS as JAX_VARIANTS
from repro.core.schedule import CommSchedule as JaxSchedule
from repro.launch.mesh import make_local_mesh

import _torch_train_worker as W
from repro_torch.configs import build_model
from repro_torch.core import schedule
from repro_torch.core.fsdp import FSDPRuntime, GatheredMeter
from repro_torch.core.schedule import APPROX_VARIANTS, VARIANTS, CommSchedule
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.mesh import init_local_group
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

STEPS = 5


def train(sched=None, *, planner="ragged", group_schedules=None,
          n_layers=None, dtype=torch.float32, meter=False, steps=STEPS):
    """The quickstart loop on one gloo rank: (metric stream, final
    masters, runtime)."""
    cfg = W.quickstart_config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rt = FSDPRuntime(build_model(cfg), init_local_group("gloo"),
                     compute_dtype=dtype, device="cpu", schedule=sched,
                     planner=planner, group_schedules=group_schedules)
    if meter:
        rt.gathered_meter = GatheredMeter()
    opt = make_optimizer(cfg)
    state = opt.init(rt)
    params = rt.init_params(0)
    step_fn = rt.make_train_step(opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, W.SEQ, W.BATCH), cfg)
    out, step = [], 0
    for i in range(steps):
        params, state, step, m = step_fn(params, state, step,
                                         stream.shard(stream.batch(i), rt))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    finals = {k: (v["master"] if isinstance(v, dict) else v)
              .detach().numpy().copy() for k, v in params.items()}
    return out, finals, rt


def assert_same(ref, got, msg):
    (rm, rp, _), (gm, gp, _) = ref, got
    assert np.asarray(rm, np.float32).tobytes() == \
        np.asarray(gm, np.float32).tobytes(), (msg, rm, gm)
    for k in rp:
        assert np.array_equal(rp[k].view(np.int32), gp[k].view(np.int32)), \
            f"{msg}: {k}"


@pytest.fixture(scope="module")
def default():
    return train(CommSchedule())


def test_variants_are_the_references():
    """The port iterates the reference's own lists."""
    for mine, ref in ((VARIANTS, JAX_VARIANTS), (APPROX_VARIANTS,
                                                 JAX_APPROX)):
        assert list(mine) == list(ref)
        for name in ref:
            assert dataclasses.asdict(mine[name]) == \
                dataclasses.asdict(ref[name]), name
            assert mine[name].describe() == ref[name].describe(), name


@pytest.mark.parametrize("name", [k for k in VARIANTS if k != "default"])
def test_variant_is_bitwise_the_default(name, default):
    """Prefetch, no-reshard, keep-last, the dtype variants and the ring
    gathers: the same loss and grad-norm bits and the same final masters
    as the default schedule."""
    assert_same(default, train(VARIANTS[name]), name)


@pytest.mark.parametrize("name", [k for k in VARIANTS
                                  if VARIANTS[k].gather_mode == "xla"])
def test_ring_twin_is_bitwise_the_default(name, default):
    ring = dataclasses.replace(VARIANTS[name], gather_mode="ring")
    assert_same(default, train(ring), f"ring:{name}")


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_overlap_all_at_small_depths(n):
    """``LayerPlan``'s fallbacks: n = 1 runs keep-last alone with an empty
    main loop, n = 2 leaves one main layer (no pair), n = 3 pairs without
    a tail, n = 5 pairs with a tail; each bitwise the default at its
    depth."""
    assert_same(train(n_layers=n), train(VARIANTS["overlap_all"],
                                         n_layers=n), f"overlap_all n={n}")


def test_group_overrides_are_bitwise_the_default(default):
    """An unsharded ``globals`` (no gather; its gradient all-reduced) and
    fp32-reduce ring layers: a comm-path change only."""
    got = train(group_schedules={
        "globals": {"sharded": False},
        "layers": {"reduce_dtype": "fp32", "gather_mode": "ring"}})
    assert got[2].layouts["globals"].grad_sync_axes == ("data",)
    assert got[2].layouts["globals"].fsdp_axes == ()
    assert_same(default, got, "group_overrides")


def test_fsdp2_planner(default):
    """The fsdp2 layout: ``ring_overlap`` bitwise its own default; that
    default ALLCLOSE to the ragged one (measured: equal streams on this
    config at one rank, where both layouts are contiguous; asserted rtol
    1e-6)."""
    f2 = train(planner="fsdp2")
    assert f2[2].layouts["layers"].plan.mode == "fsdp2"
    assert_same(f2, train(VARIANTS["ring_overlap"], planner="fsdp2"),
                "fsdp2:ring_overlap")
    np.testing.assert_allclose(np.asarray(f2[0]), np.asarray(default[0]),
                               rtol=1e-6)


@pytest.mark.parametrize("planner", ["megatron", "naive"])
def test_baseline_planners_train(planner, default):
    """The megatron and naive layouts train; on one rank they place every
    tensor where the ragged planner does, so the streams agree (asserted
    rtol 1e-6)."""
    got = train(planner=planner, steps=2)
    assert got[2].layouts["layers"].plan.mode == planner
    np.testing.assert_allclose(np.asarray(got[0]),
                               np.asarray(default[0][:2]), rtol=1e-6)


def test_bf16_compute_variants_are_bitwise():
    """bf16 compute (bf16 gather wire, bf16 or fp32 reduce): every
    ``VARIANTS`` entry bitwise the default over two steps."""
    ref = train(dtype=torch.bfloat16, steps=2)
    for name, sched in VARIANTS.items():
        assert_same(ref, train(sched, dtype=torch.bfloat16, steps=2),
                    f"bf16:{name}")


def _ref_runtime(sched, dtype):
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               learning_rate=W.LR)
    return JaxRuntime(jax_build_model(jcfg), make_local_mesh(1, 1),
                      compute_dtype=dtype, schedule=sched, donate=False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_accounting_matches_reference(dtype):
    """``gathered_peak_bytes``, ``gather_wire_bytes`` and
    ``reduce_wire_bytes`` of every named variant equal the reference
    runtime's (one rank), and the plan-level wire bytes at 8 ranks (the
    ring's m/2 order-exact multiplier included)."""
    from repro.core.policy import plan as jax_plan
    from repro_torch.core.policy import plan

    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    cfg = W.quickstart_config()
    group = init_local_group("gloo")
    for name, sched in {**VARIANTS, **APPROX_VARIANTS}.items():
        if name == "q8_serve_matmul":
            continue
        jsched = {**JAX_VARIANTS, **JAX_APPROX}[name]
        rt = FSDPRuntime(build_model(cfg), group, compute_dtype=tdt,
                         device="cpu", schedule=sched)
        jrt = _ref_runtime(jsched, jdt)
        assert rt.gathered_peak_bytes() == jrt.gathered_peak_bytes(), name
        assert rt.gather_wire_bytes() == jrt.gather_wire_bytes(), name
        assert rt.reduce_wire_bytes() == jrt.reduce_wire_bytes(), name
        mesh = {"data": 8, "model": 1}
        p = plan(build_model(cfg), mesh, sched, compute_dtype=tdt)
        jp = jax_plan(jrt.model, mesh, jsched, compute_dtype=jdt)
        assert p.gather_wire_bytes() == jp.gather_wire_bytes(), name
        assert p.reduce_wire_bytes() == jp.reduce_wire_bytes(), name


def test_gathered_meter_reads_the_schedule():
    """The measured peak of live gathered layer buffers: one layer by
    default, two with prefetch (both slots issued before either compute),
    every layer without resharding; keep-last's split-out buffer is live
    only after the main loop's are freed, so it reads one layer where the
    analytic bound counts two.  Never above ``gathered_peak_bytes``, and
    nothing stays live after the step."""
    want = {"default": 1, "prefetch": 2, "no_reshard": 3, "keep_last": 1,
            "overlap_all": 2}
    for name, slots in want.items():
        _, _, rt = train(VARIANTS[name], n_layers=3, meter=True, steps=1)
        lo = rt.layouts["layers"]
        per_layer = lo.plan.total * 4
        meter = rt.gathered_meter
        assert meter.peak == slots * per_layer, name
        assert meter.peak <= rt.gathered_peak_bytes(), name
        assert meter.live == 0, name


@pytest.mark.parametrize("knob,item", [
    (dict(prefetch=True), "Queue 1 item 10"),
    (dict(gather_mode="ring", ring_chunk_elems=1024), "Queue 1 item 10"),
    (dict(reduce_mode="ring_acc", ring_chunk_elems=0), "Queue 1 item 10"),
    (dict(ring_chunk_elems=64), "Queue 1 item 10"),
    (dict(ring_chunk_elems=True, gather_mode="ring"), "Queue 1 item 10"),
], ids=lambda x: str(x))
def test_knobs_construct_or_refuse_like_reference(knob, item):
    """Each knob constructs where the reference's does and raises its
    ``ValueError`` where it does (``ring_chunk_elems`` needs a ring route
    and a positive int); ``item`` names the ROADMAP item that ported it."""
    del item
    try:
        want = JaxSchedule(**knob)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            CommSchedule(**knob)
        assert str(got.value) == str(e)
        return
    assert CommSchedule(**knob).describe() == want.describe()


def test_q8_reduce_wire_needs_a_sharded_group():
    s = schedule.CommSchedule(reduce_wire="q8_block", sharded=False)
    js = JaxSchedule(reduce_wire="q8_block", sharded=False)
    with pytest.raises(ValueError) as want:
        js.validate_for(jnp.bfloat16)
    with pytest.raises(ValueError) as got:
        s.validate_for(torch.bfloat16)
    assert str(got.value) == str(want.value)
