"""HSDP, the pod axis, on 4 gloo ranks: gemma2-2b.reduced(), AdamW, 3
fp32 steps of a 4 x 32 batch on pod 2 x data 2 -- parameters sharded
within a pod and replicated across pods, gradients all-reduced over the
pod axis after the reduce-scatter -- with and without ``pod_fsdp`` (ZeRO-3
over both axes), ``globals`` unsharded on a ``pod_fsdp`` mesh (its
gradient synced over (pod, data) once, never twice), and the q8 reduce
wire on a ``pod_fsdp`` mesh; against the port's flat data 4 and against
the reference on the same mesh (a JAX subprocess with 4 host devices; the
reference's scenarios ``hsdp`` and ``hsdp_groups`` of
tests/test_multidevice.py cut from 8 devices to 4).

Parity classes (bounds with the measured readings beside them):
  * ``pod_fsdp`` against flat data 4: BITWISE (the same 4-rank FSDP group
    in the same order), the q8 reduce wire included;
  * HSDP against flat data 4: ALLCLOSE, fp32 sums in another order (a
    2-rank reduce-scatter then a 2-rank all-reduce): losses within 1e-6,
    grad norms 1e-5 relative, masters 2e-5 relative L2 (measured 1.3e-7,
    9.5e-8, 7.3e-8), ``globals`` unsharded the same;
  * against the reference on the same mesh: losses and grad norms within
    3e-5 relative, masters 2e-5 relative L2 (measured 2.0e-7, 2.3e-6,
    3.0e-6: the one-rank class of tests/test_torch_train.py).
"""
import dataclasses
import os

import numpy as np
import pytest

import _torch_mesh_worker as MW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = "gemma2-2b"
DATA = dict(fsdp_axes=("data",), batch_axes=("data",))
POD_FSDP = {**DATA, "pod_fsdp": True}
Q8R = {"reduce_wire": "q8_block"}
UNSHARDED = {"group_schedules": {"globals": {"sharded": False}}}
# name: (data or [pod, data], model, arch, parallel, fields, schedule)
RUNS = {"flat4": (4, 1, G, DATA, {}, None),
        "flat4_q8": (4, 1, G, DATA, {}, Q8R),
        "flat4_globals": (4, 1, G, DATA, {}, UNSHARDED),
        "hsdp": ([2, 2], 1, G, DATA, {}, None),
        "hsdp_globals": ([2, 2], 1, G, DATA, {}, UNSHARDED),
        "pod_fsdp": ([2, 2], 1, G, POD_FSDP, {}, None),
        "pod_fsdp_globals": ([2, 2], 1, G, POD_FSDP, {}, UNSHARDED),
        "pod_fsdp_q8": ([2, 2], 1, G, POD_FSDP, {}, Q8R)}
REF_RUNS = {k: RUNS[k] for k in ("hsdp", "pod_fsdp", "pod_fsdp_globals")}
# each run and the flat run it is held to; True: bitwise
AGAINST = {"hsdp": ("flat4", False), "hsdp_globals": ("flat4", False),
           "pod_fsdp": ("flat4", True), "pod_fsdp_q8": ("flat4_q8", True),
           "pod_fsdp_globals": ("flat4_globals", True)}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hsdp")
    ref_out = str(tmp / "ref.npz")
    ref = MW.start_reference(os.path.join(ROOT, "src"), ref_out, REF_RUNS)
    outs = MW.join(*MW.spawn(4, tmp, RUNS))
    assert ref.wait(timeout=300) == 0
    data = dict(np.load(ref_out))
    return {"port": MW.runs_of(outs, RUNS), "ranks": outs,
            "ref": {n: {k.split("/", 1)[1]: v for k, v in data.items()
                        if k.startswith(n + "/")} for n in REF_RUNS}}


@pytest.mark.parametrize("name", list(AGAINST))
def test_hsdp_matches_flat_fsdp(name, streams):
    flat, exact = AGAINST[name]
    got, want = streams["port"][name], streams["port"][flat]
    keys = [k for k in want if k != "metrics" and not k.startswith("ef")]
    assert len(keys) > 10
    if exact:
        assert np.array_equal(got["metrics"], want["metrics"])
        for k in keys:
            assert np.array_equal(got[k].view(np.int32),
                                  want[k].view(np.int32)), k
        return
    np.testing.assert_allclose(got["metrics"][:, 0], want["metrics"][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][:, 1], want["metrics"][:, 1],
                               rtol=1e-5)
    for k in keys:
        assert MW.rel_l2(got[k], want[k]) < 2e-5, (k, MW.rel_l2(got[k],
                                                               want[k]))


@pytest.mark.parametrize("name", list(REF_RUNS))
def test_hsdp_matches_reference(name, streams):
    """The reference's streams and final masters on the same (pod 2,
    data 2) mesh."""
    got, ref = streams["port"][name], streams["ref"][name]
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=3e-5)
    keys = [k for k in ref if k != "metrics"]
    assert len(keys) > 10
    for k in keys:
        assert MW.rel_l2(got[k], ref[k]) < 2e-5, k


def test_q8_reduce_wire_on_a_pod_replica_raises():
    """The reference's check (tests/test_wire.py): a q8 reduce wire on a
    group replicated over the pod axis would keep one residual per
    replica -- the reference's ``ValueError``; under ``pod_fsdp`` there is
    no replica axis and the step builds; the auto planner on an HSDP mesh
    never picks the q8 wire."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.core.policy import auto_policies
    from repro_torch.core.schedule import CommSchedule
    from repro_torch.launch.mesh import init_local_group, make_local_mesh
    from repro_torch.optim import make_optimizer

    init_local_group("gloo")
    mesh = make_local_mesh(1, 1, pod=1)
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              parallel=ParallelConfig(("data",), ("data",)))
    rt = FSDPRuntime(build_model(cfg), mesh, device="cpu",
                     schedule=CommSchedule(**Q8R))
    with pytest.raises(ValueError, match=r"replica gradient axes \['pod'\]"):
        rt.make_train_step(make_optimizer(cfg))
    cfg_pf = dataclasses.replace(cfg, parallel=ParallelConfig(
        ("data",), ("data",), pod_fsdp=True))
    rt2 = FSDPRuntime(build_model(cfg_pf), mesh, device="cpu",
                      schedule=CommSchedule(**Q8R))
    rt2.make_train_step(make_optimizer(cfg_pf))
    pset = auto_policies(build_model(cfg), {"pod": 2, "data": 64})
    assert pset.default.reduce_wire is None
    assert all(r.policy.reduce_wire is None for r in pset.rules)


@pytest.mark.parametrize("pod_fsdp", [False, True])
def test_pod_plans_match_reference(pod_fsdp):
    """The plans of a pod mesh ``dumps()`` string-equal to the reference's:
    gemma2-2b.reduced() on {pod 2, data 2, model 1} and gemma2-2b at
    published width (one layer) on the reference's multi-pod production
    mesh {pod 2, data 16, model 16}, on the fp32 and q8_block stores."""
    from repro.configs import build_model as jax_build_model
    from repro.configs import get_config as jax_get_config
    from repro.core import policy as jax_policy
    from repro.core.schedule import CommSchedule as JaxSchedule
    from repro_torch.configs import build_model, get_config
    from repro_torch.core import policy
    from repro_torch.core.schedule import CommSchedule

    def with_pod(cfg):
        return dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, pod_fsdp=pod_fsdp))

    cases = [(lambda g: g(G).reduced(), {"pod": 2, "data": 2, "model": 1}),
             (lambda g: dataclasses.replace(g(G), n_layers=1),
              {"pod": 2, "data": 16, "model": 16})]
    for make, mesh in cases:
        tm = build_model(with_pod(make(get_config)))
        jm = jax_build_model(with_pod(make(jax_get_config)))
        for sched in ({}, {"param_store": "q8_block"}):
            got = policy.plan(tm, mesh, CommSchedule(**sched))
            want = jax_policy.plan(jm, mesh, JaxSchedule(**sched))
            assert got.dumps() == want.dumps(), (mesh, sched)
            fsdp = got.groups["layers"].fsdp_axes
            assert ("pod" in fsdp) == pod_fsdp
