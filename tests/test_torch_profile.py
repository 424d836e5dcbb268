"""Comm profiles, the cost model and ``policies="auto"`` in the port against
the JAX reference: the ``comm-profile/v1`` schema, its fitted curves and
content hash, the builtin roofline profile, every ``CostModel`` price and
choice, and ``plan(..., "auto").dumps()`` for every registered config at
published width; then the port's own parts -- the H100 constants of
``launch.mesh``, ``FSDPRuntime(policies="auto" | plan=...)`` and
``launch.bench_comm`` on a gloo rank.

Parity class: BITWISE throughout -- host metadata and Python float
arithmetic in the reference's order (floats compared with ``==``).
"""
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.mesh as jax_mesh
from repro.configs import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.core import policy as jax_policy
from repro.core import profile as jax_profile

import repro_torch.launch.mesh as mesh
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.core import policy, profile
from repro_torch.core.fsdp import FSDPRuntime
from repro_torch.launch import bench_comm
from repro_torch.launch.mesh import init_local_group

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

# (direction, fmt, mode) -> ns per element: cast wires cheap, q8 dear, a
# bf16 ring cheapest (the economics opposite to the roofline's), an fp8
# gather curve, and latency intercepts on two keys
_NS = {("gather", "fp32", "xla"): 4.0, ("gather", "fp32", "ring"): 4.0,
       ("gather", "bf16", "xla"): 2.0, ("gather", "bf16", "ring"): 0.5,
       ("gather", "q8_block", "xla"): 50.0,
       ("gather", "q8_block", "ring"): 50.0,
       ("gather", "fp8_e4m3", "xla"): 0.3,
       ("reduce", "fp32", "xla"): 4.0, ("reduce", "fp32", "ring"): 4.0,
       ("reduce", "fp32", "ring_acc"): 4.0,
       ("reduce", "bf16", "xla"): 2.0, ("reduce", "bf16", "ring"): 0.5,
       ("reduce", "bf16", "ring_acc"): 0.5,
       ("reduce", "q8_block", "xla"): 100.0,
       ("reduce", "q8_block", "ring"): 100.0,
       ("reduce", "q8_block", "ring_acc"): 1.0}
_LAT_US = {("gather", "bf16", "ring"): 7.0, ("reduce", "fp32", "xla"): 3.0}
# a ring chunk sweep at 1 << 20 elements: 16384-element messages win
_SWEEP = (("gather", "bf16", "ring", 1 << 20, 65536, 0.45),
          ("gather", "bf16", "ring", 1 << 20, 16384, 0.4),
          ("reduce", "q8_block", "ring_acc", 1 << 20, 32768, 0.9))


def _samples(pkg):
    out = []
    for (d, f, m), ns in _NS.items():
        for e in (1 << 16, 1 << 20):
            out.append(pkg.CommSample(d, f, m, e, e,
                                      _LAT_US.get((d, f, m), 0.0)
                                      + e * ns * 1e-3))
    out += [pkg.CommSample(d, f, m, e, c, e * ns * 1e-3)
            for d, f, m, e, c, ns in _SWEEP]
    return tuple(out)


def _profile(pkg, world=8, name="measured-test"):
    return pkg.CommProfile(name=name, entries=_samples(pkg), backend="cpu",
                           world=world, builtin=False, end_to_end=True,
                           quick=True)


def _ref_constants(monkeypatch):
    """The port's launch.mesh constants set to the reference's."""
    for k in ("ICI_BW", "HBM_BW", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(mesh, k, getattr(jax_mesh, k))


def _tp1(cfg):
    """The config at tp = ep = 1 (the port builds no model axis yet; both
    packages plan the same config)."""
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, tp=1, ep=1, sequence_parallel=False))


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        _MODELS[arch] = (jax_build_model(_tp1(jax_get_config(arch))),
                         build_model(_tp1(get_config(arch))))
    return _MODELS[arch]


# --------------------------------------------------------------------------- #
# the profile
# --------------------------------------------------------------------------- #

def test_profile_round_trip_hash_and_fits_match_reference(tmp_path):
    """Same samples: the same canonical JSON and content hash, the same
    fitted (latency, slope) per key and the same best ring chunks; save,
    load and from_json round-trip."""
    ours, ref = _profile(profile), _profile(jax_profile)
    assert ours.dumps() == ref.dumps()
    assert ours.content_hash() == ref.content_hash()
    for key in sorted({s.key() for s in ref.entries}):
        assert ours.linear(*key) == ref.linear(*key), key
        assert ours.time_s(*key, 12345) == ref.time_s(*key, 12345), key
        assert ours.has(*key) and ref.has(*key)
    for d in ("gather", "reduce"):
        for f in ("fp32", "bf16", "q8_block"):
            assert ours.best_ring_chunk(d, f) == ref.best_ring_chunk(d, f)
    assert ours.best_ring_chunk("gather", "bf16") == 16384
    path = tmp_path / "p.json"
    ours.save(path)
    back = profile.load_profile(path)
    assert back == ours and back.content_hash() == ours.content_hash()
    assert json.loads(path.read_text()) == json.loads(ref.dumps())
    with pytest.raises(KeyError, match="no profile entries"):
        ours.linear("gather", "fp8_e5m2", "xla")


@pytest.mark.parametrize("bad, msg", [
    (lambda d: d.update(schema="comm-profile/v0"), "schema"),
    (lambda d: d.pop("entries"), "missing key 'entries'"),
    (lambda d: d["entries"][0].update(direction="sideways"), "direction"),
    (lambda d: d["entries"][0].update(mode="ring_acc"), "reduce-only"),
    (lambda d: d["entries"][0].update(chunk_elems=0), "chunk_elems"),
    (lambda d: d["entries"][0].update(time_us=-1.0), "negative time_us"),
    (lambda d: d["entries"][0].pop("fmt"), "missing"),
    (lambda d: d.update(world=0), "world"),
])
def test_profile_schema_errors_match_reference(bad, msg):
    """A malformed profile raises the reference's ValueError text."""
    errs = []
    for pkg in (profile, jax_profile):
        data = json.loads(_profile(pkg).dumps())
        bad(data)
        with pytest.raises(ValueError, match=msg) as e:
            pkg.CommProfile.from_json(data)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_profile_validator_cli(tmp_path, capsys):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    _profile(profile).save(good)
    bad.write_text('{"schema": "nope"}')
    assert profile.main([str(good)]) == 0
    out = capsys.readouterr().out
    assert f"hash={_profile(profile).content_hash()}" in out
    assert profile.main([str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out


def test_builtin_profile_matches_reference(monkeypatch):
    """At the reference's constants the builtin roofline profile is the
    reference's, fp8 wires included; at the port's own it renders the
    H100's NVLink rate."""
    ref = jax_profile.builtin_profile()
    assert profile.builtin_profile(jax_mesh.ICI_BW).dumps() == ref.dumps()
    _ref_constants(monkeypatch)
    assert profile.builtin_profile().content_hash() == ref.content_hash()
    monkeypatch.undo()
    h100 = profile.builtin_profile()
    lat, slope = h100.linear("gather", "fp32", "xla")
    assert lat == pytest.approx(profile.BUILTIN_LATENCY_S)
    assert 4.0 / slope == pytest.approx(450e9)


def test_h100_constants_and_no_tpu_constant_in_the_port():
    """``launch.mesh`` carries the H100 datasheet figures; the TPU v5e's
    (197e12, 819e9, 50e9) appear nowhere in the port's source."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    cm = policy.CostModel.default()
    assert (cm.ici_bw, cm.hbm_bw, cm.peak_flops) == (450e9, 3.35e12, 989e12)
    tpu = re.compile(r"\b(197e12|819e9|50e9)\b")
    for f in (REPO / "src" / "repro_torch").rglob("*.py"):
        assert not tpu.search(f.read_text()), f


# --------------------------------------------------------------------------- #
# the cost model
# --------------------------------------------------------------------------- #

def _cost_models(kind):
    if kind == "builtin":
        c = dict(ici_bw=jax_mesh.ICI_BW, hbm_bw=jax_mesh.HBM_BW,
                 peak_flops=jax_mesh.PEAK_FLOPS_BF16)
        return policy.CostModel(**c), jax_policy.CostModel(**c)
    if kind == "measured_partial":   # not end to end: HBM terms added
        mk = lambda pkg: dataclasses.replace(_profile(pkg), end_to_end=False)
    else:
        mk = _profile
    return (policy.CostModel.from_profile(mk(profile)),
            jax_policy.CostModel.from_profile(mk(jax_profile)))


@pytest.mark.parametrize("kind", ["builtin", "measured", "measured_partial"])
def test_cost_model_prices_and_choices_match_reference(kind, monkeypatch):
    """Every price and choice over a grid of elements, layers, m, quant
    block, itemsize, reshard and mode equals the reference's (float
    ``==``)."""
    _ref_constants(monkeypatch)
    ours, ref = _cost_models(kind)
    assert (ours.ici_bw, ours.measured) == (ref.ici_bw, ref.measured)
    assert ours.provenance_profile().dumps() == \
        ref.provenance_profile().dumps()
    n = 0
    for elems in (4096, 1 << 20, 77_865_984):
        for layers in (1, 26):
            for m in (1, 2, 8, 64):
                for qb in (64, 1024):
                    for isz in (2, 4):
                        args = (elems, layers, m, qb, isz)
                        for reshard in (True, False):
                            assert ours.choose_gather(*args, reshard) == \
                                ref.choose_gather(*args, reshard)
                            for mode in ("xla", "ring"):
                                assert ours.choose_store(
                                    *args, reshard, mode) == ref.choose_store(
                                    *args, reshard, mode)
                                for fmt in ("fp32", "bf16", "q8_block",
                                            "fp8_e4m3", "fp8_e5m2"):
                                    assert ours.gather_time(
                                        fmt, *args, reshard, mode) == \
                                        ref.gather_time(fmt, *args, reshard,
                                                        mode)
                                    n += 1
                        assert ours.choose_reduce_wire(*args) == \
                            ref.choose_reduce_wire(*args)
                        for fmt in (None, "q8_block"):
                            for mode in (None, "xla", "ring", "ring_acc"):
                                assert ours.reduce_time(fmt, *args, mode) == \
                                    ref.reduce_time(fmt, *args, mode)
                                n += 1
        for d in ("gather", "reduce"):
            for f in ("bf16", "q8_block"):
                assert ours.choose_ring_chunk(d, f, elems) == \
                    ref.choose_ring_chunk(d, f, elems)
    assert n > 2000


@pytest.mark.parametrize("data", [1, 8])
@pytest.mark.parametrize("kind", ["builtin", "measured"])
def test_auto_plan_dumps_match_reference(kind, data, monkeypatch):
    """``plan(model, {"data": d}, "auto")`` of every registered config at
    published width is string-equal to the reference's: under the builtin
    roofline with the port's constants set to the reference's, and under a
    measured profile (world 8, a ring chunk sweep and an fp8 curve)."""
    _ref_constants(monkeypatch)
    for arch in ARCH_IDS:
        jm, tm = _models(arch)
        kw_t, kw_j = {}, {}
        if kind == "measured":
            kw_t["cost_model"], kw_j["cost_model"] = _cost_models(kind)
        want = jax_policy.make_plan(jm, {"data": data}, "auto", **kw_j)
        got = policy.plan(tm, {"data": data}, "auto", **kw_t)
        assert got.dumps() == want.dumps(), arch
        assert got.describe() == want.describe(), arch
        assert got.pricing and got.profile_hash


def test_auto_plan_decisions_and_provenance():
    """The port's own constants: at 8 ranks the measured profile's fp8
    gather curve (more than 2% below the bf16 ring) moves the layer stack
    to the fp8_e4m3 store, and its cheap q8 ring_acc curve to the q8
    gradient wire with the sweep's 32768-element chunk; the plan records
    the profile's hash, shows both prices and round-trips through JSON;
    one rank keeps fp32 everywhere."""
    _, tm = _models("qwen2.5-14b")
    small = build_model(_tp1(get_config("qwen2.5-14b")).reduced())
    cm = policy.CostModel.from_profile(_profile(profile))
    p = policy.plan(small, {"data": 8}, "auto", cost_model=cm)
    pol = p.groups["layers"].policy
    assert (pol.store, pol.gather_mode, pol.reduce_wire, pol.reduce_mode,
            pol.ring_chunk_elems) == ("fp8_e4m3", "xla", "q8_block",
                                      "ring_acc", 32768)
    assert p.profile_hash == _profile(profile).content_hash()
    d = p.describe()
    assert "auto_ms" in d and "builtin_ms" in d and "chunk=32768" in d
    assert f"profile=measured-test@{p.profile_hash}" in d
    back = policy.ShardingPlan.from_json(json.loads(p.dumps()))
    assert back.dumps() == p.dumps()
    assert back.policy_set().default == p.base
    b = policy.plan(small, {"data": 1}, "auto")
    assert b.profile_name == profile.BUILTIN_NAME
    assert all(e.policy.store == "fp32" and e.policy.sharded
               and e.policy.reduce_wire is None for e in b.groups.values())
    h100 = policy.plan(tm, {"data": 64}, "auto")
    assert h100.pricing["layers"]["auto_ms"] == \
        h100.pricing["layers"]["builtin_ms"]


def test_runtime_takes_auto_and_plan():
    """``FSDPRuntime(policies="auto")`` resolves the auto plan for its
    group; ``plan=`` replays a plan and refuses a foreign mesh, compute
    dtype or a mix with ``policies=``."""
    group = init_local_group("gloo")
    cfg = _tp1(get_config("gemma2-2b")).reduced()
    rt = FSDPRuntime(build_model(cfg), group, device="cpu",
                     compute_dtype=torch.float32, policies="auto")
    want = policy.plan(build_model(cfg), {"data": 1, "model": 1}, "auto",
                       compute_dtype=torch.float32)
    assert rt.plan.dumps() == want.dumps()
    rt2 = FSDPRuntime(build_model(cfg), group, device="cpu",
                      compute_dtype=torch.float32, plan=rt.plan)
    assert rt2.plan is rt.plan and rt2.planner_mode == "ragged"
    with pytest.raises(ValueError, match="mesh axes"):
        FSDPRuntime(build_model(cfg), group, device="cpu",
                    compute_dtype=torch.float32,
                    plan=policy.plan(build_model(cfg), {"data": 2},
                                     compute_dtype=torch.float32))
    with pytest.raises(ValueError, match="compute dtype"):
        FSDPRuntime(build_model(cfg), group, device="cpu", plan=rt.plan)
    with pytest.raises(ValueError, match="not both"):
        FSDPRuntime(build_model(cfg), group, device="cpu",
                    compute_dtype=torch.float32, plan=rt.plan,
                    policies="auto")


def test_bench_comm_on_a_gloo_rank(tmp_path):
    """The port's comm sweep on one gloo rank writes a valid profile that a
    cost model reads: every (direction, format, mode) key at both sizes."""
    out = tmp_path / "prof.json"
    prof = bench_comm.run(init_local_group("gloo"), "cpu", quick=True,
                          out=str(out), sizes=(1 << 12, 1 << 14),
                          verbose=False)
    back = profile.load_profile(out)
    assert back == prof and back.world == 1 and back.backend == "cpu"
    keys = {s.key() for s in back.entries}
    assert len(keys) == 3 * (2 + 3) and len(back.entries) == 2 * len(keys)
    cm = policy.CostModel.from_profile(str(out))
    assert cm.measured and cm.provenance_profile() == back
    assert profile.main([str(out)]) == 0
